"""The port's enc-dec family (``EncDecLM``, reduced whisper-tiny: 2 encoder
+ 2 decoder layers, d 64, 4 heads of 16, ``encoder_seq`` 16) against JAX
``EncDecLM``, on the CPU, with the JAX init's weights (the weight bridge)
and the stub audio frontend's frame embeddings. JAX's packed steps run its
``attention_impl="kernel"`` route (the Pallas varlen kernel in interpret
mode), as the port's packed steps take the varlen kernel's plain version;
its padded steps the reference route. Tolerances:

* ``sinusoidal_positions`` within 2e-4 absolute (fp32 sin/cos of angles up
  to 1500 rad, whose own rounding is 1.2e-4); ``layer_norm`` and the tanh
  GELU within 1 bf16 ulp of each value (fp32 in, one rounding out; the
  GELU's tails near 0 within 1e-5);
* ``_encode`` within 2 bf16 ulps of the output's largest |value|: the
  port's encoder runs the dense flash forward (plain version here: fp32
  scores and probabilities), JAX's jnp flash rounds q * scale and the
  probabilities to bf16;
* serve steps: logits within 2.2e-3 (the dense family's measured bar),
  but 3e-3 on the padded T == 1 step (measured 2.3e-3: the paged decode
  kernel's plain version keeps the probabilities fp32, JAX's
  ``attend_tokens`` rounds them to bf16); written self pages of layer 0 bit
  for bit, every written self and cross page within 1 bf16 ulp of the
  pages' largest value (cross pages come from an encoder output computed
  in another order); every other byte but the scratch page unchanged;
  packed cross attention exactly 0 for tokens with no encoder;
* engines: fork-aware equal to JAX's (``assert_greedy_equiv``), the
  port's depths bitwise equal, the pool drained clean under PageSan and
  ``encoder_runs`` equal to JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_greedy_equiv, get_model, make_engine  # noqa: E402
from repro.models.common import layer_norm as jlayer_norm  # noqa: E402
from repro.models.rotary import (  # noqa: E402
    sinusoidal_positions as jsinusoidal)
from repro.serving import MMItem as JMMItem  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, flash_attention_varlen_plain)
from repro_torch.kernels.flash_attention import dense as dense_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as varlen_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_plain)
from repro_torch.kernels.paged_attention import kernel as paged_kernel  # noqa: E402
from repro_torch.models import (EncDecLM, blocks_attn, build_model,  # noqa: E402
                                encdec, params_from_numpy)
from repro_torch.models.attention import view_offset  # noqa: E402
from repro_torch.models.common import layer_norm  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.models.rotary import sinusoidal_positions  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, MMItem,  # noqa: E402
                                 Request, SamplingParams)

from test_torch_engine import DEPTHS, assert_drained_clean  # noqa: E402
from test_torch_mamba import jrun  # noqa: E402
from test_torch_serve_step import bf16_ulp, to_batch, written_units  # noqa: E402

ARCH = "whisper-tiny"
_PORT = {}


def port_model():
    """(EncDecLM, params) of the port, sharing the JAX init's weights."""
    if not _PORT:
        _, _, jparams = get_model(ARCH)
        cfg = reduced(ARCHS[ARCH])
        _PORT["m"] = (build_model(cfg), params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return _PORT["m"]


def port_engine(**cfg_kw):
    model, params = port_model()
    kw = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8)
    kw.update(cfg_kw)
    return Engine(model, EngineConfig(**kw), params=params, device="cpu")


def t(a):
    return tensor_from_numpy(np.asarray(a))


def _within_ulp(a, b, atol=0.0):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bound = np.maximum(np.maximum(bf16_ulp(a), bf16_ulp(b)), atol)
    assert (np.abs(a - b) <= bound).all(), np.abs(a - b).max()


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("seq,d", [(16, 64), (1500, 384)])
def test_sinusoidal_positions_match_jax(seq, d):
    ours = sinusoidal_positions(seq, d).numpy()
    ref = np.asarray(jsinusoidal(seq, d))
    assert ours.shape == ref.shape == (seq, d)
    assert np.abs(ours - ref).max() <= 2e-4


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((5, 7, 64)) * 3 + 1, jnp.bfloat16)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = jlayer_norm(x, jnp.asarray(w), jnp.asarray(b), 1e-5)
    ours = layer_norm(t(x), t(w), t(b), 1e-5)
    assert ours.dtype == torch.bfloat16
    _within_ulp(ours.float(), np.asarray(ref, np.float32))
    h = rng.standard_normal((9, 128)).astype(np.float32) * 4
    ref = jax.nn.gelu(jnp.asarray(h)).astype(jnp.bfloat16)
    ours = torch.nn.functional.gelu(t(h), approximate="tanh").to(
        torch.bfloat16)
    _within_ulp(ours.float(), np.asarray(ref, np.float32), atol=1e-5)
    exact = torch.nn.functional.gelu(t(h)).to(torch.bfloat16)
    assert not torch.equal(exact, ours)     # the erf form is another GELU


def test_encode_matches_jax():
    """The encoder over two rows of stub frames, one of them zeros (a row
    with no audio still runs: the reference attends every frame)."""
    jmodel, cfg, jparams = get_model(ARCH)
    model, params = port_model()
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    enc[1] = 0
    ref = jrun(lambda p, e, dist: jmodel._encode(
        jmodel._squeeze_params(p), e, cfg.norm_eps), jparams,
        jnp.asarray(enc))
    calls = dense_kernel.dense_flash_fwd.launches
    ours = model._encode(params, t(enc))
    assert dense_kernel.dense_flash_fwd.launches == calls      # CPU: plain
    ref = np.asarray(ref, np.float32)
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    err = np.abs(ours.float().numpy() - ref).max()
    assert err <= 2 * bf16_ulp(np.abs(ref).max()), err


# ------------------------------------------------------------ serve step
PROMPTS = [[(5 * i + 3 * j) % 97 for j in range(n)]
           for i, n in enumerate((13, 6, 45))]
ITEMS = [(MMItem(0, 16, mm_hash=7),), (), (MMItem(0, 16, mm_hash=9),)]


def _jitems(items):
    return tuple(JMMItem(it.start, it.length, mm_hash=it.mm_hash)
                 for it in items)


def _jax_step(mode, steps, **kw):
    """A JAX engine advanced ``steps`` steps (r1 carries no audio); returns
    the next plan, its PreparedStep, the buffer before and after JAX's
    dispatch of it, and JAX's logits."""
    eng, _ = make_engine(ARCH, batching_mode=mode, max_num_batched_tokens=24,
                         attention_impl="kernel" if mode == "packed"
                         else "ref", **kw)
    for i, ids in enumerate(PROMPTS):
        eng.submit(JRequest(rid=f"r{i}", prompt=ids,
                            encoder_items=_jitems(ITEMS[i]),
                            sampling=JSamplingParams(max_new_tokens=8)))
    for _ in range(steps):
        eng.step()
    plan = eng.scheduler.schedule()
    prep = eng.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled],
                              packed=mode == "packed")
    eng.runner.zero_pages(eng.mgr.drain_fresh_pages())
    buf0 = np.array(eng.runner.buffer).reshape(-1)
    jlogits = eng.runner.fetch(eng.runner.dispatch(eng.params, prep),
                               prep.n)
    return plan, prep, buf0, jlogits, np.asarray(eng.runner.buffer).reshape(-1)


def _cross_units(prep, view, total):
    """Mask of the cross pages' units the step's encoder writes cover."""
    mask = np.zeros(total, bool)
    ew = prep.arrs["enc_write_eids"]
    if ew is None:
        return mask
    _, nl, _, tpp, kvl, d = view
    for row in ew.reshape(-1, ew.shape[-1]):
        for j, eid in enumerate(row):
            if eid < 0:
                continue
            for layer in range(nl):
                for sel in (0, 1):
                    off = int(view_offset(view, int(eid), layer, sel,
                                          j % tpp))
                    mask[off:off + kvl * d] = True
    return mask


@pytest.mark.parametrize("mode,steps,prefill,enc", [
    ("packed", 0, True, True),      # first chunks: encoder, text-only r1
    ("packed", 2, True, False),     # prefill chunks and decodes
    ("padded", 0, True, True),      # first chunks: encoder, padded cross
    ("padded", 6, False, False),    # T == 1: the paged decode kernel
])
def test_serve_step_matches_jax(mode, steps, prefill, enc, monkeypatch):
    plan, prep, buf0, jlogits, jbuf = _jax_step(mode, steps)
    assert prep.info["prefill"] == prefill
    assert (prep.arrs["enc_embeds"] is not None) == enc
    model, params = port_model()
    outs = []
    cross = blocks_attn.packed_cross_attention

    def spy(q, k, v, meta):
        outs.append(cross(q, k, v, meta))
        return outs[-1]

    monkeypatch.setattr(blocks_attn, "packed_cross_attention", spy)
    buf = t(buf0.copy())
    logits = model.serve_step(params, buf, to_batch(prep.arrs),
                              prefill=prep.info["prefill"])[:prep.n]
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    bar = 3e-3 if not prefill else 2.2e-3
    assert np.abs(logits.numpy() - jlogits).max() < bar

    views = model._layer_views(buf)
    sv, cv = views["full_attn"], views["cross_attn"]
    ours, ref = buf.float().numpy(), jbuf.astype(np.float32)
    total = ours.shape[0]
    w = written_units(prep, sv, total, range(sv[1]))
    c = _cross_units(prep, cv, total)
    assert w.any() and c.any() == enc
    scratch = total - sv[1] * int(np.prod(sv[2:]))
    untouched = ~(w | c)
    untouched[scratch:] = False
    assert np.array_equal(buf.view(torch.int16).numpy()[untouched],
                          buf0.view(np.int16)[untouched])
    w0 = written_units(prep, sv, total, [0])
    assert np.array_equal(buf.view(torch.int16).numpy()[w0],
                          jbuf.view(np.int16)[w0])
    for m in (w, c):
        if m.any():
            assert np.abs(ours[m] - ref[m]).max() <= \
                bf16_ulp(np.abs(ref[m]).max())
    if mode == "packed":
        assert len(outs) == model.cfg.num_layers
        no_enc = torch.tensor(prep.arrs["enc_lens"][0] == 0)
        assert no_enc.any()             # r1 and the pads
        for out in outs:
            assert (out[0][no_enc] == 0).all()
            assert (out[0][~no_enc] != 0).any()


# ---------------------------------------------------------------- engine
REQS = [dict(rid=f"r{i}", prompt=[(7 * i + j) % 50 for j in range(8 + 5 * i)],
             items=items)
        for i, items in enumerate([(MMItem(0, 16, mm_hash=42),), (),
                                   (MMItem(0, 16, mm_hash=42),),
                                   (MMItem(0, 12, mm_hash=9),), ()])]


def _drain(eng, request_cls, sampling_cls, wrap=lambda x: x, max_new=6):
    for r in REQS:
        eng.submit(request_cls(rid=r["rid"], prompt=r["prompt"],
                               encoder_items=wrap(r["items"]),
                               sampling=sampling_cls(max_new_tokens=max_new)))
    eng.run_until_done()
    return {r.rid: list(r.output) for r in eng.finished}


@pytest.mark.parametrize("mode", ["packed", "padded", "serial"])
def test_engines_match_jax(mode, monkeypatch):
    """Audio requests (two share one clip, one clip shorter than
    ``encoder_seq``) beside text-only ones, at depths 1 and 4 (packed,
    padded) with PageSan on."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    jeng, _ = make_engine(ARCH, batching_mode=mode,
                          attention_impl="kernel" if mode == "packed"
                          else "ref", record_sample_logits=True)
    _drain(jeng, JRequest, JSamplingParams, _jitems)
    assert jeng.encoder_runs == 2
    depths = DEPTHS[::2] if mode != "serial" else DEPTHS[:1]
    outs = {}
    for depth, kw in depths:
        eng = port_engine(batching_mode=mode, record_sample_logits=True,
                          **kw)
        outs[depth] = _drain(eng, Request, SamplingParams)
        assert eng.encoder_runs == jeng.encoder_runs
        assert_drained_clean(eng)
        eng.mgr.sanitizer.assert_drained()
        if depth == 1:
            assert_greedy_equiv(jeng, eng, label=f"whisper/{mode}")
    assert len(set(map(str, outs.values()))) == 1, outs


@pytest.mark.parametrize("mode,depth", [("packed", 1), ("packed", 4),
                                        ("padded", 1), ("serial", 1)])
def test_whisper_path_feeds_the_kernels_valid_inputs(monkeypatch, mode,
                                                     depth):
    """Every kernel call of the served enc-dec model passes its CUDA
    wrapper's input checks: per packed dispatch the varlen kernel twice a
    decoder layer (self and cross), per dispatch that runs the encoder
    the dense forward once an encoder layer, per padded T == 1 dispatch
    the paged kernel once a decoder layer."""
    calls = dict(varlen=0, paged=0, dense=0)

    def varlen(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, window=0,
               blk_q=128, blk_k=128, kv_tiles=None):
        assert kv_tiles is not None
        varlen_kernel.check_inputs(q, k, v, q_seg, kv_seg, q_pos, kv_pos,
                                   blk_q, blk_k, kv_tiles)
        calls["varlen"] += 1
        return flash_attention_varlen_plain(q, k, v, q_seg, kv_seg, q_pos,
                                            kv_pos, window=window)

    def paged(q, kv_view, tables, page_pos, positions, *, window=0,
              plan=None):
        assert plan is not None
        paged_kernel.check_inputs(q, kv_view, tables, page_pos, positions,
                                  window=window, plan=plan)
        calls["paged"] += 1
        return paged_decode_attention_plain(q, kv_view, tables, page_pos,
                                            positions, window=window,
                                            plan=plan)

    def dense(q, k, v, *, causal=True, window=0):
        assert not causal and q.shape[1] == 16 and k.shape[1] == 512
        dense_kernel.check_inputs(q, k, v, window=window)
        calls["dense"] += 1
        return flash_attention_plain(q, k, v, causal=False), None

    monkeypatch.setattr(blocks_attn, "flash_attention_varlen", varlen)
    monkeypatch.setattr(blocks_attn, "paged_decode_attention", paged)
    monkeypatch.setattr(encdec, "dense_flash_fwd", dense)
    eng = port_engine(batching_mode=mode, **dict(DEPTHS)[depth])
    seen = dict(decode=0, enc=0)
    orig = eng.runner.dispatch

    def dispatch(params, prep):
        seen["decode"] += not prep.info["prefill"]
        seen["enc"] += prep.arrs["enc_embeds"] is not None
        return orig(params, prep)

    eng.runner.dispatch = dispatch
    _drain(eng, Request, SamplingParams)
    cfg = eng.model.cfg
    n = eng.runner.dispatch_count
    assert seen["enc"] > 0
    want = dict(dense=seen["enc"] * cfg.encoder_layers,
                varlen=2 * n * cfg.num_layers if mode == "packed" else 0,
                paged=seen["decode"] * cfg.num_layers)
    assert calls == want, (calls, want, seen)
    assert (seen["decode"] > 0) == (mode != "packed")


@pytest.mark.parametrize("depth,pool,max_steps", [
    (1, 50_000, 2000), (4, 70_000, 2000), (4, 50_000, 200)])
def test_preemption_matches_jax(depth, pool, max_steps):
    """Pools where both engines preempt (cross pages are taken at
    admission, self pages grow): the same preemption count, the same
    requests finished, outputs fork-aware equal, the pool drained clean.
    At depth 4 on 50 kB the reference preempts without end (ROADMAP queue
    3): after 200 steps both engines have preempted equally often and
    finished the same requests."""
    reqs = [dict(rid=f"r{i}", prompt=[(3 * i + j) % 97
                                      for j in range(24 + 8 * i)],
                 items=(MMItem(0, 16, mm_hash=7 + i),)) for i in range(4)]
    kw = dict(dict(DEPTHS)[depth], kv_pool_bytes=pool,
              record_sample_logits=True)

    def run(eng, request_cls, sampling_cls, wrap):
        for r in reqs:
            eng.submit(request_cls(
                rid=r["rid"], prompt=r["prompt"],
                encoder_items=wrap(r["items"]),
                sampling=sampling_cls(max_new_tokens=12)))
        eng.run_until_done(max_steps=max_steps)

    jeng, _ = make_engine(ARCH, **kw)
    run(jeng, JRequest, JSamplingParams, _jitems)
    eng = port_engine(**kw)
    run(eng, Request, SamplingParams, lambda x: x)
    assert jeng.scheduler.preemption_count > 0
    assert eng.scheduler.preemption_count == jeng.scheduler.preemption_count
    assert {r.rid for r in eng.finished} == {r.rid for r in jeng.finished}
    assert_greedy_equiv(jeng, eng, label=f"whisper/preempt depth {depth}")
    if max_steps == 200:
        assert eng.step_count == jeng.step_count == 200
        assert len(eng.finished) < 4
    else:
        assert len(eng.finished) == 4
        assert_drained_clean(eng)


# ---------------------------------------------------------------- model
def test_build_model_and_init():
    cfg = reduced(ARCHS[ARCH])
    model = build_model(cfg)
    assert isinstance(model, EncDecLM)
    _, bridged = port_model()
    own = model.init(seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    a, b = flat(own)[0], flat(bridged)[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, k
    assert bridged["dec_pos"].dtype == torch.bfloat16
    assert bridged["dec_cross"]["v_bias"].dtype == torch.float32
    assert [s.name for s in model.kv_specs()] == ["full_attn", "cross_attn"]
    tok = torch.zeros((1, 8), dtype=torch.int32)     # training is ported
    with pytest.raises(ValueError):                  # and needs frames
        model.train_loss(own, tok, tok)
    loss = model.train_loss(own, tok, tok, enc_embeds=torch.zeros(
        (1, cfg.encoder_seq, cfg.d_model)))
    assert loss.shape == () and bool(torch.isfinite(loss))
