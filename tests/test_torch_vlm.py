"""The port's VLM backbone (qwen2-vl-2b, reduced: 12 / 2 heads become 4 / 2
of 16, QKV bias, M-RoPE) on the CPU against the JAX package, with the JAX
init's weights and the stub vision frontend's precomputed embeddings.

* ``mrope_tables`` with three distinct position streams against JAX's
  ``apply_mrope`` to 1e-6 (fp32 inputs; the same fp32 roundings but for
  ``rotate``'s fused form), and equal to ``rope_tables`` bit for bit when
  the streams coincide, as they do at serve time;
* ``ModelRunner._to_batch``: fp32, bool and int32 fields round-trip bit
  for bit, one upload per dtype;
* packed and padded ``serve_step`` on steps whose chunks carry image
  positions, against JAX's, with the dense serve-step tolerances
  (``test_torch_serve_step``); the splice changes the logits;
* engines with ``MMItem``s in packed (depths 1 and 4, bitwise equal),
  padded and serial mode against the JAX engine in the same mode
  (``assert_greedy_equiv``), and ``encoder_runs`` equal to JAX's (a
  shared image counted once).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_greedy_equiv, get_model, make_engine  # noqa: E402
from repro.models.rotary import apply_mrope  # noqa: E402
from repro.serving import MMItem as JMMItem  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import DecoderLM, build_model, params_from_numpy  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.models.rotary import (mrope_tables, rope_tables,  # noqa: E402
                                       rotate)
from repro_torch.serving import (Engine, EngineConfig, MMItem,  # noqa: E402
                                 Request, SamplingParams)

from test_torch_engine import DEPTHS, assert_drained_clean  # noqa: E402
from test_torch_moe import check_step  # noqa: E402
from test_torch_serve_step import to_batch  # noqa: E402

ARCH = "qwen2-vl-2b"
_PORT = {}


def port_model():
    if not _PORT:
        _, _, jparams = get_model(ARCH)
        cfg = reduced(ARCHS[ARCH])
        _PORT["m"] = (DecoderLM(cfg), params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return _PORT["m"]


def port_engine(**kw):
    model, params = port_model()
    cfg = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8)
    cfg.update(kw)
    return Engine(model, EngineConfig(**cfg), params=params, device="cpu")


# -------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (128, 1e6),
                                            (64, 1e4)])
def test_mrope_tables_match_jax_apply_mrope(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 9, 3, head_dim)).astype(np.float32)
    pos3 = rng.integers(0, 5000, (3, 2, 9)).astype(np.int32)
    assert (pos3[0] != pos3[1]).any() and (pos3[1] != pos3[2]).any()
    ref = np.asarray(apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta))
    ours = rotate(torch.from_numpy(x),
                  *mrope_tables(torch.from_numpy(pos3), head_dim, theta))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-6)
    # each stream rotates its own section: another t stream moves the
    # result
    other = pos3.copy()
    other[0] += 1
    moved = rotate(torch.from_numpy(x),
                   *mrope_tables(torch.from_numpy(other), head_dim, theta))
    assert not torch.equal(moved, ours)
    # one stream broadcast to all three is RoPE, bit for bit
    same = torch.from_numpy(np.broadcast_to(pos3[:1], pos3.shape).copy())
    for a, b in zip(mrope_tables(same, head_dim, theta),
                    rope_tables(torch.from_numpy(pos3[0]), head_dim, theta)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ upload
def test_to_batch_round_trips_every_dtype(monkeypatch):
    eng = port_engine()
    runner = eng.runner
    uploads = []
    upload = runner._upload
    monkeypatch.setattr(runner, "_upload",
                        lambda a: uploads.append(a.dtype) or upload(a))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((1, 6, 64)).astype(np.float32)
    emb[0, 0, :4] = [-0.0, np.inf, np.nan, 1e-42]
    arrs = dict(tokens=rng.integers(0, 99, (1, 6)).astype(np.int32),
                positions=np.arange(6, dtype=np.int32)[None],
                seq_lens=np.array([6], np.int32),
                tables={"full_attn": np.arange(8, dtype=np.int32).reshape(
                    1, 1, 1, 8)},
                page_pos={"full_attn": np.zeros((1, 1, 1, 8), np.int32)},
                write_eids={}, state_eids={}, mm_embeds=emb,
                mm_mask=np.array([[0, 1, 1, 0, 1, 0]], bool),
                mrope_pos=rng.integers(0, 9, (3, 1, 6)).astype(np.int32),
                last_idx=None)
    batch = runner._to_batch(arrs)
    assert sorted(map(str, uploads)) == ["bool", "float32", "int32"]
    for f, v in arrs.items():
        got = getattr(batch, f)
        if v is None:
            assert got is None
            continue
        pairs = (v.items() if isinstance(v, dict) else [(None, v)])
        for k, x in pairs:
            t = got if k is None else got[k]
            assert t.dtype == {np.dtype(np.float32): torch.float32,
                               np.dtype(bool): torch.bool,
                               np.dtype(np.int32): torch.int32}[x.dtype]
            assert t.shape == x.shape
            assert t.numpy().tobytes() == x.tobytes(), f


# ---------------------------------------------------------- serve step
PROMPTS = [[(5 * i + 3 * j) % 97 for j in range(n)]
           for i, n in enumerate((13, 6, 45))]
ITEMS = [(MMItem(2, 6, mm_hash=42),), (), (MMItem(20, 17, mm_hash=7),)]


def _jitems(items):
    return tuple(JMMItem(it.start, it.length, mm_hash=it.mm_hash)
                 for it in items)


@pytest.mark.parametrize("mode", ["packed", "padded"])
def test_serve_step_with_image_embeds_matches_jax(mode):
    """A mixed step whose chunks carry image positions: logits and K/V as
    JAX's; without the embeddings the logits move."""
    eng, _ = make_engine(ARCH, batching_mode=mode, max_num_batched_tokens=24)
    for i, ids in enumerate(PROMPTS):
        eng.submit(JRequest(rid=f"r{i}", prompt=ids, mm_items=_jitems(
            ITEMS[i]), sampling=JSamplingParams(max_new_tokens=8)))
    eng.step()
    plan = eng.scheduler.schedule()
    prep = eng.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled],
                              packed=mode == "packed")
    assert prep.arrs["mm_mask"].any() and prep.arrs["mrope_pos"] is not None
    eng.runner.zero_pages(eng.mgr.drain_fresh_pages())
    buf0 = np.array(eng.runner.buffer).reshape(-1)
    jlogits = eng.runner.fetch(eng.runner.dispatch(eng.params, prep),
                               prep.n)
    jbuf = np.asarray(eng.runner.buffer).reshape(-1)
    model, params = port_model()
    logits = check_step(model, params, prep, buf0, jlogits, jbuf)
    bare = to_batch(dict(prep.arrs, mm_embeds=None, mm_mask=None))
    plain = model.serve_step(params, tensor_from_numpy(buf0.copy()), bare,
                             prefill=prep.info["prefill"])[:prep.n]
    assert (plain - logits).abs().max() > 1e-3


# -------------------------------------------------------------- engines
REQS = [dict(rid=f"r{i}", prompt=[(7 * i + j) % 50 for j in range(14 + 5 * i)],
             items=items)
        for i, items in enumerate([(MMItem(2, 6, mm_hash=42),), (),
                                   (MMItem(1, 6, mm_hash=42),),
                                   (MMItem(4, 9, mm_hash=9),)])]


def _drain(eng, request_cls, sampling_cls, wrap=lambda x: x):
    for r in REQS:
        eng.submit(request_cls(rid=r["rid"], prompt=r["prompt"],
                               mm_items=wrap(r["items"]),
                               sampling=sampling_cls(max_new_tokens=6)))
    eng.run_until_done()
    return {r.rid: list(r.output) for r in eng.finished}


@pytest.mark.parametrize("mode", ["packed", "padded", "serial"])
def test_engines_with_images_match_jax(mode, monkeypatch):
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    jeng, _ = make_engine(ARCH, batching_mode=mode,
                          record_sample_logits=True)
    _drain(jeng, JRequest, JSamplingParams, _jitems)
    assert jeng.encoder_runs == 2             # image 42 shared by r0, r2
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
            assert_greedy_equiv(jeng, eng, label=f"vlm/{mode}")
    assert len(set(map(str, outs.values()))) == 1, outs
    # without its image a prompt decodes differently
    eng = port_engine(batching_mode=mode)
    bare = _drain(eng, Request, SamplingParams, wrap=lambda x: ())
    assert eng.encoder_runs == 0
    assert bare != outs[1]


def test_build_model_and_params():
    cfg = reduced(ARCHS[ARCH])
    model = build_model(cfg)
    assert isinstance(model, DecoderLM) and not model.is_moe
    _, bridged = port_model()
    own = model.init(seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    a, b = flat(own)[0], flat(bridged)[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, k
    assert own["layers"]["q_bias"].dtype == torch.float32
    # multimodal training: the three inputs go together
    tok = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    with pytest.raises(ValueError):
        model.train_loss(own, tok, tok, mm_embeds=torch.zeros(1))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    loss = model.train_loss(
        model.init(seed=0, device="cpu", master=True), tok, tok,
        mm_embeds=torch.full((2, 8, cfg.d_model), 0.05),
        mm_mask=torch.arange(8).expand(2, 8) < 2,
        mrope_pos=torch.stack([pos] * 3))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
