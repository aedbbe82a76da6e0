"""The port's RWKV6 family (``RWKVLM``, reduced rwkv6-3b: 4 layers, d 64,
head size 16) against JAX ``RWKVLM``, on the CPU, with the JAX init's
weights (the weight bridge). RWKV6 has no TPU kernel: both packages run
the chunked recurrence in plain array code. Tolerances:

* blocks (``rwkv6_chunked`` / ``rwkv6_packed`` / ``rwkv6_step``, one
  layer, non-zero entry states, ragged rows, killed and empty segments):
  outputs within 2 bf16 ulps of their largest |value| over real tokens;
  the fp32 wkv state within 1e-5 of its largest |value| (fp32 sums in
  another order); the shift states within 1 bf16 ulp of their largest
  |value| (XLA may keep bf16 intermediates in fp32 inside a fusion,
  torch rounds each op);
* serve steps: logits within 5e-3 (measured at most 3.8e-3 over 4 layers,
  the roundings above compounded); decoded state pages of layer 0 as
  for the blocks, deeper layers' wkv state within 2e-2 of its largest
  |value| (the state integrates inputs that already differ by roundings;
  measured at most 1.0e-2) and shifts within 2 bf16 ulps; every other
  byte but the scratch page unchanged;
* engines: fork-aware equal to JAX's (``assert_greedy_equiv``), the
  port's depths bitwise equal, the pool drained clean under PageSan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_greedy_equiv, get_model, make_engine  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks_seq as JBS  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.spec import lcm  # noqa: E402
from repro_torch.models import (RWKVLM, blocks_seq as BS,  # noqa: E402
                                build_model, params_from_numpy)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.lm import unstack  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, Request,  # noqa: E402
                                 SamplingParams)

from test_torch_engine import (DEPTHS, assert_drained_clean, drain,  # noqa: E402
                               workload)
from test_torch_mamba import jrun, packed_stream  # noqa: E402
from test_torch_serve_step import bf16_ulp, to_batch  # noqa: E402

ARCH = "rwkv6-3b"
_PORT = {}


def port_model():
    """(RWKVLM, params) of the port, sharing the JAX init's weights."""
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


# --------------------------------------------------------------- blocks
def _layer(idx):
    """(JAX layer params with tp squeezed, port layer params, rd, cfg)."""
    model, _, jparams = get_model(ARCH)
    cfg = reduced(ARCHS[ARCH])
    jp = jax.tree.map(lambda a: a[idx],
                      model._squeeze_params(jparams)["layers"])
    pp = unstack(port_model()[1]["layers"])[idx]
    return jp, pp, model.rd, cfg


def _kw(cfg):
    return dict(head_size=cfg.rwkv_head_size, norm_eps=cfg.norm_eps)


def _states(rng, n, rd, d):
    """Finite fp32 entry states whose shift parts are bf16-representable
    (they are stored from bf16 activations)."""
    wkv = 0.3 * rng.standard_normal((n, rd["wkv_units"]))
    shift = np.asarray(jnp.asarray(rng.standard_normal((n, 2 * d)),
                                   jnp.bfloat16).astype(jnp.float32))
    return np.concatenate([wkv, shift], axis=1).astype(np.float32)


def _x(rng, shape):
    return np.asarray(jnp.asarray(0.5 * rng.standard_normal(shape),
                                  jnp.bfloat16))


def _close_out(ours, ref, rows):
    a = ours.float().numpy()[rows]
    b = np.asarray(ref, np.float32)[rows]
    tol = 2 * 2.0 ** -8 * np.abs(b).max()
    assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


def _close_state(ours, ref, rd, wkv_tol=1e-5, ulps=1):
    a, b = ours.numpy(), np.asarray(ref)
    n = rd["wkv_units"]
    assert np.isfinite(a).all()
    assert np.abs(a[:, :n] - b[:, :n]).max() <= \
        wkv_tol * np.abs(b[:, :n]).max()
    assert np.abs(a[:, n:] - b[:, n:]).max() <= \
        ulps * bf16_ulp(np.abs(b[:, n:]).max())


@pytest.mark.parametrize("t_", [5, 150])
def test_rwkv6_chunked_matches_jax(t_):
    """Padded rows: non-zero entry states, ragged ``last_idx``, a one-token
    row; T = 150 spans three 64-token chunks."""
    jp, pp, rd, cfg = _layer(1)
    rng = np.random.default_rng(t_)
    b = 4
    x = _x(rng, (b, t_, cfg.d_model))
    st = _states(rng, b, rd, cfg.d_model)
    last = np.array([t_ - 1, t_ // 2, 0, max(0, t_ - 3)], np.int32)
    lmask = np.arange(t_)[None] <= last[:, None]
    out, state = jrun(
        lambda p, x, s, m, li, dist: JBS.rwkv6_chunked(
            p, x, dist, rd, init_state=s, length_mask=m, last_idx=li,
            **_kw(cfg)),
        jp, jnp.asarray(x), jnp.asarray(st), jnp.asarray(lmask),
        jnp.asarray(last))
    ours, ostate = BS.rwkv6_chunked(
        pp, t(x), rd, init_state=t(st), length_mask=t(lmask),
        last_idx=t(last), **_kw(cfg))
    _close_out(ours, out, lmask)
    _close_state(ostate, state, rd)


@pytest.mark.parametrize("segs,tt", [
    ((30, 20, 1, -9, 12, 0, 1, 7), 96),      # straddles 64, killed, pad
    ((1, 1, -1, 1, 1, 0, 0, 0), 8),          # decode-only step
    ((40, 23), 64),                          # one full chunk, no pad
])
def test_rwkv6_packed_matches_jax(segs, tt):
    """A packed stream with non-zero entry states; a segment with no token
    (pad, killed) passes its state through unchanged."""
    jp, pp, rd, cfg = _layer(2)
    rng = np.random.default_rng(len(segs) + tt)
    seg_ids, seg_start, seg_last = packed_stream(tt, segs)
    x = _x(rng, (1, tt, cfg.d_model))
    st = _states(rng, len(segs), rd, cfg.d_model)
    out, state = jrun(
        lambda p, x, si, ss, sl, s, dist: JBS.rwkv6_packed(
            p, x, dist, rd, seg_ids=si, seg_start=ss, seg_last=sl,
            init_state=s, **_kw(cfg)),
        jp, jnp.asarray(x), *(jnp.asarray(a) for a in (
            seg_ids, seg_start, seg_last, st)))
    ours, ostate = BS.rwkv6_packed(
        pp, t(x), rd, init_state=t(st), seg_ids=t(seg_ids),
        seg_start=t(seg_start), seg_last=t(seg_last), **_kw(cfg))
    _close_out(ours[0], np.asarray(out)[0], seg_ids >= 0)
    live = [si for si, n in enumerate(segs) if n > 0]
    _close_state(ostate[live], np.asarray(state)[live], rd)
    n = rd["wkv_units"]
    for si, ln in enumerate(segs):
        if ln <= 0:
            assert torch.equal(ostate[si, :n], t(st[si, :n]))


def test_rwkv6_step_matches_jax():
    jp, pp, rd, cfg = _layer(3)
    rng = np.random.default_rng(9)
    x = _x(rng, (3, 1, cfg.d_model))
    st = _states(rng, 3, rd, cfg.d_model)
    out, state = jrun(
        lambda p, x, s, dist: JBS.rwkv6_step(p, x, s, dist, rd, **_kw(cfg)),
        jp, jnp.asarray(x), jnp.asarray(st))
    ours, ostate = BS.rwkv6_step(pp, t(x), t(st), rd, **_kw(cfg))
    _close_out(ours, out, slice(None))
    _close_state(ostate, state, rd)


def test_packed_pads_after_long_decay_stay_finite():
    """Segments of 6 and 52 tokens, then 6 pads, in one 64-token chunk:
    the reference's state update takes exp(segend - L) at the pads with
    segment 0's segend; past 88 nats of decay since (52 tokens at ~1.8
    each) that overflows, and the pads' k of 0 times inf makes every
    state NaN (ROADMAP queue 3). The port clamps that exponent at 0,
    which changes no real token's factor: each segment's state equals
    JAX's padded route (``rwkv6_chunked``) over that segment alone."""
    jp, pp, rd, cfg = _layer(0)
    rng = np.random.default_rng(17)
    seg_ids, seg_start, seg_last = packed_stream(64, (6, 52))
    x = _x(rng, (1, 64, cfg.d_model))
    st = _states(rng, 2, rd, cfg.d_model)
    _, jstate = jrun(
        lambda p, x, si, ss, sl, s, dist: JBS.rwkv6_packed(
            p, x, dist, rd, seg_ids=si, seg_start=ss, seg_last=sl,
            init_state=s, **_kw(cfg)),
        jp, jnp.asarray(x), *(jnp.asarray(a) for a in (
            seg_ids, seg_start, seg_last, st)))
    n = rd["wkv_units"]
    assert np.isnan(np.asarray(jstate)[:, :n]).any(axis=1).all()
    _, ostate = BS.rwkv6_packed(
        pp, t(x), rd, init_state=t(st), seg_ids=t(seg_ids),
        seg_start=t(seg_start), seg_last=t(seg_last), **_kw(cfg))
    for si, (a, b) in enumerate(((0, 6), (6, 58))):
        _, ref = jrun(
            lambda p, x, s, dist: JBS.rwkv6_chunked(
                p, x, dist, rd, init_state=s, **_kw(cfg)),
            jp, jnp.asarray(x[:, a:b]), jnp.asarray(st[si:si + 1]))
        _close_state(ostate[si:si + 1], ref, rd)


# ---------------------------------------------------------------- state
def test_state_page_written_by_jax_reads_back_bit_for_bit():
    """After a JAX serve step, every live state page of every layer reads
    back through the port's ``read_state`` with JAX's bits."""
    _, prep, _, _, jbuf = _jax_step("packed", 2)
    model, _ = port_model()
    buf = t(jbuf)
    view = model._layer_views(buf)["rwkv"]
    eids = prep.arrs["state_eids"]["rwkv"].reshape(-1)
    assert (eids >= 0).any()
    for layer in range(view[1]):
        ours = A.read_state(buf.view(view), layer, t(eids))
        ref = np.asarray(JA.read_state(jnp.asarray(jbuf).reshape(view),
                                       layer, jnp.asarray(eids)))
        assert np.array_equal(ours.view(torch.int32).numpy(),
                              ref.view(np.int32))


# ------------------------------------------------------------ serve step
PROMPTS = [[(5 * i + 3 * j) % 97 for j in range(n)]
           for i, n in enumerate((13, 6, 45))]


def _jax_step(mode, steps, **kw):
    """A JAX engine advanced ``steps`` steps; returns the next plan, its
    PreparedStep (fresh pages zeroed), the buffer before and after JAX's
    dispatch of it, and JAX's logits."""
    eng, _ = make_engine(ARCH, batching_mode=mode,
                         max_num_batched_tokens=24, **kw)
    for i, ids in enumerate(PROMPTS):
        eng.submit(JRequest(rid=f"r{i}", prompt=ids,
                            sampling=JSamplingParams(max_new_tokens=8)))
    for _ in range(steps):
        eng.step()
    plan = eng.scheduler.schedule()
    prep = eng.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled],
                              packed=mode == "packed")
    eng.runner.zero_pages(eng.mgr.drain_fresh_pages())
    for name, eid in prep.info["fresh_state"]:
        eng.runner.zero_page(name, eid)
    buf0 = np.array(eng.runner.buffer).reshape(-1)
    jlogits = eng.runner.fetch(eng.runner.dispatch(eng.params, prep),
                               prep.n)
    return plan, prep, buf0, jlogits, np.asarray(eng.runner.buffer).reshape(-1)


@pytest.mark.parametrize("mode,steps,prefill,decode_only", [
    ("packed", 2, True, False),     # prefill chunks and decodes
    ("packed", 6, True, True),      # decode-only packed step
    ("padded", 1, True, False),     # T > 1 rows: rwkv6_chunked
    ("padded", 3, False, True),     # T == 1: rwkv6_step
])
def test_serve_step_matches_jax(mode, steps, prefill, decode_only):
    plan, prep, buf0, jlogits, jbuf = _jax_step(mode, steps)
    assert prep.info["prefill"] == prefill
    assert bool(plan.prefills) != decode_only
    model, params = port_model()
    buf = t(buf0.copy())
    logits = model.serve_step(params, buf, to_batch(prep.arrs),
                              prefill=prep.info["prefill"])[:prep.n]
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    assert np.abs(logits.numpy() - jlogits).max() < 5e-3

    view = model._layer_views(buf)["rwkv"]
    eids = [int(e) for e in prep.arrs["state_eids"]["rwkv"].reshape(-1)
            if e >= 0]
    assert eids
    total = buf.shape[0]
    page = view[1] * view[2]
    touched = np.zeros(total, bool)
    for e in eids:
        touched[e * page:(e + 1) * page] = True
    big = lcm([s.page_units for s in model.kv_specs()])
    touched[total - big:] = True                        # the scratch page
    assert np.array_equal(buf.view(torch.int16).numpy()[~touched],
                          buf0.view(np.int16)[~touched])
    jv = t(jbuf).view(view)
    for layer in range(view[1]):
        ours = A.bf16_pair_to_f32(buf.view(view)[eids, layer])
        ref = A.bf16_pair_to_f32(jv[eids, layer]).numpy()
        if layer == 0:
            _close_state(ours, ref, model.rd)
        else:
            _close_state(ours, ref, model.rd, wkv_tol=2e-2, ulps=2)


# ---------------------------------------------------------------- engine
def _count_copies(eng):
    kinds = []
    orig = eng.runner.apply_copies

    def apply_copies(ops):
        kinds.extend(op.kind for op in ops if op.type_name == "rwkv")
        return orig(ops)

    eng.runner.apply_copies = apply_copies
    return kinds


def test_packed_engine_matches_jax_depths_bitwise_under_pagesan(monkeypatch):
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    reqs = workload(n=4)
    jeng, _ = make_engine(ARCH, record_sample_logits=True)
    drain(jeng, reqs, JRequest, JSamplingParams)
    outs = {}
    for depth, kw in DEPTHS[::2]:
        eng = port_engine(record_sample_logits=True, **kw)
        assert eng.mgr.sanitizer is not None
        outs[depth] = drain(eng, reqs, Request, SamplingParams)
        assert_drained_clean(eng)
        eng.mgr.sanitizer.assert_drained()
        if depth == 1:
            assert_greedy_equiv(jeng, eng, label="rwkv/packed")
    assert outs[1] == outs[4], outs


@pytest.mark.parametrize("mode", ["padded", "serial"])
def test_padded_and_serial_engines_match_jax(mode):
    reqs = workload()
    jeng, _ = make_engine(ARCH, batching_mode=mode,
                          record_sample_logits=True)
    drain(jeng, reqs, JRequest, JSamplingParams)
    depths = DEPTHS[::2] if mode == "padded" else DEPTHS[:1]
    outs = {}
    for depth, kw in depths:
        eng = port_engine(batching_mode=mode, record_sample_logits=True,
                          **kw)
        outs[depth] = drain(eng, reqs, Request, SamplingParams)
        assert_drained_clean(eng)
        if depth == 1:
            assert_greedy_equiv(jeng, eng, label=f"rwkv/{mode}")
    assert len(set(map(str, outs.values()))) == 1, outs


def test_state_checkpoints_and_prefix_hit_restore_match_jax(monkeypatch):
    """Prompts past the 512-token checkpoint interval: checkpoint copies of
    state pages (deferred and caught up at depth 4), then a request sharing
    a 520-token prefix with a finished one hits the cache at 512 and
    restores the checkpoint. Fork-aware equal to JAX, depths bitwise,
    drained clean under PageSan."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    base = [(3 * j + 1) % 97 for j in range(520)]
    first = [dict(rid="a", prompt=base + [5, 6], max_new_tokens=4,
                  eos_token=None),
             dict(rid="b", prompt=[(j * 7) % 89 for j in range(530)],
                  max_new_tokens=4, eos_token=None)]
    second = [dict(rid="c", prompt=base + [9, 9, 9], max_new_tokens=4,
                   eos_token=None)]
    kw = dict(chunk_size=64, max_num_batched_tokens=96,
              kv_pool_bytes=32 << 20, record_sample_logits=True)
    jeng, _ = make_engine(ARCH, **kw)
    drain(jeng, first, JRequest, JSamplingParams)
    drain(jeng, second, JRequest, JSamplingParams)
    outs = {}
    for depth, dkw in DEPTHS[::2]:
        eng = port_engine(**kw, **dkw)
        kinds = _count_copies(eng)
        o = drain(eng, first, Request, SamplingParams)
        o.update(drain(eng, second, Request, SamplingParams))
        outs[depth] = o
        assert kinds.count("checkpoint") >= 2 and "restore" in kinds, kinds
        if depth == 4:
            assert eng.mgr.catchup_checkpoints >= 1
        assert_drained_clean(eng)
        eng.mgr.sanitizer.assert_drained()
        if depth == 1:
            assert_greedy_equiv(jeng, eng, label="rwkv/checkpoints")
    assert outs[1] == outs[4], outs


@pytest.mark.parametrize("depth", [1, 4])
def test_small_pool_matches_jax(depth):
    """The preemption scenario of ``test_torch_preempt.py`` on a pool of
    two state pages: RWKV requests never grow after admission, so both
    engines run two requests at a time, preempt equally often (never)
    and finish alike."""
    reqs = [dict(rid=f"r{i}", prompt=[(3 * i + j) % 97
                                      for j in range(24 + 8 * i)],
                 max_new_tokens=12, eos_token=None) for i in range(4)]
    kw = dict(dict(DEPTHS)[depth], kv_pool_bytes=40_000,
              record_sample_logits=True)
    jeng, _ = make_engine(ARCH, **kw)
    drain(jeng, reqs, JRequest, JSamplingParams)
    eng = port_engine(**kw)
    drain(eng, reqs, Request, SamplingParams)
    assert eng.mgr.geometry.num_large_pages == 2
    assert eng.scheduler.preemption_count == \
        jeng.scheduler.preemption_count
    assert max(m.decode_batch for m in eng.metrics) == 2
    assert_greedy_equiv(jeng, eng, label=f"rwkv/small pool depth {depth}")
    assert_drained_clean(eng)


def test_long_prompts_packed_stay_finite_where_the_reference_fails():
    """Four prompts of 1,100+ tokens in 64-token chunks: the reference's
    packed engine meets a chunk whose pads follow more than 88 nats of
    decay and fails on NaN logits (``test_packed_pads_after_long_decay_
    stay_finite``); the port's packed engine finishes, fork-aware equal
    to the reference's padded engine on the same requests."""
    reqs = [dict(rid=f"r{i}", prompt=[(3 * i + j) % 97
                                      for j in range(1100 + 8 * i)],
                 max_new_tokens=12, eos_token=None) for i in range(4)]
    kw = dict(chunk_size=64, max_num_batched_tokens=128,
              record_sample_logits=True)
    jeng, _ = make_engine(ARCH, **kw)
    with pytest.raises(IndexError):             # greedy pick of NaN rows
        drain(jeng, reqs, JRequest, JSamplingParams)
    jeng, _ = make_engine(ARCH, batching_mode="padded", **kw)
    drain(jeng, reqs, JRequest, JSamplingParams)
    eng = port_engine(**kw)
    drain(eng, reqs, Request, SamplingParams)
    assert_drained_clean(eng)
    assert_greedy_equiv(jeng, eng, label="rwkv/long packed vs padded")


# ---------------------------------------------------------------- model
def test_build_model_and_init():
    cfg = reduced(ARCHS[ARCH])
    model = build_model(cfg)
    assert isinstance(model, RWKVLM)
    _, bridged = port_model()
    own = model.init(seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    a, b = flat(own)[0], flat(bridged)[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, k
    assert bridged["layers"]["w_lora_b"].dtype == torch.float32
    assert bridged["layers"]["w_r"].dtype == torch.bfloat16
    assert torch.equal(own["layers"]["w_base"],
                       torch.full_like(own["layers"]["w_base"], 0.6))
    tok = torch.zeros((1, 8), dtype=torch.int32)     # training is ported
    loss = model.train_loss(own, tok, tok)
    assert loss.shape == () and bool(torch.isfinite(loss))
