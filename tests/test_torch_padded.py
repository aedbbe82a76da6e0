"""The port's padded and serial batching against JAX's, on the CPU.

* ``flash_attention_partials`` and ``prefill_flash`` (the T > 1 padded
  attention, plain torch) against the JAX functions on the same inputs:
  m and l within 2e-5 (fp32 sums in another order); acc within 2 bf16 ulps
  of the largest |V| (both sides round p to bf16 before the PV product, and
  a p near a rounding boundary may round the other way);
* the padded ``serve_step`` against JAX ``serve_step`` on a T == 1 step
  (the port reads pages in place through the paged decode kernel's plain
  version, JAX gathers them) and on T > 1 mixed steps, with the packed
  step's tolerances (``test_torch_serve_step``): logits 2e-2, written K/V
  within 1 bf16 ulp, every other byte equal except the scratch page;
* the port's padded (depths 1, 2, 4) and serial engines against JAX's
  engines in the same modes, fork-aware (``assert_greedy_equiv``), the
  padded depths bitwise equal to each other, the pool drained clean;
* every paged-kernel call of the padded engine passes the CUDA wrapper's
  input checks with the step's plan, once per layer of every T == 1
  dispatch, and the plan is built once per attention type of such a step;
* EOS inside the depth-4 ring in padded mode with PageSan on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_greedy_equiv, make_engine  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks_attn as JBA  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.paged_attention.kernel import check_inputs  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks_attn  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.serving import Request, SamplingParams  # noqa: E402

from test_torch_engine import (DEPTHS, assert_drained_clean, drain,  # noqa: E402
                               port_engine, workload)
from test_torch_serve_step import (ARCHS3, bf16_ulp, port_model,  # noqa: E402
                                   to_batch, written_units)

SENTINEL = 1 << 29


def t(a):
    return tensor_from_numpy(np.asarray(a))


def _qkv(seed, b, t_, s, kvl=2, g=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t_, kvl, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvl, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvl, d)).astype(np.float32)
    return [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]


def _close_partials(ours, ref, v):
    """(acc, m, l) against JAX's on every row that sees a slot. A row that
    sees none keeps m = -1e30 in both, and its l counts whatever masked
    slots the reference padded its blocks with."""
    acc, m, l = (x.numpy() for x in ours)
    racc, rm, rl = (np.asarray(x) for x in ref)
    live = rm > -1e29
    assert np.array_equal(m > -1e29, live)
    for a, b in ((m, rm), (l, rl)):
        np.testing.assert_allclose(a[live], b[live], atol=2e-5, rtol=2e-5)
    tol = 2 * 2.0 ** -8 * float(np.abs(np.asarray(v, np.float32)).max())
    assert np.abs(acc[live] - racc[live]).max() <= tol


@pytest.mark.parametrize("kw", [dict(), dict(window=24), dict(block=64),
                                dict(window=100, block=128)])
def test_flash_attention_partials_matches_jax(kw):
    """T = 300 > 256: the fresh part of a long padded chunk."""
    q, k, v = _qkv(0, 2, 300, 300)
    ref = JA.flash_attention_partials(q, k, v, causal=True, **kw)
    ours = A.flash_attention_partials(t(q), t(k), t(v), **kw)
    _close_partials(ours, ref, v)


@pytest.mark.parametrize("window", [0, 5])
def test_prefill_flash_matches_jax(window):
    """Old pages of padded rows: slot_pos < chunk_start and the window,
    in blocks (one of them partial), SENTINEL slots and pad rows included."""
    b, t_, tpp, p = 3, 8, 4, 10
    q, k, v = _qkv(1, b, t_, p * tpp)
    rng = np.random.default_rng(2)
    page_pos = np.full((b, p), SENTINEL, np.int32)
    positions = np.full((b, t_), SENTINEL, np.int32)
    for bi, (start, nt) in enumerate(((12, 8), (30, 3))):
        npg = (start + nt - 1) // tpp + 1
        page_pos[bi, :npg] = np.arange(npg) * tpp
        positions[bi, :nt] = np.arange(start, start + nt)
    rng.shuffle(page_pos[1, :4])
    slot_pos = (page_pos[:, :, None] + np.arange(tpp)).reshape(b, -1)
    ref = JBA._prefill_flash(q, k, v, jnp.asarray(slot_pos),
                             jnp.asarray(positions), window=window,
                             chunk_start=jnp.asarray(positions[:, :1]),
                             block=16)
    meta = blocks_attn.padded_prefill_meta(t(slot_pos), t(positions),
                                           window=window, block=16)
    assert len(meta["blocks"]) == 3 and meta["fresh"] is not None
    ours = blocks_attn.prefill_flash(t(q), t(k), t(v), meta["blocks"])
    _close_partials(ours, ref, v)


# ------------------------------------------------------------ serve step
def _jax_step(arch, prompts, steps, **kw):
    """A JAX padded engine advanced ``steps`` steps; returns it with the
    next plan's PreparedStep (fresh pages zeroed) and the buffer before
    and after JAX's dispatch of it."""
    eng, _ = make_engine(arch, batching_mode="padded", **kw)
    for i, ids in enumerate(prompts):
        eng.submit(JRequest(rid=f"r{i}", prompt=ids,
                            sampling=JSamplingParams(max_new_tokens=8)))
    for _ in range(steps):
        eng.step()
    plan = eng.scheduler.schedule()
    prep = eng.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled], packed=False)
    eng.runner.zero_pages(eng.mgr.drain_fresh_pages())
    buf0 = np.array(eng.runner.buffer).reshape(-1)
    jlogits = eng.runner.fetch(eng.runner.dispatch(eng.params, prep),
                               prep.n)
    return plan, prep, buf0, jlogits, np.asarray(eng.runner.buffer).reshape(-1)


def _check_step(arch, plan, prep, buf0, jlogits, jbuf):
    model, params = port_model(arch)
    buf = tensor_from_numpy(buf0.copy())
    logits = model.serve_step(params, buf, to_batch(prep.arrs),
                              prefill=prep.info["prefill"])[:prep.n]
    assert logits.dtype == torch.float32
    assert logits.shape == jlogits.shape
    diff = np.abs(logits.numpy() - jlogits)
    assert diff.max() < 2e-2, diff.max()

    ours = buf.float().numpy()
    ref = jbuf.astype(np.float32)
    view = model._layer_views(buf)["full_attn"]
    scratch = ours.shape[0] - view[1] * int(np.prod(view[2:]))
    w = written_units(prep, view, ours.shape[0], range(view[1]))
    assert w.any()
    untouched = ~w
    untouched[scratch:] = False
    assert np.array_equal(buf.view(torch.int16).numpy()[untouched],
                          buf0.view(np.int16)[untouched])
    assert np.array_equal(jbuf.view(np.int16)[untouched],
                          buf0.view(np.int16)[untouched])
    w0 = written_units(prep, view, ours.shape[0], [0])
    a, b = ours[w0], ref[w0]
    assert (np.abs(a - b) <= np.maximum(bf16_ulp(a), bf16_ulp(b))).all()
    a, b = ours[w], ref[w]
    assert np.abs(a - b).max() <= bf16_ulp(np.abs(b).max()), \
        (np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS3)
def test_padded_decode_step_matches_jax(arch):
    """T == 1: every row decodes over its old pages (3 live rows in a
    bucket of 4: one pad row)."""
    prompts = [[(5 * i + 3 * j) % 97 for j in range(n)]
               for i, n in enumerate((13, 6, 21))]
    plan, prep, *rest = _jax_step(arch, prompts, steps=5)
    assert not prep.info["prefill"] and len(plan.decodes) == 3
    assert prep.arrs["tokens"].shape == (4, 1)
    before = paged_decode_attention.launches
    _check_step(arch, plan, prep, *rest)
    assert paged_decode_attention.launches == before     # CPU: plain


@pytest.mark.parametrize("arch", ARCHS3)
def test_padded_mixed_step_matches_jax(arch):
    """T > 1: prefill chunks and decodes in one padded step, old pages on
    every row."""
    prompts = [[(5 * i + 3 * j) % 97 for j in range(n)]
               for i, n in enumerate((13, 6, 45))]
    plan, prep, *rest = _jax_step(arch, prompts, steps=2,
                                  max_num_batched_tokens=24)
    assert prep.info["prefill"] and plan.decodes and plan.prefills
    _check_step(arch, plan, prep, *rest)


def test_padded_long_chunk_step_matches_jax():
    """A 300-token first chunk (T = 512 > 256): the fresh part goes
    through ``flash_attention_partials``."""
    prompts = [[(7 * j) % 97 for j in range(300)], list(range(5))]
    plan, prep, *rest = _jax_step("granite-3-2b", prompts, steps=0,
                                  chunk_size=512,
                                  max_num_batched_tokens=512)
    assert prep.arrs["tokens"].shape == (2, 512)
    _check_step("granite-3-2b", plan, prep, *rest)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("arch", ARCHS3)
def test_padded_and_serial_engines_match_jax(arch):
    reqs = workload()
    ref = {}
    for mode in ("padded", "serial"):
        jeng, _ = make_engine(arch, batching_mode=mode,
                              record_sample_logits=True)
        drain(jeng, reqs, JRequest, JSamplingParams)
        ref[mode] = jeng
    outs = {}
    for depth, kw in DEPTHS:
        eng = port_engine(arch, batching_mode="padded",
                          record_sample_logits=True, **kw)
        outs[depth] = drain(eng, reqs, Request, SamplingParams)
        assert_drained_clean(eng)
        if depth == 1:
            assert_greedy_equiv(ref["padded"], eng, label=f"{arch}/padded")
    assert outs[1] == outs[2] == outs[4], outs
    eng = port_engine(arch, batching_mode="serial",
                      record_sample_logits=True)
    drain(eng, reqs, Request, SamplingParams)
    assert_drained_clean(eng)
    assert_greedy_equiv(ref["serial"], eng, label=f"{arch}/serial")
    assert max(m.num_prefills for m in eng.metrics) <= 1


def _count_decode_dispatches(eng):
    """Wrap the runner's dispatch to count T == 1 (paged-kernel) steps and
    to check that killed rows write and read nowhere."""
    counts = dict(decode=0, killed=0)
    orig = eng.runner.dispatch

    def dispatch(params, prep):
        if not prep.info["prefill"]:
            counts["decode"] += 1
        for si in prep.dead:
            counts["killed"] += 1
            for f in ("write_eids", "tables"):
                for arr in prep.arrs[f].values():
                    assert (arr[0, 0, si] == -1).all(), (f, si)
            assert (prep.arrs["positions"][si] == SENTINEL).all()
        return orig(params, prep)

    eng.runner.dispatch = dispatch
    return counts


@pytest.mark.parametrize("mode,depth", [("padded", 1), ("padded", 2),
                                        ("padded", 4), ("serial", 1)])
def test_padded_path_feeds_the_kernel_valid_inputs(monkeypatch, mode, depth):
    """Every paged-kernel call of the padded and serial engines passes the
    CUDA wrapper's input checks (dtype, shape, contiguity, alignment of
    the strided layer view), once per layer of every T == 1 dispatch."""
    calls, pool = [], []

    def spy(q, kv_view, tables, page_pos, positions, *, window=0,
            plan=None):
        assert plan is not None            # the step's shared plan
        check_inputs(q, kv_view, tables, page_pos, positions, window=window,
                     plan=plan)
        # a view of the engine's own buffer, read where it lies
        assert kv_view.untyped_storage().data_ptr() == pool[0]
        calls.append(q.shape)
        return paged_decode_attention_plain(q, kv_view, tables, page_pos,
                                            positions, window=window,
                                            plan=plan)

    monkeypatch.setattr(blocks_attn, "paged_decode_attention", spy)
    kw = dict(DEPTHS)[depth]
    eng = port_engine(batching_mode=mode, max_num_batched_tokens=24, **kw)
    pool.append(eng.runner.buffer.untyped_storage().data_ptr())
    counts = _count_decode_dispatches(eng)
    drain(eng, workload(n=4), Request, SamplingParams)
    assert counts["decode"] > 0
    assert len(calls) == counts["decode"] * eng.model.cfg.num_layers


def test_padded_step_builds_one_plan_per_attention_type(monkeypatch):
    """The paged decode kernel's plan depends only on a step's tables, page
    starts and positions: a T == 1 padded step builds it once per attention
    type and hands that one plan to every layer's call, never one per
    layer."""
    from repro_torch.models import lm
    builds, plans = [], []

    def plan(*args, **kw):
        builds.append(args[3])                     # tokens per page
        return lm_plan(*args, **kw)

    def spy(q, kv_view, tables, page_pos, positions, *, window=0,
            plan=None):
        plans.append(plan)
        return paged_decode_attention_plain(q, kv_view, tables, page_pos,
                                            positions, window=window,
                                            plan=plan)

    lm_plan = lm.paged_decode_plan
    monkeypatch.setattr(lm, "paged_decode_plan", plan)
    monkeypatch.setattr(blocks_attn, "paged_decode_attention", spy)
    eng = port_engine(batching_mode="padded", max_num_batched_tokens=24)
    counts = _count_decode_dispatches(eng)
    drain(eng, workload(n=4), Request, SamplingParams)
    n_layers = eng.model.cfg.num_layers
    n_types = len(eng.model._attn_views(eng.model._layer_views(
        eng.runner.buffer)))
    assert counts["decode"] > 0
    assert len(builds) == counts["decode"] * n_types
    assert len(plans) == counts["decode"] * n_layers
    # the layers of one step share one plan object
    for step in range(counts["decode"]):
        layer_plans = plans[step * n_layers:(step + 1) * n_layers]
        assert all(x is layer_plans[0] for x in layer_plans)


def test_padded_eos_in_deep_ring_rolls_back_and_drains_clean(monkeypatch):
    """EOS found while up to 3 speculative padded steps are queued (depth
    4): every such row is killed (tables, write targets -1, positions
    SENTINEL), its pages rolled back, and the pool drains fully — with
    PageSan checking every dispatch."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    probe = port_engine(batching_mode="padded", enable_prefix_caching=False)
    ref = drain(probe, workload(n=4, max_new=10), Request, SamplingParams)
    # EOS for half the requests only: a plan whose rows all died is never
    # dispatched, so the others keep killed rows inside live dispatches
    eos = {rid: out[len(out) // 2] for rid, out in ref.items()
           if len(out) > 2 and rid in ("r0", "r1")}
    assert eos
    eng = port_engine(batching_mode="padded", async_scheduling=True,
                      pipeline_depth=4, enable_prefix_caching=False)
    assert eng.mgr.sanitizer is not None
    counts = _count_decode_dispatches(eng)
    outs = drain(eng, workload(n=4, max_new=10, eos=eos), Request,
                 SamplingParams)
    for rid, out in outs.items():
        if rid in eos:
            cut = ref[rid].index(eos[rid]) + 1
            assert out == ref[rid][:cut], (rid, out, ref[rid])
    assert eng.spec_kills >= 1 and counts["killed"] >= 1
    assert_drained_clean(eng)
    eng.mgr.sanitizer.assert_drained()
    stats = eng.mgr.memory_stats()
    assert stats.free_units == stats.total_units, stats
