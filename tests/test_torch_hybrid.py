"""The port's hybrid family (``HybridLM``, reduced zamba2-1.2b: 5 layers,
``attn_every`` 2, so one tail layer) against JAX ``HybridLM``, on the CPU.

Both packages get the JAX init's weights (the weight bridge), the same
``PreparedStep`` arrays from one JAX runner and the same buffer bytes.
Tolerances:

* logits 2e-2 abs in fp32 (the dense slices' bound: bf16 residual sums in
  another order; measured ~3e-3);
* written K/V within 1 bf16 ulp of the written pages' largest magnitude
  (as for the dense family: the shared attention reads a residual stream
  that already differs by roundings);
* decoded fp32 state pages: layer 0 sees the same inputs on both sides,
  so its conv state (the bf16 projection inputs) is bit-exact and its SSM
  state within 1e-5 of its largest |value| (fp32 sums in another order:
  the port scans each segment in 64-token chunks, JAX the stream in
  128-token ones). Deeper layers read a residual stream that differs by
  bf16 roundings: conv state within 1 bf16 ulp of its largest |value|,
  SSM state within 2e-2 of it, since the state integrates those inputs
  (measured at most 6.8e-3);
* every other byte of the buffer equal, the scratch page excepted (the
  port sends dropped writes there, JAX drops them);
* engines: fork-aware equal to JAX's (``assert_greedy_equiv``), the port's
  pipeline depths bitwise equal, the pool drained clean with PageSan on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

from conftest import assert_greedy_equiv, get_model, make_engine  # noqa: E402
from repro.core import JengaKVCacheManager  # noqa: E402
from repro.core.request import SequenceState  # noqa: E402
from repro.core.spec import BYTES_PER_UNIT, make_geometry  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.spec import lcm  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_varlen_plain)
from repro_torch.kernels.flash_attention import kernel as varlen_kernel  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_chunk_scan_varlen, mamba_chunk_scan_varlen_plain)
from repro_torch.kernels.mamba_scan.kernel import check_inputs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_plain)
from repro_torch.kernels.paged_attention import kernel as paged_kernel  # noqa: E402
from repro_torch.models import (RWKVLM, DecoderLM, EncDecLM,  # noqa: E402
                                HybridLM, blocks_attn, build_model,
                                params_from_numpy)
from repro_torch.models import blocks_seq  # noqa: E402
from repro_torch.models.attention import bf16_pair_to_f32  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, Request,  # noqa: E402
                                 SamplingParams)

from test_arch_smoke import buffer_for, make_serve_batch  # noqa: E402
from test_torch_engine import (DEPTHS, assert_drained_clean, drain,  # noqa: E402
                               workload)
from test_torch_serve_step import bf16_ulp, to_batch, written_units  # noqa: E402

ARCH = "zamba2-1.2b"
_PORT = {}


def port_model():
    """(HybridLM, params) of the port, sharing the JAX init's weights."""
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


# ------------------------------------------------------------ serve step
PROMPTS = [[(5 * i + 3 * j) % 97 for j in range(n)]
           for i, n in enumerate((13, 6, 45))]


def _jax_step(mode, steps, **kw):
    """A JAX engine advanced ``steps`` steps; returns the next plan's
    PreparedStep (fresh pages zeroed), the buffer before and after JAX's
    dispatch of it, and JAX's logits."""
    eng, _ = make_engine(ARCH, batching_mode=mode, **kw)
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


def _check_step(prep, buf0, jlogits, jbuf):
    model, params = port_model()
    buf = tensor_from_numpy(buf0.copy())
    logits = model.serve_step(params, buf, to_batch(prep.arrs),
                              prefill=prep.info["prefill"])[:prep.n]
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    diff = np.abs(logits.numpy() - jlogits)
    assert diff.max() < 2e-2, diff.max()

    views = model._layer_views(buf)
    av, mv = views["full_attn"], views["mamba"]
    ours, ref = buf.float().numpy(), jbuf.astype(np.float32)
    total = ours.shape[0]
    w = written_units(prep, av, total, range(av[1]))
    assert w.any()
    eids = [int(e) for e in prep.arrs["state_eids"]["mamba"].reshape(-1)
            if e >= 0]
    assert eids
    page = mv[1] * mv[2]
    sw = np.zeros(total, bool)
    for e in eids:
        sw[e * page:(e + 1) * page] = True
    untouched = ~(w | sw)
    big = lcm([s.page_units for s in model.kv_specs()])
    untouched[total - big:] = False                     # the scratch page
    assert np.array_equal(buf.view(torch.int16).numpy()[untouched],
                          buf0.view(np.int16)[untouched])
    assert np.array_equal(jbuf.view(np.int16)[untouched],
                          buf0.view(np.int16)[untouched])
    a, b = ours[w], ref[w]
    assert np.abs(a - b).max() <= bf16_ulp(np.abs(b).max()), \
        (np.abs(a - b).max(), np.abs(b).max())

    n_ssm = model.md["ssm_units"]
    jv = t(jbuf).view(mv)
    for e in eids:
        for layer in range(mv[1]):
            so = bf16_pair_to_f32(buf.view(mv)[e, layer]).numpy()
            sj = bf16_pair_to_f32(jv[e, layer]).numpy()
            assert np.isfinite(so).all()
            ssm_err = np.abs(so[:n_ssm] - sj[:n_ssm]).max()
            ssm_max = np.abs(sj[:n_ssm]).max()
            conv_o, conv_j = so[n_ssm:], sj[n_ssm:]
            if layer == 0:
                assert np.array_equal(conv_o, conv_j), e
                assert ssm_err <= 1e-5 * ssm_max, (e, layer, ssm_err)
            else:
                assert np.abs(conv_o - conv_j).max() <= \
                    bf16_ulp(np.abs(conv_j).max()), (e, layer)
                assert ssm_err <= 2e-2 * ssm_max, (e, layer, ssm_err)


@pytest.mark.parametrize("mode,steps,prefill,decode_only", [
    ("packed", 2, True, False),     # prefill chunks and decodes
    ("packed", 6, True, True),      # decode-only packed step
    ("padded", 1, True, False),     # T > 1 rows
    ("padded", 3, False, True),     # T == 1: mamba2_step + paged kernel
])
def test_serve_step_matches_jax(mode, steps, prefill, decode_only):
    plan, prep, *rest = _jax_step(mode, steps, max_num_batched_tokens=24)
    assert prep.info["prefill"] == prefill
    assert bool(plan.prefills) != decode_only
    launches = mamba_chunk_scan_varlen.launches
    _check_step(prep, *rest)
    assert mamba_chunk_scan_varlen.launches == launches     # CPU: plain


def test_chunked_prefill_then_decodes_equals_long_prefill():
    """The port's counterpart of ``test_arch_smoke.py``'s recurrent
    consistency test: a T-token prefill then two T == 1 decodes (the
    state carried through the buffer, ``mamba2_step``) against one
    (T+2)-token prefill. The reference's own bound is 0.25; the port holds
    both sides to 2e-2 (bf16 roundings of two routes) and its long
    prefill to JAX's."""
    jmodel, cfg, jparams = get_model(ARCH)
    model, params = port_model()
    b, t_ = 1, 8
    units = buffer_for(jmodel).shape[-1]
    toks = np.arange(t_ + 3, dtype=np.int32)[None] % cfg.vocab_size

    def batch(n, prefill, tok):
        jb = make_serve_batch(jmodel, cfg, b, n if prefill else 1, n,
                              prefill=prefill, buffer_units=units)
        arrs = {f: (None if v is None else
                    {k: np.asarray(x) for k, x in v.items()}
                    if isinstance(v, dict) else np.asarray(v))
                for f, v in jb.__dict__.items()}
        arrs["tokens"] = tok
        return to_batch(arrs)

    def prefill(n):
        buf = torch.zeros(units, dtype=torch.bfloat16)
        return model.serve_step(params, buf, batch(n, True, toks[:, :n]),
                                prefill=True), buf

    l_long, _ = prefill(t_ + 2)
    jb = make_serve_batch(jmodel, cfg, b, t_ + 2, t_ + 2, prefill=True,
                          buffer_units=units)
    jb = type(jb)(**{**jb.__dict__,
                     "tokens": jax.numpy.asarray(toks[:, :t_ + 2])})
    jl, _ = jax.jit(lambda p, buf, ba: jmodel.serve_step(
        p, buf, ba, prefill=True))(jparams, buffer_for(jmodel), jb)
    assert np.abs(l_long.numpy() - np.asarray(jl)).max() < 2e-2
    logits, buf = prefill(t_)
    for i in range(2):
        n = t_ + i + 1
        logits = model.serve_step(params, buf,
                                  batch(n, False, toks[:, n - 1:n]),
                                  prefill=False)
    err = float((logits - l_long).abs().max())
    assert err < 2e-2, err


# ---------------------------------------------------------------- engine
def test_packed_engine_matches_jax_depths_bitwise_under_pagesan(monkeypatch):
    """The scenario of ``test_pagesan.py``'s engine legs: the port's packed
    engine at depths 1, 2 and 4 with PageSan on, against JAX's."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    reqs = [dict(rid=f"r{i}", prompt=[(7 * i + j) % 50
                                      for j in range(6 + 3 * i)],
                 max_new_tokens=6, eos_token=None) for i in range(4)]
    jeng, _ = make_engine(ARCH, record_sample_logits=True)
    drain(jeng, reqs, JRequest, JSamplingParams)
    outs = {}
    for depth, kw in DEPTHS:
        eng = port_engine(record_sample_logits=True, **kw)
        assert eng.mgr.sanitizer is not None
        outs[depth] = drain(eng, reqs, Request, SamplingParams)
        assert_drained_clean(eng)
        eng.mgr.sanitizer.assert_drained()
        if depth == 1:
            assert_greedy_equiv(jeng, eng, label="zamba2/packed")
    assert outs[1] == outs[2] == outs[4], outs


def _count_copies(eng):
    kinds = []
    orig = eng.runner.apply_copies

    def apply_copies(ops):
        kinds.extend(op.kind for op in ops if op.type_name == "mamba")
        return orig(ops)

    eng.runner.apply_copies = apply_copies
    return kinds


def test_state_checkpoints_and_prefix_hit_restore_match_jax(monkeypatch):
    """Prompts past the 512-token checkpoint interval: checkpoint copies of
    state pages (deferred and caught up at depth 4), then a request that
    shares a 520-token prefix with a finished one hits the cache at 512
    and restores the checkpoint into its live state page. Fork-aware equal
    to JAX, depths bitwise, drained clean with PageSan on."""
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
    for depth, dkw in DEPTHS:
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
            assert_greedy_equiv(jeng, eng, label="zamba2/checkpoints")
    assert outs[1] == outs[2] == outs[4], outs


@pytest.mark.parametrize("mode", ["packed", "padded"])
def test_eos_in_deep_ring_kills_state_writes_and_drains_clean(monkeypatch,
                                                              mode):
    """EOS found while up to 3 speculative steps are queued (depth 4):
    each killed segment or row reads a zero state and writes only the
    scratch page (state eid -1), the survivors' outputs are those of a
    run without EOS, and the pool drains fully under PageSan."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    probe = port_engine(batching_mode=mode, enable_prefix_caching=False)
    ref = drain(probe, workload(n=4, max_new=10), Request, SamplingParams)
    eos = {rid: out[len(out) // 2] for rid, out in ref.items()
           if len(out) > 2 and rid in ("r0", "r1")}
    assert eos
    eng = port_engine(batching_mode=mode, async_scheduling=True,
                      pipeline_depth=4, enable_prefix_caching=False)
    killed = []
    orig = eng.runner.dispatch

    def dispatch(params, prep):
        for si in prep.dead:
            assert prep.arrs["state_eids"]["mamba"][0, si] == -1
            killed.append(si)
        return orig(params, prep)

    eng.runner.dispatch = dispatch
    outs = drain(eng, workload(n=4, max_new=10, eos=eos), Request,
                 SamplingParams)
    for rid, out in outs.items():
        cut = ref[rid].index(eos[rid]) + 1 if rid in eos else None
        assert out == ref[rid][:cut], (rid, out, ref[rid])
    assert eng.spec_kills >= 1 and killed
    assert_drained_clean(eng)
    eng.mgr.sanitizer.assert_drained()


def test_padded_and_serial_engines_match_jax():
    reqs = workload()
    ref = {}
    for mode in ("padded", "serial"):
        jeng, _ = make_engine(ARCH, batching_mode=mode,
                              record_sample_logits=True)
        drain(jeng, reqs, JRequest, JSamplingParams)
        ref[mode] = jeng
    outs = {}
    for depth, kw in DEPTHS:
        eng = port_engine(batching_mode="padded", record_sample_logits=True,
                          **kw)
        outs[depth] = drain(eng, reqs, Request, SamplingParams)
        assert_drained_clean(eng)
        if depth == 1:
            assert_greedy_equiv(ref["padded"], eng, label="zamba2/padded")
    assert outs[1] == outs[2] == outs[4], outs
    eng = port_engine(batching_mode="serial", record_sample_logits=True)
    drain(eng, reqs, Request, SamplingParams)
    assert_drained_clean(eng)
    assert_greedy_equiv(ref["serial"], eng, label="zamba2/serial")


@pytest.mark.parametrize("mode,depth", [("packed", 1), ("packed", 4),
                                        ("padded", 1), ("serial", 1)])
def test_hybrid_path_feeds_the_kernels_valid_inputs(monkeypatch, mode,
                                                    depth):
    """Every kernel call of the served hybrid passes its CUDA wrapper's
    input checks: the scan once per Mamba2 layer of every packed and
    padded T > 1 dispatch and never on T == 1 ones, the varlen kernel once
    per shared-attention call of every packed dispatch, the paged kernel
    once per shared-attention call of every T == 1 dispatch."""
    calls = dict(scan=0, varlen=0, paged=0)

    def scan(*args):
        check_inputs(*(a.to(torch.bfloat16) if i < 3 else a
                       for i, a in enumerate(args)))
        calls["scan"] += 1
        return mamba_chunk_scan_varlen_plain(*args)

    def varlen(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, window=0,
               blk_q=128, blk_k=128, kv_tiles=None):
        assert kv_tiles is not None        # the step's skip metadata
        varlen_kernel.check_inputs(q, k, v, q_seg, kv_seg, q_pos, kv_pos,
                                   blk_q, blk_k, kv_tiles)
        calls["varlen"] += 1
        return flash_attention_varlen_plain(q, k, v, q_seg, kv_seg, q_pos,
                                            kv_pos, window=window)

    def paged(q, kv_view, tables, page_pos, positions, *, window=0,
              plan=None):
        assert plan is not None            # the step's shared plan
        paged_kernel.check_inputs(q, kv_view, tables, page_pos, positions,
                                  window=window, plan=plan)
        calls["paged"] += 1
        return paged_decode_attention_plain(q, kv_view, tables, page_pos,
                                            positions, window=window,
                                            plan=plan)

    monkeypatch.setattr(blocks_seq, "mamba_chunk_scan_varlen", scan)
    monkeypatch.setattr(blocks_attn, "flash_attention_varlen", varlen)
    monkeypatch.setattr(blocks_attn, "paged_decode_attention", paged)
    eng = port_engine(batching_mode=mode, max_num_batched_tokens=24,
                      **dict(DEPTHS)[depth])
    decode = [0]
    orig = eng.runner.dispatch

    def dispatch(params, prep):
        decode[0] += not prep.info["prefill"]
        return orig(params, prep)

    eng.runner.dispatch = dispatch
    drain(eng, workload(n=4), Request, SamplingParams)
    cfg = eng.model.cfg
    n_super = cfg.num_layers // cfg.attn_every
    dispatches = eng.runner.dispatch_count
    assert calls["scan"] == (dispatches - decode[0]) * cfg.num_layers
    if mode == "packed":
        assert decode[0] == 0
        assert calls == dict(scan=calls["scan"], varlen=dispatches * n_super,
                             paged=0)
    else:
        assert decode[0] > 0
        assert calls["varlen"] == 0
        assert calls["paged"] == decode[0] * n_super


# ---------------------------------------------------------------- repairs
def test_paged_plain_ignores_masked_foreign_pages():
    """A table entry < 0 clamps to page 0, which in a hybrid pool may hold
    another type's bytes (fp32 state pairs decode as bf16 NaN). The CUDA
    kernel never reads an all-masked entry once a row sees some slot; the
    plain version used to multiply their zero probabilities by those
    values and return NaN for a live row. Rows with visible slots now give
    the same result as with page 0 zeroed; a row that sees nothing keeps
    the mean(V) contract."""
    rng = np.random.default_rng(21)
    b, kvl, g, d, tpp, p, vp = 3, 2, 1, 16, 4, 3, 5
    pool = rng.standard_normal((vp, 2, tpp, kvl, d)).astype(np.float32)
    kv = t(pool).to(torch.bfloat16)
    kv[0] = float("nan")
    q = t(rng.standard_normal((b, kvl, g, d)).astype(np.float32)).to(
        torch.bfloat16)
    tables = t(np.array([[2, -1, 3], [4, 1, -1], [-1, -1, -1]], np.int32))
    page_pos = t(np.array([[0, 1 << 29, 4], [0, 4, 1 << 29],
                           [1 << 29] * 3], np.int32))
    positions = t(np.array([6, 5, 1 << 29], np.int32))
    out = paged_decode_attention_plain(q, kv, tables, page_pos, positions)
    assert torch.isfinite(out[:2].float()).all()
    clean = kv.clone()
    clean[0] = 0
    ref = paged_decode_attention_plain(q, clean, tables, page_pos, positions)
    assert torch.equal(out[:2], ref[:2])
    assert torch.isnan(out[2].float()).all()      # mean(V) over page 0


def test_max_geometry_exec_ids_overlap_in_the_reference():
    """The reference's "max" geometry puts one small page in each large
    page, so a type's exec id is its large page id, yet buffer views
    address page ``eid`` at ``eid * page_units``: for a type whose page is
    smaller than the large page, live pages of different types share
    units. Recorded as a reference behaviour (ROADMAP queue 3) that the
    port does not copy: it lays each type's pages at the large-page stride
    (``tests/test_torch_geometry.py``)."""
    jmodel, _, _ = get_model(ARCH)
    specs = jmodel.kv_specs()
    g = make_geometry(specs, total_memory_bytes=10 ** 9, mode="max")
    mgr = JengaKVCacheManager(
        specs, total_memory_bytes=g.large_page_units * 8 * BYTES_PER_UNIT,
        mode="max")
    ranges = []
    for rid in ("r0", "r1"):
        r = SequenceState(rid=rid, tokens=list(range(9)))
        ok, _ = mgr.begin_request(r)
        assert ok and mgr.allocate_for_tokens(r, 9)
        for s in specs:
            for eid in r.live_pages(s.name) + list(r.state_pages.values()):
                ranges.append((s.name, eid * s.page_units,
                               (eid + 1) * s.page_units))
    overlaps = [(a, b) for i, a in enumerate(ranges)
                for b in ranges[i + 1:]
                if a[1] < b[2] and b[1] < a[2]]
    assert overlaps, ranges


# ---------------------------------------------------------------- model
def test_build_model_and_later_slices():
    cfg = reduced(ARCHS[ARCH])
    model = build_model(cfg)
    assert isinstance(model, HybridLM)
    assert isinstance(build_model(reduced(ARCHS["granite-3-2b"])), DecoderLM)
    # the last two families: their seeded init has the bridged tree's
    # shapes and dtypes
    flat = jax.tree_util.tree_flatten_with_path
    for arch, cls in (("rwkv6-3b", RWKVLM), ("whisper-tiny", EncDecLM)):
        later = build_model(reduced(ARCHS[arch]))
        assert isinstance(later, cls)
        _, lcfg, lparams = get_model(arch)
        a = flat(later.init(seed=0, device="cpu"))[0]
        b = flat(params_from_numpy(jax.tree.map(np.asarray, lparams), lcfg,
                                   "cpu"))[0]
        assert [k for k, _ in a] == [k for k, _ in b]
        for (k, x), (_, y) in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype, (arch, k)
    # every family trains (test_torch_train_hybrid.py and
    # test_torch_train_rwkv_encdec.py hold them to JAX)
    tok = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    for arch in ("rwkv6-3b", "whisper-tiny"):
        later = build_model(reduced(ARCHS[arch]))
        kw = {} if arch == "rwkv6-3b" else dict(enc_embeds=torch.zeros(
            (2, later.cfg.encoder_seq, later.cfg.d_model)))
        loss = later.train_loss(later.init(0, "cpu", master=True), tok, tok,
                                **kw)
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
    loss = model.train_loss(model.init(0, "cpu", master=True), tok, tok)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    # the port's seeded init has the bridged tree's shapes and dtypes
    _, bridged = port_model()
    own = model.init(seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    a, b = flat(own)[0], flat(bridged)[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, k
    assert bridged["mamba_main"]["conv_w"].dtype == torch.float32
    assert bridged["mamba_main"]["w_x"].dtype == torch.bfloat16
