"""The MAX page geometry (the paper's §4.4 baseline) in the port, on the CPU.

Under ``geometry_mode="max"`` every small page is padded to the largest
page, so a type's exec id is its large page id and its pages sit one large
page apart (``core.layout.geometry_stride``). The reference addresses page
``eid`` at ``eid * page_units`` under both geometries, so its MAX pages of
different types overlap (``test_torch_hybrid.
test_max_geometry_exec_ids_overlap_in_the_reference``); the port addresses
every page at its stride. Held here:

* (i) no two live pages of different types share a unit under "max";
  under "lcm" each type's view is the contiguous reshape it always was;
* (ii) the port's "max" manager gives the reference manager's exec ids and
  unit counts over one allocation trace (allocation is host-only);
* (iii) reduced zamba2-1.2b served under "max" equals "lcm" bit for bit
  (packed at depths 1 and 4, padded, serial; the 8 MiB pool and one of
  176 large pages, where the "max" engine used to stop at an assertion
  and to sample NaN logits; and at head dim 24, where the large page is
  not a multiple of a K/V slot, as at full width), PageSan on, no page
  leaked; the other families (one page size: the MAX stride is the page)
  padded under both geometries, danube under the paged baseline; a
  prefill/decode fleet whose handoff copies pages at the MAX stride;
* (iv) a reduced granite target with a 6-layer internlm2 draft (pages of
  1024 and 1536 units) decodes the same tokens, with the same accept
  lengths, under both geometries;
* (v) a mesh rank keeps the LCM stride: ``split_batch`` refuses a batch
  of a "max" engine; the paged kernel's wrapper refuses a page stride
  it cannot take.

The port's own random weights (seed 0); one intra-op thread, as the
other port tests (scripts/torch_cpu_first_vml_call.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import JengaKVCacheManager as JManager  # noqa: E402
from repro.core.request import SequenceState as JSequenceState  # noqa: E402
from repro.core.spec import KVCacheSpec as JKVCacheSpec  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import JengaKVCacheManager, UnifiedLayout  # noqa: E402
from repro_torch.core.layout import PageView, page_view  # noqa: E402
from repro_torch.core.request import SequenceState  # noqa: E402
from repro_torch.core.spec import BYTES_PER_UNIT, make_geometry  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_plain)
from repro_torch.kernels.paged_attention.kernel import check_inputs  # noqa: E402
from repro_torch.launch.input_specs import split_batch  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, Request,  # noqa: E402
                                 SamplingParams, SpecDecodeConfig,
                                 SpecDecodeEngine)

ARCH = "zamba2-1.2b"
MODES = [("packed-1", "packed", dict(async_scheduling=False)),
         ("packed-4", "packed", dict(async_scheduling=True,
                                     pipeline_depth=4)),
         ("padded", "padded", {}), ("serial", "serial", {})]
_MODELS = {}


def zamba(**overrides):
    """(model, params) of reduced zamba2 (``overrides`` on ``reduced``)."""
    key = tuple(sorted(overrides.items()))
    if key not in _MODELS:
        model = build_model(reduced(ARCHS[ARCH], **overrides))
        _MODELS[key] = (model, model.init(0, "cpu"))
    return _MODELS[key]


def large_units(specs, mode):
    return make_geometry(specs, total_memory_bytes=1 << 30,
                         mode=mode).large_page_units


def live_ranges(mgr, seqs, strides):
    """(type, first unit, end) of every live page of ``seqs``."""
    out = []
    for seq in seqs:
        for s in mgr.specs:
            eids = [e for e in seq.page_tables.get(s.name, []) if e >= 0]
            if s.name in seq.state_pages:
                eids.append(seq.state_pages[s.name])
            out += [(s.name, e * strides[s.name],
                     e * strides[s.name] + s.page_units) for e in eids]
    return out


def allocate(mgr, seq_cls, lens):
    seqs = []
    for i, n in enumerate(lens):
        seq = seq_cls(rid=f"r{i}", tokens=list(range(n)))
        ok, _ = mgr.begin_request(seq)
        assert ok and mgr.allocate_for_tokens(seq, n)
        seqs.append(seq)
    return seqs


# ----------------------------------------------------------------- (i)
def test_max_pages_of_different_types_share_no_unit():
    model, _ = zamba()
    specs = model.kv_specs()
    large = large_units(specs, "max")
    mgr = JengaKVCacheManager(specs, total_memory_bytes=12 * large *
                              BYTES_PER_UNIT, mode="max")
    seqs = allocate(mgr, SequenceState, (9, 3, 14))
    layout = UnifiedLayout(mgr.geometry, model.page_shapes(), scratch=1)
    strides = {s.name: layout.stride(s.name) for s in specs}
    assert set(strides.values()) == {large}
    ranges = live_ranges(mgr, seqs, strides)
    assert len({r[0] for r in ranges}) == 2
    overlaps = [(a, b) for i, a in enumerate(ranges) for b in ranges[i + 1:]
                if a[1] < b[2] and b[1] < a[2]]
    assert not overlaps
    assert max(r[2] for r in ranges) <= mgr.geometry.total_units
    # each view's pages are those ranges, read through the strided view
    buf = layout.alloc_buffer("cpu")
    assert buf.numel() == (mgr.geometry.num_large_pages + 1) * large
    flat = torch.arange(buf.numel(), dtype=torch.float64)
    for s in specs:
        view = page_view(flat, layout.views[s.name].view_shape)
        rows = layout.rows(flat, s.name)
        assert view.shape[0] == rows.shape[0] == \
            mgr.geometry.num_large_pages + 1
        for name, lo, hi in ranges:
            if name == s.name:
                eid = lo // large
                assert torch.equal(view[eid].reshape(-1),
                                   torch.arange(lo, hi, dtype=flat.dtype))
                assert torch.equal(rows[eid], view[eid].reshape(-1))


def test_lcm_views_are_the_contiguous_reshape():
    model, _ = zamba()
    specs = model.kv_specs()
    mgr = JengaKVCacheManager(specs, total_memory_bytes=8 << 20)
    layout = UnifiedLayout(mgr.geometry, model.page_shapes(), scratch=1)
    buf = layout.alloc_buffer("cpu")
    assert buf.numel() == mgr.geometry.total_units + \
        large_units(specs, "lcm")
    views = model._layer_views(buf)
    for s in specs:
        tv = layout.views[s.name]
        assert tv.stride == s.page_units
        old = buf.view((buf.numel() // s.page_units, s.num_layers)
                       + tv.page_shape)
        for got in (layout.view(buf, s.name), page_view(buf, views[s.name])):
            assert got.is_contiguous() and got.shape == old.shape
            assert got.stride() == old.stride()
            assert got.data_ptr() == old.data_ptr()
        assert tuple(views[s.name]) == tuple(tv.view_shape)
    assert layout.flatten(layout.view(buf, "mamba"), "mamba").data_ptr() \
        == buf.data_ptr()


def test_writes_at_a_stride_that_is_not_a_multiple_of_a_slot():
    """K/V and state writes at a page stride of page units + 4 (a K/V
    slot is 32 units): each lands at ``view_offset`` / its page's start,
    every other unit is unchanged."""
    rng = np.random.default_rng(0)
    vp, nl, tpp, kvl, d = 5, 3, 4, 2, 16
    page = nl * 2 * tpp * kvl * d
    shape = PageView((vp, nl, 2, tpp, kvl, d), page + 4)
    buf = torch.tensor(rng.standard_normal(vp * (page + 4)),
                       dtype=torch.bfloat16)
    want = buf.clone()
    eids = torch.tensor([[3, 1, -1, 3]])
    slots = torch.tensor([[0, 3, 2, 1]])
    k = torch.tensor(rng.standard_normal((1, 4, kvl, d)),
                     dtype=torch.bfloat16)
    v = torch.tensor(rng.standard_normal((1, 4, kvl, d)),
                     dtype=torch.bfloat16)
    A.write_token_kv(buf, shape, 2, eids, slots, k, v)
    for t in range(4):
        eid = int(eids[0, t]) if eids[0, t] >= 0 else vp - 1
        for sel, x in ((0, k), (1, v)):
            off = int(A.view_offset(shape, eid, 2, sel, int(slots[0, t])))
            want[off:off + kvl * d] = x[0, t].reshape(-1)
    assert torch.equal(buf.view(torch.int16), want.view(torch.int16))
    sview = PageView((vp, nl, 8), 30)
    state = torch.tensor(rng.standard_normal((2, 4)), dtype=torch.float32)
    A.write_state(buf, sview, 1, torch.tensor([2, -1]), state)
    for eid, row in ((2, 0), (vp - 1, 1)):
        want[eid * 30 + 8:eid * 30 + 16] = state[row].view(torch.bfloat16)
    assert torch.equal(buf.view(torch.int16), want.view(torch.int16))
    got = A.read_state(page_view(buf, sview), 1, torch.tensor([2, -1]))
    assert torch.equal(got[0], state[0]) and torch.equal(got[1],
                                                         torch.zeros(4))


# ---------------------------------------------------------------- (ii)
def test_max_manager_matches_the_reference_manager():
    """One allocation trace (three requests, growth, a free, a fourth
    request into the freed pages) through the port's and the reference's
    "max" managers: the same exec ids and unit counts at every step."""
    model, _ = zamba()
    specs = model.kv_specs()
    jspecs = [JKVCacheSpec(**dataclasses.asdict(s)) for s in specs]
    pool = 24 * large_units(specs, "max") * BYTES_PER_UNIT
    mgrs = (JManager(jspecs, total_memory_bytes=pool, mode="max"),
            JengaKVCacheManager(specs, total_memory_bytes=pool, mode="max"))

    def stats(m):
        st = m.memory_stats()
        return (st.used_units, st.empty_units, st.free_units,
                {n: (t.used, t.owned_large) for n, t in st.per_type.items()})

    def tables(seqs):
        return [({n: list(t) for n, t in s.page_tables.items()},
                 dict(s.state_pages)) for s in seqs]

    trace = []
    for mgr, seq_cls in zip(mgrs, (JSequenceState, SequenceState)):
        seqs = allocate(mgr, seq_cls, (9, 5, 13))
        log = [(tables(seqs), stats(mgr))]
        mgr.advance(seqs[0], 9)
        seqs[0].append_token(7)
        assert mgr.allocate_for_tokens(seqs[0], 14)
        log.append((tables(seqs), stats(mgr)))
        mgr.free_request(seqs[1], cache=False)
        extra = seq_cls(rid="r9", tokens=list(range(6)))
        assert mgr.begin_request(extra)[0] and \
            mgr.allocate_for_tokens(extra, 6)
        log.append((tables(seqs + [extra]), stats(mgr)))
        trace.append(log)
    assert trace[0] == trace[1]
    assert trace[1][0][1][0] > 0


# --------------------------------------------------------------- (iii)
def serve(model, params, mode, pool, geometry, kw, n=3):
    eng = Engine(model, EngineConfig(
        kv_pool_bytes=pool, max_running=4, chunk_size=8, batching_mode=mode,
        geometry_mode=geometry, **kw), params=params, device="cpu")
    assert eng.mgr.sanitizer is not None
    for i in range(n):
        eng.submit(Request(rid=f"r{i}",
                           prompt=[(7 * i + j) % 50 for j in range(6 + 9 * i)],
                           sampling=SamplingParams(max_new_tokens=6)))
    eng.run_until_done()
    eng.mgr.check_invariants()
    assert eng.mgr.memory_stats().used_units == 0
    assert len(eng.finished) == n
    return {r.rid: list(r.output) for r in eng.finished}, eng


POOLS = {"8MiB": lambda large: 8 << 20,
         "176-large-pages": lambda large: 176 * large * BYTES_PER_UNIT}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("name,mode,kw", MODES, ids=[m[0] for m in MODES])
def test_zamba2_max_serves_exactly_what_lcm_serves(monkeypatch, pool, name,
                                                   mode, kw):
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    model, params = zamba()
    large = large_units(model.kv_specs(), "max")
    nbytes = POOLS[pool](large)
    lcm_out, _ = serve(model, params, mode, nbytes, "lcm", kw)
    max_out, eng = serve(model, params, mode, nbytes, "max", kw)
    assert max_out == lcm_out
    assert len({t for o in max_out.values() for t in o}) > 1
    assert set(eng.runner.page_strides.values()) == {large}
    assert eng.runner.buffer.numel() == \
        (eng.mgr.geometry.num_large_pages + 1) * large


def test_zamba2_max_where_the_large_page_splits_a_slot(monkeypatch):
    """Head dim 24: a K/V slot is 96 units and the large page (a Mamba
    state page, 25,280 units) is not a multiple of it, as at full width
    (2048 and 20,886,016)."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    model, params = zamba(head_dim=24)
    large = large_units(model.kv_specs(), "max")
    kvl_d = model.kv_local * model.cfg.head_dim
    assert large % kvl_d
    for _, mode, kw in MODES:
        lcm_out, _ = serve(model, params, mode, 8 << 20, "lcm", kw)
        max_out, _ = serve(model, params, mode, 8 << 20, "max", kw)
        assert max_out == lcm_out, mode


FAMILIES = [("granite-3-2b", {}), ("dbrx-132b", {}), ("qwen2-vl-2b", {}),
            ("h2o-danube-3-4b", dict(memory_mode="paged-baseline")),
            ("whisper-tiny", {}), ("rwkv6-3b", {})]


@pytest.mark.parametrize("arch,kw", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_every_family_serves_the_same_under_max(monkeypatch, arch, kw):
    """The other families (their KV types share one page size, so the
    MAX stride is each page's own): padded, the paged kernel's route,
    equal under both geometries (danube under the paged baseline)."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    model = build_model(reduced(ARCHS[arch]))
    params = model.init(0, "cpu")
    kw = dict(kw, async_scheduling=False)
    outs = [serve(model, params, "padded", 8 << 20, g, kw)[0]
            for g in ("lcm", "max")]
    assert outs[0] == outs[1]


def test_fleet_handoff_under_max(monkeypatch):
    """A prefill shard hands each request to a decode shard: the adopted
    pages move at each buffer's MAX stride, and the fleet decodes what
    the "lcm" fleet decodes."""
    from repro_torch.serving import DPEngine
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    model, params = zamba()
    outs = {}
    for g in ("lcm", "max"):
        dp = DPEngine(model, EngineConfig(kv_pool_bytes=8 << 20,
                                          max_running=4, chunk_size=8,
                                          geometry_mode=g),
                      params=params, num_shards=2, split_pool=False,
                      roles=["prefill", "decode"], device="cpu")
        for i in range(3):
            dp.submit(Request(rid=f"r{i}", prompt=[(5 * i + j) % 60 for j
                                                   in range(7 + 8 * i)],
                              sampling=SamplingParams(max_new_tokens=5)))
        dp.run_until_done()
        assert len(dp.handoffs) == 3 and dp.fleet_stats()["handoff_pages"]
        for sh in dp.shards:
            assert sh.engine.mgr.memory_stats().used_units == 0
        outs[g] = {r.rid: list(r.output) for r in dp.finished}
    assert outs["lcm"] == outs["max"] and len(outs["max"]) == 3


# ---------------------------------------------------------------- (iv)
def test_spec_decoding_with_a_draft_page_of_another_size():
    tcfg = reduced(ARCHS["granite-3-2b"])
    dcfg = reduced(ARCHS["internlm2-1.8b"], num_layers=6,
                   vocab_size=tcfg.vocab_size)
    tm = build_model(tcfg)
    tp = tm.init(0, "cpu")
    dp = build_model(dcfg).init(1, "cpu")
    prompt = [(5 * j + 3) % 97 for j in range(11)]
    res = {}
    for geometry in ("lcm", "max"):
        sd = SpecDecodeEngine(build_model(tcfg), build_model(dcfg),
                              SpecDecodeConfig(k=2, kv_pool_bytes=16 << 20,
                                               chunk_size=8,
                                               geometry_mode=geometry),
                              target_params=tp, draft_params=dp,
                              device="cpu")
        sizes = sorted(s.page_units for s in sd.mgr.specs)
        rounds, fetch = [], sd._fetch_round

        def recording(d_handles, v_handles, fetch=fetch, rounds=rounds):
            # each round's draft proposals and the draft steps' logits: a
            # draft that read its strided pages wrongly would change them
            # even where the target rejects every proposal
            toks = fetch(d_handles, v_handles)
            rounds.append((toks, torch.stack([h.logits[0].float()
                                              for h in d_handles])))
            return toks

        sd._fetch_round = recording
        out = sd.generate(prompt, max_new_tokens=10)
        assert sd.mgr.memory_stats().used_units == 0
        res[geometry] = (out, list(sd.accept_lengths),
                         sd.mgr.geometry.large_page_units, rounds)
    assert sizes == [1024, 1536]
    assert res["lcm"][:2] == res["max"][:2]
    assert (res["lcm"][2], res["max"][2]) == (3072, 1536)
    lcm, mx = res["lcm"][3], res["max"][3]
    assert len(lcm) == len(mx) == len(res["max"][1])
    for (t0, l0), (t1, l1) in zip(lcm, mx):
        assert t0 == t1
        assert torch.equal(l0.view(torch.int32), l1.view(torch.int32))
    plain = Engine(tm, EngineConfig(kv_pool_bytes=16 << 20, chunk_size=8),
                   params=tp, device="cpu")
    plain.submit(Request(rid="p", prompt=prompt,
                         sampling=SamplingParams(max_new_tokens=10)))
    plain.run_until_done()
    assert list(plain.finished[0].output) == res["max"][0]


# ----------------------------------------------------------------- (v)
def test_mesh_batches_and_the_paged_kernel_refuse_what_they_cannot_take():
    model, params = zamba()
    eng = Engine(model, EngineConfig(kv_pool_bytes=8 << 20,
                                     geometry_mode="max"),
                 params=params, device="cpu")
    eng.submit(Request(rid="r0", prompt=list(range(9)),
                       sampling=SamplingParams(max_new_tokens=2)))
    plan = eng.scheduler.schedule()
    prep = eng.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled])
    with pytest.raises(NotImplementedError, match="max"):
        split_batch(prep.arrs, model, 0, 0)
    lcm = Engine(model, EngineConfig(kv_pool_bytes=8 << 20), params=params,
                 device="cpu")
    lcm.submit(Request(rid="r0", prompt=list(range(9)),
                       sampling=SamplingParams(max_new_tokens=2)))
    plan = lcm.scheduler.schedule()
    prep = lcm.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled])
    assert split_batch(prep.arrs, model, 0, 0)["tokens"] is \
        prep.arrs["tokens"]
    # the paged kernel reads a strided layer view in place; a page stride
    # that breaks its 16-byte rows is refused, never copied
    rng = np.random.default_rng(1)
    b, kvl, g, d, tpp, vp = 2, 2, 1, 16, 4, 6
    page = 2 * tpp * kvl * d
    q = torch.tensor(rng.standard_normal((b, kvl, g, d)),
                     dtype=torch.bfloat16)
    tables = torch.tensor([[4, 1], [2, -1]], dtype=torch.int32)
    page_pos = torch.tensor([[0, 4], [0, 1 << 29]], dtype=torch.int32)
    positions = torch.tensor([6, 3], dtype=torch.int32)
    for stride, ok in ((page + 40, True), (page + 4, False)):
        flat = torch.tensor(rng.standard_normal(vp * stride),
                            dtype=torch.bfloat16)
        kv = page_view(flat, PageView((vp, 1, 2, tpp, kvl, d), stride))[:, 0]
        args = (q, kv, tables, page_pos, positions)
        if ok:
            check_inputs(*args)
            assert torch.equal(paged_decode_attention_plain(*args),
                               paged_decode_attention_plain(
                                   q, kv.contiguous(), *args[2:]))
        else:
            with pytest.raises(ValueError, match="16-byte"):
                check_inputs(*args)
