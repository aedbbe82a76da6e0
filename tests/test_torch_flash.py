"""The varlen flash kernel's plain PyTorch version against the JAX kernel
(Pallas in interpret mode) and its masked-softmax oracle, on the cases of
``test_kernels_flash_mamba.py`` and ``test_kernel_attention.py``; plus the
packed serve-path wrapper and the segment-mask property.

Tolerances: fp32 inputs 3e-5 (the JAX tests' own bound: online vs
two-pass softmax in fp32); bf16 packed-path outputs 2e-2 (a few bf16 ulps
at |out| ~ 1, with a different summation order). The CUDA kernel itself
runs only on the card: its test is marked ``cuda`` and skips here; a
tile-by-tile emulation of its numerics (GQA-packed q tiles, the hit list,
split partials, bf16 P) is held here to the card's tolerance (2e-2, as
``chip_smoke.py``'s ``TOL``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_varlen_tpu  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_varlen_ref  # noqa: E402
from repro.models import blocks_attn as JBA  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_varlen, flash_attention_varlen_plain)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    KV_TILE, SPLIT_TILES, check_inputs, varlen_kv_tiles, varlen_plan)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks_attn as BA  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402

from test_kernel_attention import packed_case  # noqa: E402
from test_kernels_flash_mamba import _packed_layout  # noqa: E402


def t(a):
    return tensor_from_numpy(np.asarray(a))


def _inputs(seed, bh, t_, s, d, n_seg=4, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or bh
    q = rng.standard_normal((bh, t_, d)).astype(np.float32)
    k = rng.standard_normal((kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((kvh, s, d)).astype(np.float32)
    return (q, k, v) + _packed_layout(rng, t_, s, n_seg)


def _jax_rep(q, k, v):
    """JAX streams repeat kv heads per q group (kv head h -> q heads
    h*G .. h*G+G-1), the port's kernel maps them by index."""
    g = q.shape[0] // k.shape[0]
    return jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, 0), \
        jnp.repeat(jnp.asarray(v), g, 0)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("bh,kvh,t_,s,d,blk", [
    (2, 2, 128, 128, 64, 64),
    (1, 1, 128, 256, 32, 64),
    (4, 1, 64, 96, 16, 32),          # GQA: 4 q heads on one kv head
    (12, 2, 64, 96, 16, 32),         # G 6 (dbrx, qwen2-vl-2b)
    (16, 1, 64, 96, 16, 32),         # G 16 (qwen3-moe)
])
def test_plain_matches_jax_kernel_and_ref(bh, kvh, t_, s, d, blk, window):
    q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(7, bh, t_, s, d,
                                                    kvh=kvh)
    meta = (q_seg, kv_seg, q_pos, kv_pos)
    ours = flash_attention_varlen_plain(t(q), t(k), t(v),
                                        *map(t, meta), window=window)
    jq, jk, jv = _jax_rep(q, k, v)
    jm = tuple(map(jnp.asarray, meta))
    kern = flash_attention_varlen_tpu(jq, jk, jv, *jm, window=window,
                                      blk_q=blk, blk_k=blk, interpret=True)
    ref = flash_attention_varlen_ref(jq, jk, jv, *jm, window=window)
    valid = q_seg >= 0
    for other in (kern, ref):
        np.testing.assert_allclose(ours.numpy()[:, valid],
                                   np.asarray(other)[:, valid],
                                   atol=3e-5, rtol=3e-5)


def test_plain_no_cross_segment_leak():
    """Scrambling one segment's K/V leaves every other segment's rows
    unchanged (direct no-leak check, independent of the oracle)."""
    q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(11, 1, 64, 64, 32,
                                                    n_seg=3)
    meta = tuple(map(t, (q_seg, kv_seg, q_pos, kv_pos)))
    base = flash_attention_varlen_plain(t(q), t(k), t(v), *meta).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, kv_seg == 0] = 1e3
    v2[:, kv_seg == 0] = -1e3
    pert = flash_attention_varlen_plain(t(q), t(k2), t(v2), *meta).numpy()
    others = q_seg > 0
    assert np.array_equal(base[:, others], pert[:, others])
    assert not np.array_equal(base[:, q_seg == 0], pert[:, q_seg == 0])


def test_plain_rows_without_visible_slot_are_exactly_zero():
    """Pad rows (seg -1 against kv pads -2) and a segment whose only slots
    lie in its future come out exactly 0.0 — in JAX's kernel too."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 16)).astype(np.float32)
    q_seg = np.array([0] * 6 + [1] * 4 + [-1] * 6, np.int32)
    q_pos = np.array(list(range(6)) + [0, 1, 2, 3] + [0] * 6, np.int32)
    kv_seg = np.array([0] * 12 + [1] * 4 + [-2] * 8, np.int32)
    kv_pos = np.array(list(range(12)) + [10, 11, 12, 13] + [0] * 8,
                      np.int32)
    meta = (q_seg, kv_seg, q_pos, kv_pos)
    ours = flash_attention_varlen_plain(t(q), t(k), t(v),
                                        *map(t, meta)).numpy()
    kern = np.asarray(flash_attention_varlen_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *map(jnp.asarray, meta), blk_q=8, blk_k=8))
    empty = q_seg != 0
    assert (ours[:, empty] == 0.0).all()
    assert (kern[:, empty] == 0.0).all()
    np.testing.assert_allclose(ours[:, ~empty], kern[:, ~empty],
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_packed_kernel_attention_matches_jax(window):
    """The port's one-call packed path (chunk-start gating by scatter-max,
    kv heads NOT repeated) vs the JAX kernel route on the hand-built packed
    step of ``test_kernel_attention.packed_case``."""
    q, k, v, kf, vf, seg, pos, cs, sseg, spos = packed_case()
    meta = BA.packed_attention_meta(t(spos), t(sseg), t(pos), t(seg), t(cs))
    ours = BA.packed_kernel_attention(t(q), t(k), t(v), t(kf), t(vf), meta,
                                      window=window)
    ref = JBA.packed_kernel_attention(q, k, v, spos, sseg, kf, vf, pos,
                                      seg, cs, window=window)
    rows = np.asarray(seg[0]) >= 0
    diff = np.abs(ours.float().numpy()[0, rows]
                  - np.asarray(ref, np.float32)[0, rows])
    assert diff.max() < 2e-2, diff.max()


def test_wrapper_takes_plain_version_on_cpu_only():
    q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(5, 2, 32, 48, 16)
    args = [t(x).to(torch.bfloat16) for x in (q, k, v)] + \
        [t(x) for x in (q_seg, kv_seg, q_pos, kv_pos)]
    before = flash_attention_varlen.launches
    out = flash_attention_varlen(*args, blk_q=8, blk_k=16)
    assert flash_attention_varlen.launches == before    # no kernel here
    assert torch.equal(out, flash_attention_varlen_plain(*args))
    with pytest.raises(ValueError):
        flash_attention_varlen(*(a.to("meta") for a in args))


def test_segment_mask_property():
    """Hypothesis: for random packed layouts, token i never sees a slot of
    another segment, a future position of its own segment, nor (with
    chunk_start) a slot at or after its chunk start; pads match nothing.
    kv pads are drawn as -2 only: the mask compares ids with ``==``, so a
    q pad (-1) DOES see a kv slot tagged -1, by the reference's design."""
    pytest.importorskip("hypothesis")
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @settings(max_examples=30, deadline=None, database=None)
    @given(st.data())
    def check(data):
        n_seg = data.draw(st.integers(1, 4))
        lens = [data.draw(st.integers(1, 6)) for _ in range(n_seg)]
        starts = [data.draw(st.integers(0, 20)) for _ in range(n_seg)]
        q_seg, q_pos, cs = [], [], []
        for i, (ln, st0) in enumerate(zip(lens, starts)):
            q_seg += [i] * ln
            q_pos += list(range(st0, st0 + ln))
            cs += [st0] * ln
        pad = data.draw(st.integers(0, 3))
        q_seg += [-1] * pad
        q_pos += [1 << 29] * pad
        cs += [1 << 29] * pad
        s = data.draw(st.integers(1, 24))
        kv_seg = [data.draw(st.sampled_from([-2] + list(range(n_seg))))
                  for _ in range(s)]
        kv_pos = [data.draw(st.integers(0, 30)) for _ in range(s)]
        qs, qp, c = (np.array([x], np.int32) for x in (q_seg, q_pos, cs))
        ks, kp = (np.array([x], np.int32) for x in (kv_seg, kv_pos))
        for chunk in (None, c):
            m = A.segment_mask(t(qs), t(qp), t(ks), t(kp),
                               chunk_start=None if chunk is None
                               else t(chunk)).numpy()[0]
            lim = qp[0][:, None] if chunk is None else c[0][:, None] - 1
            allowed = (ks[0][None, :] == qs[0][:, None]) & \
                (qs[0][:, None] >= 0) & (kp[0][None, :] <= lim)
            assert np.array_equal(m, allowed)

    check()


TOL = 2e-2          # chip_smoke.py's bf16 output tolerance
LOG2E = 1.4426950408889634


def _stream(segs, *, t_total, dead_slots=0, novis=()):
    """A packed call as the serve path builds it (chip_smoke.py's
    ``_case``): each segment is (old slots, fresh tokens, chunk start); kv =
    old slots ++ dead slots (seg -2) ++ the fresh tokens; q pads (seg -1)
    at the end, fresh pad slots tagged -2; segments in ``novis`` see no
    slot. Returns q_seg, q_pos, kv_seg, kv_pos (int32 numpy)."""
    q_seg, q_pos, kv_seg, kv_pos = [], [], [], []
    for si, (old, fresh, start) in enumerate(segs):
        kv_seg += [-2 if si in novis else si] * old
        kv_pos += list(range(old))
        q_seg += [si] * fresh
        q_pos += list(range(start, start + fresh))
    kv_seg += [-2] * dead_slots
    kv_pos += [1 << 29] * dead_slots
    n_pad = t_total - len(q_seg)
    q_seg += [-1] * n_pad
    q_pos += [1 << 29] * n_pad
    kv_seg += [-2 if x in novis or x < 0 else x for x in q_seg]
    kv_pos += q_pos
    return tuple(np.array(a, np.int32) for a in (q_seg, q_pos, kv_seg,
                                                 kv_pos))


def _emulate_kernel(q, k, v, q_seg, kv_seg, q_pos, kv_pos, window=0):
    """The CUDA kernel's arithmetic, tile by tile, on the CPU: q tiles of
    ``varlen_plan`` tokens whose rows are GQA packed (row r: token r // G,
    head r % G), each q tile's hit list from ``varlen_kv_tiles``, split
    by tile index into n_splits equal ranges as the kernel splits it (the
    ranges with hits in use), bf16 inputs multiplied
    exactly and summed in fp32, the scale after the product, base-2
    softmax with -inf masking, P rounded to bf16 before P V (l sums the
    fp32 P), split partials combined in split order, out = acc / max(l,
    1e-30). Returns (out bf16, the largest number of splits a q tile
    used)."""
    bh, t, d = q.shape
    kvh, s = k.shape[:2]
    g = bh // kvh
    tq, n_qt, ns = varlen_plan(t, s, g, kvh)
    tiles = varlen_kv_tiles(kv_seg, kv_pos)
    sl2 = d ** -0.5 * LOG2E
    qf, kf, vf = (a.float() for a in (q, k, v))
    out = torch.zeros(bh, t, d)
    most = 0
    for qt in range(n_qt):
        toks = torch.arange(qt * tq, min(t, (qt + 1) * tq))
        seg, pos = q_seg[toks], q_pos[toks]
        ok = seg >= 0
        hits = []
        if bool(ok.any()):
            hit = (tiles[:, 0] <= seg[ok].max()) & \
                (tiles[:, 1] >= seg[ok].min()) & (tiles[:, 2] <= pos[ok].max())
            if window:
                hit &= tiles[:, 3] > pos[ok].min() - window
            hits = hit.nonzero().flatten().tolist()
        n_kt = tiles.shape[0]
        runs = [[kt for kt in hits
                 if sp * n_kt // ns <= kt < (sp + 1) * n_kt // ns]
                for sp in range(ns)]
        runs = [r for r in runs if r] or [[]]
        used = len(runs)
        most = max(most, used)
        rt = toks.repeat_interleave(g)                 # row -> token
        for kv in range(kvh):
            rh = kv * g + torch.arange(g).repeat(len(toks))   # row -> head
            qr, qsr, qpr = qf[rh, rt], q_seg[rt], q_pos[rt]
            parts = []
            for run in runs:
                m = torch.full((len(rt),), -torch.inf)
                l = torch.zeros(len(rt))
                acc = torch.zeros(len(rt), d)
                for kt in run:
                    j = torch.arange(kt * KV_TILE, min(s, (kt + 1) * KV_TILE))
                    vis = (kv_seg[j][None] == qsr[:, None]) & \
                        (kv_pos[j][None] <= qpr[:, None])
                    if window:
                        vis &= kv_pos[j][None] > qpr[:, None] - window
                    sc = torch.where(vis, (qr @ kf[kv, j].T) * sl2,
                                     -torch.inf)
                    mn = torch.maximum(m, sc.amax(1))
                    mu = torch.where(mn == -torch.inf, 0.0, mn)
                    corr = torch.exp2(m - mu)
                    p = torch.exp2(sc - mu[:, None])
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + \
                        p.to(torch.bfloat16).float() @ vf[kv, j]
                    m = mn
                parts.append((m, l, acc))
            m, l, acc = parts[0]
            if used > 1:
                mm = torch.stack([pt[0] for pt in parts]).amax(0)
                mu = torch.where(mm == -torch.inf, 0.0, mm)
                l, acc = torch.zeros_like(l), torch.zeros_like(acc)
                for m_, l_, a_ in parts:
                    w = torch.exp2(m_ - mu)
                    l = l + l_ * w
                    acc = acc + a_ * w[:, None]
            out[rh, rt] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(torch.bfloat16), most


_MIXED = [(0, 40, 0), (300, 30, 300), (700, 1, 700), (500, 1, 500),
          (600, 1, 600)]
# name -> (H, KVL, D, window, stream kwargs): the kernel's cases at reduced
# sizes. Every case splits a q tile (the decode tokens' hit lists exceed
# SPLIT_TILES tiles); pads, dead slots and rows without a visible slot as
# named.
EMULATED_VARLEN = {
    "granite heads G=4 D=64, pads": (8, 2, 64, 0, dict(t_total=96)),
    "zamba2 heads G=1 D=64, dead slots": (
        4, 4, 64, 0, dict(t_total=96, dead_slots=70)),
    "qwen2.5-32b heads G=5 D=128": (10, 2, 128, 0, dict(t_total=80)),
    "internlm2 heads G=2 D=128, window": (4, 2, 128, 24, dict(t_total=96)),
    "G=4 D=64 window 400, no visible slot": (
        8, 2, 64, 400, dict(t_total=96, novis=(1, 3))),
    # floor(64 / 6) = 10 tokens x 6 heads a warpgroup: 4 dead rows
    "dbrx / qwen2-vl heads G=6 D=128, pads": (12, 2, 128, 0,
                                               dict(t_total=80)),
    # 4 tokens x 16 heads a warpgroup
    "qwen3-moe heads G=16 D=128": (32, 2, 128, 0, dict(t_total=64)),
}


@pytest.mark.parametrize("case", list(EMULATED_VARLEN))
def test_tensor_core_tiling_fits_card_tolerance(case):
    """The emulated kernel (``_emulate_kernel``) against the plain version
    and the JAX kernel (interpret mode) over rows with q_seg >= 0, within
    the card's TOL; rows with no visible slot exactly 0."""
    h, kvl, d, window, kw = EMULATED_VARLEN[case]
    q_seg, q_pos, kv_seg, kv_pos = _stream(_MIXED, **kw)
    t_, s = len(q_seg), len(kv_seg)
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
        for shape in ((h, t_, d), (kvl, s, d), (kvl, s, d)))
    meta = tuple(map(t, (q_seg, kv_seg, q_pos, kv_pos)))
    ours, most = _emulate_kernel(q, k, v, *meta, window=window)
    assert most > 1                      # a q tile was split
    valid = q_seg >= 0
    plain = flash_attention_varlen_plain(q, k, v, *meta, window=window)
    assert (ours.float() - plain.float())[:, valid].abs().max() <= TOL
    jq, jk, jv = _jax_rep(*(a.float().numpy() for a in (q, k, v)))
    kern = flash_attention_varlen_tpu(
        jq, jk, jv, *map(jnp.asarray, (q_seg, kv_seg, q_pos, kv_pos)),
        window=window, blk_q=t_, blk_k=512, interpret=True)
    diff = np.abs(ours.float().numpy() - np.asarray(kern, np.float32))
    assert diff[:, valid].max() <= TOL
    mask = (kv_seg[None] == q_seg[:, None]) & (kv_pos[None] <= q_pos[:, None])
    if window:
        mask &= kv_pos[None] > q_pos[:, None] - window
    empty = ~mask.any(1)
    assert empty.any() == ("no visible" in case or bool((~valid).any()))
    assert (ours[:, torch.from_numpy(empty)] == 0).all()


def test_split_rule_ignores_tiles_no_row_sees():
    """Sliding-window pages that one pipeline depth has already dropped
    (table entry -1: position SENTINEL) and another still gathers (real
    positions below every row's window) give the emulated kernel the same
    bytes, though the q tiles' hit lists differ: a tile no row sees adds
    exact zeros inside a split, and a split of only such tiles combines
    with weight 0."""
    window = 64
    segs = [(1200, 1, 1200), (900, 1, 900), (0, 30, 0), (700, 20, 700),
            (1000, 1, 1000)]
    q_seg, q_pos, kv_seg, kv_pos = _stream(segs, t_total=64)
    starts = np.array([st for _, _, st in segs])
    old = kv_pos < (1 << 29)
    below = old & (kv_seg >= 0) & \
        (kv_pos < starts[np.maximum(kv_seg, 0)] - window)
    dropped = np.where(below, 1 << 29, kv_pos).astype(np.int32)
    rng = np.random.default_rng(29)
    h, kvl, d = 8, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
        for shape in ((h, len(q_seg), d), (kvl, len(kv_seg), d),
                      (kvl, len(kv_seg), d)))
    live, gone = (_emulate_kernel(q, k, v, t(q_seg), t(kv_seg), t(q_pos),
                                  t(p), window=window)
                  for p in (kv_pos, dropped))
    assert not torch.equal(varlen_kv_tiles(t(kv_seg), t(kv_pos)),
                           varlen_kv_tiles(t(kv_seg), t(dropped)))
    assert live[1] > 1 and torch.equal(live[0], gone[0])


def test_varlen_kv_tiles_match_numpy():
    """Per-tile (seg lo, seg hi, pos lo, pos hi) over live slots, with the
    empty marker for tiles of dead and pad slots and a ragged last tile."""
    rng = np.random.default_rng(4)
    s = 3 * KV_TILE + 37
    kv_seg = rng.integers(-2, 5, s).astype(np.int32)
    kv_seg[KV_TILE:2 * KV_TILE] = -2                   # a tile of no live slot
    kv_pos = rng.integers(0, 1000, s).astype(np.int32)
    got = varlen_kv_tiles(t(kv_seg), t(kv_pos)).numpy()
    assert got.dtype == np.int32 and got.shape == (4, 4)
    for i in range(4):
        sg = kv_seg[i * KV_TILE:(i + 1) * KV_TILE]
        ps = kv_pos[i * KV_TILE:(i + 1) * KV_TILE]
        live = sg >= 0
        want = ([sg[live].min(), sg[live].max(), ps[live].min(),
                 ps[live].max()] if live.any() else
                [1 << 30, -(1 << 30), 1 << 30, -(1 << 30)])
        assert got[i].tolist() == want, i


@pytest.mark.parametrize("window", [0, 6])
def test_packed_meta_tile_intervals_match_numpy(window):
    """``packed_attention_meta``'s kv_tiles (computed once per step) equal
    a numpy recomputation from its own kv_seg / kv_pos, and the one-call
    packed path with them equals the call that computes them itself."""
    q, k, v, kf, vf, seg, pos, cs, sseg, spos = packed_case(s=300)
    meta = BA.packed_attention_meta(t(spos), t(sseg), t(pos), t(seg), t(cs))
    ks, kp = meta["kv_seg"].numpy(), meta["kv_pos"].numpy()
    n = -(-len(ks) // KV_TILE)
    want = np.empty((n, 4), np.int64)
    for i in range(n):
        sg, ps = ks[i * KV_TILE:(i + 1) * KV_TILE], \
            kp[i * KV_TILE:(i + 1) * KV_TILE]
        live = sg >= 0
        want[i] = ([sg[live].min(), sg[live].max(), ps[live].min(),
                    ps[live].max()] if live.any() else
                   [1 << 30, -(1 << 30), 1 << 30, -(1 << 30)])
    assert np.array_equal(meta["kv_tiles"].numpy(), want)
    ours = BA.packed_kernel_attention(t(q), t(k), t(v), t(kf), t(vf), meta,
                                      window=window)
    bare = dict(meta, kv_tiles=None)
    assert torch.equal(ours, BA.packed_kernel_attention(
        t(q), t(k), t(v), t(kf), t(vf), bare, window=window))


def test_plan_and_checks():
    """The launch plan's q tiles and splits (decode-like streams split,
    large grids do not), and the wrapper's checks of the new inputs."""
    assert varlen_plan(16, 8192, 4, 8) == (32, 1, 64 // SPLIT_TILES)
    assert varlen_plan(512, 4608, 4, 8) == (32, 16, 3)
    assert varlen_plan(512, 4608, 5, 8) == (24, 22, 2)
    assert varlen_plan(512, 4608, 1, 32) == (128, 4, 3)
    assert varlen_plan(4096, 4608, 4, 8)[2] == 1
    q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(5, 4, 32, 300, 16,
                                                    kvh=2)
    args = [t(x).to(torch.bfloat16) for x in (q, k, v)] + \
        [t(x) for x in (q_seg, kv_seg, q_pos, kv_pos)]
    tiles = varlen_kv_tiles(args[4], args[6])
    assert check_inputs(*args, 128, 128, tiles) == (4, 32, 300, 16, 2)
    with pytest.raises(ValueError):
        check_inputs(*args, 128, 128, tiles[:2])
    with pytest.raises(TypeError):
        check_inputs(*args, 128, 128, tiles.long())
    with pytest.raises(ValueError):                    # 65 q heads a kv head
        check_inputs(args[0].repeat(33, 1, 1)[:130], args[1][:1].repeat(
            2, 1, 1), *args[2:], 128, 128)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card (GQA, window,
    pad rows, dead slots; qwen2.5-32b's G=5 at D 128; the serve path's
    token-major views; q tiles split over blocks), exact zeros where no
    slot is visible, two calls byte-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    dev = torch.device("cuda")
    for window in (0, 8):
        q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(
            1, 8, 200, 300, 64, kvh=2)
        args = [t(x).to(dev, torch.bfloat16) for x in (q, k, v)] + \
            [t(x).to(dev) for x in (q_seg, kv_seg, q_pos, kv_pos)]
        before = flash_attention_varlen.launches
        out = flash_attention_varlen(*args, window=window, blk_q=32,
                                     blk_k=64)
        assert flash_attention_varlen.launches == before + 1
        ref = flash_attention_varlen_plain(*args, window=window)
        valid = torch.tensor(q_seg >= 0, device=dev)
        err = (out.float() - ref.float())[:, valid].abs().max().item()
        assert err < 2e-2, err
    for (h, kvl, d), window in (((40, 8, 128), 0), ((8, 2, 64), 16),
                                ((4, 4, 64), 0)):
        q_seg, q_pos, kv_seg, kv_pos = _stream(_MIXED, t_total=96,
                                               dead_slots=70)
        rng = np.random.default_rng(h)
        head = [torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                             device=dev)
                for shape in ((h, 96, d), (kvl, len(kv_seg), d),
                              (kvl, len(kv_seg), d))]
        token = [a.transpose(0, 1).contiguous().transpose(0, 1)
                 for a in head]
        meta = [t(x).to(dev) for x in (q_seg, kv_seg, q_pos, kv_pos)]
        assert varlen_plan(96, len(kv_seg), h // kvl, kvl)[2] > 1
        outs = [flash_attention_varlen(*qkv, *meta, window=window)
                for qkv in (token, token, head)]
        ref = flash_attention_varlen_plain(*head, *meta, window=window)
        assert torch.equal(outs[0], outs[1])       # byte-identical repeats
        assert torch.equal(outs[0], outs[2])       # layouts agree bit for bit
        assert outs[0].stride() == token[0].stride()
        valid = torch.tensor(q_seg >= 0, device=dev)
        err = (outs[0].float() - ref.float())[:, valid].abs().max().item()
        assert err < TOL, (h, kvl, d, err)
        assert bool((outs[0][:, ~valid] == 0).all())   # pads see nothing
