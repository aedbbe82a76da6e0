"""The Mamba2 chunk scan's backward (``kernels.mamba_scan``) on the CPU.

* ``mamba_chunk_scan_bwd``'s plain version (autograd through the plain
  scan, chunks of 64) against ``jax.grad`` of the reference's jnp scan
  (``repro.kernels.mamba_scan.ref.mamba_scan_ref``, the recurrence that
  ``mamba2_chunked``'s chunk step computes chunk by chunk) on two ragged
  shapes, rows padded for JAX with dt = 0 (no decay, no contribution):
  every gradient within 1e-4 of the largest |value| (both fp32: the sums
  run in another order, the sequential recurrence against the chunked
  algebra).
* ``emulate_kernel``: the CUDA kernel's two launches in torch, in its
  order (chunk-local U_c and the forward state chain; chunks of a row in
  reverse, chunk-local V_c and the reverse dS chain, each chunk's
  gradients from S_in and dS alone, dB and dC summed over head groups in
  a fixed order, then the groups and da_log's chunk parts), against the
  plain backward in fp64: 1e-9 relative; with every fp32 tensor-core
  operand as a bf16 hi + lo pair at zamba2's widths, within the card's
  tolerance. The kernel itself cannot run here; this holds its algebra
  and its rounding.
* ``bwd_plan`` and a Python mirror of the device-side work rule
  (``bwd_items``): grids, head groups, scratch and the reverse ticket
  order at each P = N. The CUDA mapping itself (``find_unit``) runs only
  on the card: ``chip_smoke.py`` phase 2c holds it on many-row cases.
* The training entry (``mamba_chunk_scan_train``, an autograd Function)
  on the CPU gives the plain gradients, refuses an initial state, and the
  kernel's input checks refuse what the kernel does not take.
* ``cuda``-marked: the kernel against the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_chunk_scan_bwd, mamba_chunk_scan_bwd_plain, mamba_chunk_scan_train)
from repro_torch.kernels.mamba_scan.kernel import (  # noqa: E402
    HEAD_GROUP, STATE_UNIT, ZERO_TILE, _scan_rows, bwd_plan,
    check_bwd_inputs)

L = 64
# (row_start, row_len, TT, H, P, N): ragged rows with a gap, an empty row
# and a one-token row; then a zamba2-width head (P = N = 64) over rows
# longer than a chunk
SHAPES = [
    ([0, 130, 140, 204, 290], [130, 0, 64, 70, 1], 300, 3, 16, 16),
    ([0, 150], [150, 97], 256, 2, 64, 64),
]
NAMES = ("dx", "dbm", "dcm", "ddt", "da_log")


def _inputs(shape, seed, dtype=torch.float32):
    starts, lens, tt, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tt, h, p)).astype(np.float32)
    bm = 0.5 * rng.standard_normal((tt, n)).astype(np.float32)
    cm = 0.5 * rng.standard_normal((tt, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((tt, h)))).astype(np.float32)
    a_log = 0.5 * rng.standard_normal(h).astype(np.float32)
    dy = rng.standard_normal((tt, h, p)).astype(np.float32)
    t = [torch.from_numpy(v).to(dtype) for v in (x, bm, cm, dt, a_log)]
    rows = [torch.tensor(v, dtype=torch.int32) for v in (starts, lens)]
    return (*t, *rows, torch.from_numpy(dy).to(dtype))


def _jax_grads(x, bm, cm, dt, a_log, starts, lens, dy):
    """jax.grad of mamba_scan_ref over the rows, each padded to the
    longest with dt = 0, scattered back to the stream."""
    tmax = max(int(v) for v in lens)
    r = len(lens)
    idx = np.zeros((r, tmax), np.int64)
    valid = np.zeros((r, tmax), bool)
    for i, (s, ln) in enumerate(zip(starts.tolist(), lens.tolist())):
        idx[i, :ln] = np.arange(s, s + ln)
        valid[i, :ln] = True

    def rows(v):
        g = jnp.asarray(v)[idx]
        return g * jnp.asarray(valid).reshape(r, tmax, *(1,) * (g.ndim - 2))

    def f(x, bm, cm, dt, a_log):
        y = mamba_scan_ref(rows(x), rows(bm), rows(cm), rows(dt), a_log)
        return jnp.sum(y * rows(dy.numpy()))

    g = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v.numpy()) for v in (x, bm, cm, dt, a_log)))
    return [torch.from_numpy(np.array(v)) for v in g]


@pytest.mark.parametrize("shape", SHAPES, ids=["ragged-P16", "ragged-P64"])
def test_plain_backward_matches_jax_grad(shape):
    args = _inputs(shape, 0)
    ours = mamba_chunk_scan_bwd(*args)
    theirs = _jax_grads(*args)
    for name, a, b in zip(NAMES, ours, theirs):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, name
    starts, lens = args[5], args[6]
    inside = np.zeros(shape[2], bool)
    for s, ln in zip(starts.tolist(), lens.tolist()):
        inside[s:s + ln] = True
    assert torch.equal(ours[0][torch.from_numpy(~inside)],
                       torch.zeros_like(ours[0][torch.from_numpy(~inside)]))


def _split(v, tc):
    """An fp32 tensor-core operand as the kernel multiplies it: a bf16 hi +
    lo pair when ``tc``, else the value itself and 0 (the algebra alone)."""
    if not tc:
        return v, torch.zeros_like(v)
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi, (v - hi).to(torch.bfloat16).to(v.dtype)


def _mm(a, b, tc, split_a=True, split_b=True):
    """a @ b as the kernel's wgmmas take it: hi.hi + hi.lo + lo.hi where both
    sides are fp32, two products where one side is bf16 (not split)."""
    ah, al = _split(a, tc and split_a)
    bh, bl = _split(b, tc and split_b)
    return ah @ bh + ah @ bl + al @ bh


def bwd_items(row_len, tt, h):
    """Python mirror of the backward's device-side work rule for grids of
    ``bwd_plan``'s sizes. Launch A: ticket w -> unit w // h, head w % h,
    a row's units its chunks but the last in runs of STATE_UNIT, in order
    (unit k holds chunks k STATE_UNIT ..); launch B: tickets
    below ``tiles`` zero a tile, the rest -> unit (w - tiles) // groups,
    head group (w - tiles) % groups, a row's units its chunks from the
    last. Units are numbered level by level (every row's unit 0 in row
    order, then every row's unit 1, ...), so all rows' chains advance
    together. Returns (plan, A items (row, chunk, head) or None, B items
    ("tile", k), ("chunk", row, chunk, group) or None)."""
    plan = bwd_plan(tt, len(row_len), h, 16, 16)
    nch = [-(-int(v) // L) for v in row_len]
    top = max(nch, default=0)
    units_a = [(r, k) for k in range(top) for r, n_ in enumerate(nch)
               if k < -(-(n_ - 1) // STATE_UNIT)]
    units_b = [(r, n_ - 1 - k) for k in range(top)
               for r, n_ in enumerate(nch) if k < n_]
    items_a = []
    for w in range(plan.blocks_a):
        u, head = divmod(w, h)
        items_a.append((*units_a[u], head) if u < len(units_a) else None)
    items_b = []
    for w in range(plan.blocks_b):
        if w < plan.tiles:
            items_b.append(("tile", w))
            continue
        u, grp = divmod(w - plan.tiles, plan.groups)
        items_b.append(("chunk", *units_b[u], grp) if u < len(units_b)
                       else None)
    return plan, items_a, items_b


def emulate_kernel(x, bm, cm, dt, a_log, row_start, row_len, dy, tc=False):
    """``csrc/mamba_scan_bwd.cu``'s algorithm in torch. Launch A: each
    chunk's state contribution U_c = x^T (cf B) on its own, then the
    forward chain S_in(c + 1) = exp(lc_last) S_in(c) + U_c, chunk by
    chunk. Launch B, a row's chunks in reverse: V_c = dy^T (exp(lc) C) on
    its own, the reverse chain dS(c - 1) = exp(lc_last) dS(c) + V_c, and
    every gradient of the chunk from S_in and dS; dB and dC summed over
    each group of HEAD_GROUP heads, then the groups summed in order and
    da_log over chunks (the last blocks' sums). With ``tc`` every fp32
    tensor-core operand enters as a bf16 hi + lo pair (``_mm``); the
    products run in the inputs' float dtype (or fp32 for bf16 inputs) and
    dx, dB, dC come back in the inputs' dtypes."""
    dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    xf, bf, cf_ = (v.to(dtype) for v in (x, bm, cm))
    dt, a_log, dy = (v.to(dtype) for v in (dt, a_log, dy))
    tt, h, p = x.shape
    n = bm.shape[1]
    a = -torch.exp(a_log)
    plan = bwd_plan(tt, len(row_len), h, p, n)
    tri = torch.ones((L, L), dtype=torch.bool).tril()

    def chunk(v, t0, l_):
        out = v.new_zeros((L, *v.shape[1:]))
        out[:l_] = v[t0:t0 + l_]
        return out

    def decay(t0, l_):
        dtl = chunk(dt, t0, l_).T                      # (H, L)
        lc = torch.cumsum(dtl * a[:, None], 1)
        last = lc[:, -1:]
        return dtl, lc, last, torch.exp((last - lc).clamp(max=0))

    rows = []
    g = 0
    for s, ln in zip(row_start.tolist(), row_len.tolist()):
        k = -(-int(ln) // L)
        rows.append([(g + c, int(s) + c * L, min(L, int(ln) - c * L))
                     for c in range(k)])
        g += k
    # launch A
    states = {}
    for chunks in rows:
        st = None
        for gi, t0, l_ in chunks[:-1]:
            dtl, lc, last, dec = decay(t0, l_)
            xs = chunk(xf, t0, l_).permute(1, 2, 0)    # (H, P, L)
            u = _mm(xs, (dec * dtl)[..., None] * chunk(bf, t0, l_), tc,
                    split_a=False)
            st = u if st is None else torch.exp(last)[..., None] * st + u
            states[gi + 1] = st
    # launch B
    dx = torch.zeros((tt, h, p), dtype=dtype)
    ddt = torch.zeros((tt, h), dtype=dtype)
    parts = torch.zeros((2, tt, plan.groups, n), dtype=dtype)
    da_part = torch.zeros((plan.chunks, h), dtype=dtype)
    for chunks in rows:
        carry = torch.zeros((h, p, n), dtype=dtype)
        for gi, t0, l_ in reversed(chunks):
            dtl, lc, last, dec = decay(t0, l_)
            cf = dec * dtl
            el = torch.exp(lc)
            xs = chunk(xf, t0, l_).transpose(0, 1)     # (H, L, P)
            dys = chunk(dy, t0, l_).transpose(0, 1)
            bs, cs = chunk(bf, t0, l_), chunk(cf_, t0, l_)
            v = _mm(dys.transpose(1, 2), el[..., None] * cs, tc)
            ds = carry
            carry = torch.exp(last)[..., None] * ds + v
            s_in = states.get(gi, torch.zeros_like(ds))
            dot = (ds * s_in).sum((1, 2))
            gm = cs @ bs.T                             # exact: bf16 inputs
            w = torch.where(tri, torch.exp((lc[:, :, None] - lc[:, None])
                                           .clamp(max=0)), 0.0)
            dm = _mm(dys, xs.transpose(1, 2), tc, split_b=False)
            dg = dm * w * dtl[:, None]
            vv = dm * gm * w
            rowq = (vv * dtl[:, None]).sum(2)
            colv = vv.sum(1)
            score = gm * w * dtl[:, None]
            sx = _mm(xs, ds, tc, split_a=False)
            uu = (bs * sx).sum(2)
            db = cf[..., None] * sx + _mm(dg.transpose(1, 2), cs, tc,
                                          split_b=False)
            bd = _mm(bs, ds.transpose(1, 2), tc, split_a=False)
            dxc = cf[..., None] * bd + _mm(score.transpose(1, 2), dys, tc)
            sy = _mm(dys, s_in, tc)
            rr = el * (cs * sy).sum(2)
            dc = el[..., None] * sy + _mm(dg, bs, tc, split_b=False)
            dlc = rowq - colv * dtl + rr - cf * uu
            dlc[:, l_ - 1] += torch.exp(last[:, 0]) * dot + (cf * uu).sum(1)
            run = torch.flip(torch.cumsum(torch.flip(dlc, [1]), 1), [1])
            da_part[gi] = (run * dtl).sum(1)
            dx[t0:t0 + l_] = dxc.transpose(0, 1)[:l_]
            ddt[t0:t0 + l_] = (colv + dec * uu + a[:, None] * run).T[:l_]
            for k in range(plan.groups):
                hs = slice(k * HEAD_GROUP, (k + 1) * HEAD_GROUP)
                parts[0, t0:t0 + l_, k] = db[hs].sum(0)[:l_]
                parts[1, t0:t0 + l_, k] = dc[hs].sum(0)[:l_]
    dbm, dcm = parts.sum(2)
    return (dx.to(x.dtype), dbm.to(bm.dtype), dcm.to(cm.dtype), ddt,
            da_part.sum(0) * a)


@pytest.mark.parametrize("shape", SHAPES[:1], ids=["ragged-P16"])
def test_kernel_algorithm_matches_plain_backward(shape):
    args = _inputs(shape, 1, torch.float64)
    ours = emulate_kernel(*args)
    leaves = [v.clone().requires_grad_(True) for v in args[:5]]
    tt, h, p = args[0].shape
    s0 = torch.zeros((len(args[5]), h, p, args[1].shape[1]),
                     dtype=torch.float64)
    y = torch.zeros((tt, h, p), dtype=torch.float64)
    for r, (s, ln) in enumerate(zip(args[5].tolist(), args[6].tolist())):
        if ln == 0:
            continue
        t = -(-ln // L) * L

        def rows(v):
            g = v[s:s + ln]
            return torch.cat([g, g.new_zeros((t - ln, *g.shape[1:]))])[None]

        yr, _ = _scan_rows(rows(leaves[0]), rows(leaves[1]), rows(leaves[2]),
                           rows(leaves[3]), -torch.exp(leaves[4]),
                           s0[r:r + 1], L)
        y = y.index_put((torch.arange(s, s + ln),), yr[0, :ln])
    theirs = torch.autograd.grad(y, leaves, args[7])
    for name, a, b in zip(NAMES, ours, theirs):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max()), \
            name


# (row_start, row_len, TT, H, P, N): zamba2-1.2b's widths (H = P = N = 64)
# on two 1024-token rows and on ragged rows (an empty one, a one-token one,
# rows ending mid-chunk, gaps); P = N = 32 with H 6 (a last head group of
# 2); the reduced configs' widths (H 8, P = N = 16)
EMULATED_BWD = {
    "zamba2 widths 2 x 1024": ([0, 1024], [1024, 1024], 2048, 64, 64, 64),
    "zamba2 widths ragged": ([0, 300, 301, 700, 1800],
                             [300, 0, 1, 1000, 47], 1900, 64, 64, 64),
    "P=N=32 H=6 ragged": ([0, 70, 200], [70, 129, 0], 330, 6, 32, 32),
    "reduced P=N=16 H=8": ([0, 256, 406, 407, 407, 467],
                           [256, 150, 1, 0, 60, 45], 512, 8, 16, 16),
}
# chip_smoke.py's MAMBA_BWD_TOL: bf16 gradients (dx, dB, dC) within 2^-7,
# fp32 ones (ddt, da_log) within 1e-4 of the largest |value|
BWD_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


@pytest.mark.parametrize("case", list(EMULATED_BWD))
def test_tensor_core_rounding_fits_card_tolerance(case):
    """The emulated kernel with every fp32 tensor-core operand as a bf16
    hi + lo pair (dy, the scores, dG, S_in, dS, cf B, exp(lc) C; x, B and
    C exact) against the plain backward: each gradient within the card's
    tolerance (BWD_TOL) of the largest |value|, 0 outside every row. ddt,
    whose terms cancel, stays within 1e-4 with its products on the tensor
    cores (measured ~3e-6), so no sum of it moves to the CUDA cores."""
    shape = EMULATED_BWD[case]
    args = list(_inputs(shape, 5))
    args[:3] = [v.to(torch.bfloat16) for v in args[:3]]
    ours = emulate_kernel(*args, tc=True)
    want = mamba_chunk_scan_bwd_plain(*args)
    for name, a, b in zip(NAMES, ours, want):
        assert a.dtype == b.dtype, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[a.dtype] * b.float().abs().max().item(), \
            (name, err)
    inside = np.zeros(shape[2], bool)
    for s, ln in zip(shape[0], shape[1]):
        inside[s:s + ln] = True
    out = torch.from_numpy(~inside)
    for name, a in zip(NAMES[:4], ours[:4]):
        assert (a[out] == 0).all(), name


@pytest.mark.parametrize("p", [16, 32, 64])
@pytest.mark.parametrize("tt,h,lens", [
    (4096, 64, [2048, 2048]),                  # zamba2's training shape
    (1900, 64, [300, 0, 1, 1000, 47, 0]),      # ragged, rows past the end
    (512, 8, [256, 150, 1, 0, 60, 45]),        # reduced heads
    (330, 6, [70, 129, 0]),                    # a last group of 2 heads
    (128, 5, [0, 0]),                          # no token in any row
    (1600, 8, [23 * i % 65 for i in range(48)]),   # 48 rows of one chunk
])
def test_launch_plan(p, tt, h, lens):
    """``bwd_plan``'s grids, head groups and scratch, and the work rule on
    them, as ``bwd_items`` mirrors the kernel's ``find_unit`` in Python
    (the mirror, not the CUDA code, runs here): launch A gives every (row,
    unit of
    STATE_UNIT chunks, head) over a row's chunks but its last one block, a
    unit's predecessor the smaller ticket; launch B gives every
    ZERO_TILE-token tile one block and every (row, chunk, head group) one
    block, a row's chunks in reverse (a chunk's successor the smaller
    ticket: the order the reverse chain
    waits in), within grids sized from TT // 64 + R; the rows' chunks
    interleave level by level (the second row's first unit comes before
    the first row's second)."""
    r = len(lens)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    assert starts[-1] + lens[-1] <= tt
    plan = bwd_plan(tt, r, h, p, p)
    groups = plan.groups
    # every head in a group, no group empty; every token in a zeroing tile
    assert (groups - 1) * HEAD_GROUP < h <= groups * HEAD_GROUP
    assert (plan.tiles - 1) * ZERO_TILE < tt <= plan.tiles * ZERO_TILE
    # a state tile and a da_log part per chunk, a dS slot per (row, head),
    # a dB and a dC part per (token, group)
    assert plan.states == (plan.chunks, h, p, p)
    assert plan.carry == (r, h, p, p)
    assert plan.parts == (2, tt, groups, p)
    assert plan.da_part == (plan.chunks, h)
    _, items_a, items_b = bwd_items(lens, tt, h)
    nch = [-(-v // L) for v in lens]
    units = [-(-max(0, k - 1) // STATE_UNIT) for k in nch]
    assert sum(nch) <= plan.chunks and sum(units) * h <= plan.blocks_a
    got = [i for i in items_a if i is not None]
    want = {(ri, u, hh) for ri, k in enumerate(units) for u in range(k)
            for hh in range(h)}
    assert len(got) == len(set(got)) and set(got) == want
    ticket = {i: w for w, i in enumerate(items_a) if i is not None}
    for (ri, c, hh), w in ticket.items():
        if c > 0:
            assert ticket[(ri, c - 1, hh)] < w
    got = [i for i in items_b if i is not None]
    want = {("chunk", ri, c, k) for ri, n_ in enumerate(nch)
            for c in range(n_) for k in range(groups)}
    want |= {("tile", k) for k in range(plan.tiles)}
    assert len(got) == len(set(got)) and set(got) == want
    ticket = {i: w for w, i in enumerate(items_b) if i is not None}
    for (kind, *rest), w in ticket.items():
        if kind == "chunk" and rest[1] + 1 < nch[rest[0]]:
            ri, c, k = rest
            assert ticket[("chunk", ri, c + 1, k)] < w
    if sum(v > L for v in lens[:2]) == 2:
        assert ticket[("chunk", 1, nch[1] - 1, 0)] < \
            ticket[("chunk", 0, nch[0] - 2, 0)]


def test_training_entry_gives_the_plain_gradients():
    shape = ([0, 100], [100, 60], 160, 2, 16, 16)
    x, bm, cm, dt, a_log, rs, rl, dy = _inputs(shape, 2)
    xb, bb, cb = (v.to(torch.bfloat16).requires_grad_(True)
                  for v in (x, bm, cm))
    dtg, ag = dt.clone().requires_grad_(True), a_log.clone().requires_grad_()
    y = mamba_chunk_scan_train(xb, bb, cb, dtg, ag, rs, rl)
    assert y.dtype == torch.float32 and y.shape == (160, 2, 16)
    y.backward(dy)
    want = mamba_chunk_scan_bwd_plain(xb.detach(), bb.detach(), cb.detach(),
                                      dt, a_log, rs, rl, dy)
    for name, got, w in zip(NAMES, (xb.grad, bb.grad, cb.grad, dtg.grad,
                                    ag.grad), want):
        assert got.dtype == w.dtype and torch.equal(got, w), name
    with pytest.raises(ValueError):
        mamba_chunk_scan_train(xb, bb, cb, dtg, ag, rs, rl,
                               init_state=torch.zeros((2, 2, 16, 16)))


def test_kernel_input_checks():
    shape = ([0, 100], [100, 60], 160, 2, 16, 16)
    x, bm, cm, dt, a_log, rs, rl, dy = _inputs(shape, 3)
    xb, bb, cb = (v.to(torch.bfloat16) for v in (x, bm, cm))
    assert check_bwd_inputs(xb, bb, cb, dt, a_log, rs, rl, dy) == \
        (160, 2, 2, 16, 16)
    with pytest.raises(ValueError):               # P != N
        check_bwd_inputs(xb, bb[:, :8].repeat(1, 4), cb[:, :8].repeat(1, 4),
                         dt, a_log, rs, rl, dy)
    with pytest.raises(TypeError):                # dy in bf16
        check_bwd_inputs(xb, bb, cb, dt, a_log, rs, rl, dy.bfloat16())
    with pytest.raises(ValueError):               # dy not contiguous
        check_bwd_inputs(xb, bb, cb, dt, a_log, rs, rl,
                         dy.transpose(0, 1).contiguous().transpose(0, 1))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for shape in SHAPES:
        x, bm, cm, dt, a_log, rs, rl, dy = (
            v.to(dev) for v in _inputs(shape, 4))
        args = (x.bfloat16(), bm.bfloat16(), cm.bfloat16(), dt, a_log, rs,
                rl, dy)
        got = mamba_chunk_scan_bwd(*args)
        again = mamba_chunk_scan_bwd(*args)
        want = mamba_chunk_scan_bwd_plain(*args)
        for name, a, b, c in zip(NAMES, got, again, want):
            assert torch.equal(a, b), name
            tol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4
            assert float((a.float() - c.float()).abs().max()) <= \
                tol * float(c.float().abs().max()), name
