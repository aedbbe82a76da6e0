"""The Mamba2 chunk scan's backward (``kernels.mamba_scan``) on the CPU.

* ``mamba_chunk_scan_bwd``'s plain version (autograd through the plain
  scan, chunks of 64) against ``jax.grad`` of the reference's jnp scan
  (``repro.kernels.mamba_scan.ref.mamba_scan_ref``, the recurrence that
  ``mamba2_chunked``'s chunk step computes chunk by chunk) on two ragged
  shapes, rows padded for JAX with dt = 0 (no decay, no contribution):
  every gradient within 1e-4 of the largest |value| (both fp32: the sums
  run in another order, the sequential recurrence against the chunked
  algebra).
* ``emulate_kernel``: the CUDA kernel's three passes in torch fp64, in
  its order (chunk states recomputed forward, dS carried in reverse, each
  chunk's gradients from S_in and dS alone, head and chunk parts summed
  last), against the plain backward in fp64: 1e-9 relative. The kernel
  itself cannot run here; this holds its algebra.
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
    _scan_rows, check_bwd_inputs)

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


def emulate_kernel(x, bm, cm, dt, a_log, row_start, row_len, dy):
    """``csrc/mamba_scan_bwd.cu``'s algorithm in torch (any float dtype):
    pass 1 per (row, head) recomputes each chunk's S_in forward and its dS
    in reverse; pass 2 per (chunk, head) forms every gradient of the chunk
    from them; pass 3 sums dB and dC over heads and da_log over chunks."""
    tt, h, p = x.shape
    n = bm.shape[1]
    a = -torch.exp(a_log)
    chunks = [(int(s) + c * L, min(L, int(ln) - c * L))
              for s, ln in zip(row_start.tolist(), row_len.tolist())
              for c in range(-(-int(ln) // L))]
    g = len(chunks)
    states = torch.zeros((g, h, p, n), dtype=x.dtype)
    dstates = torch.zeros_like(states)

    def chunk_of(t0, l_, hh, v, width):
        out = torch.zeros((L, width), dtype=x.dtype)
        out[:l_] = v[t0:t0 + l_] if v.dim() == 2 else v[t0:t0 + l_, hh]
        return out

    def decay_of(t0, l_, hh):
        dtl = torch.zeros(L, dtype=x.dtype)
        dtl[:l_] = dt[t0:t0 + l_, hh]
        return dtl, torch.cumsum(dtl * a[hh], 0)

    # pass 1: chunk states in order, dS in reverse, per (row, head)
    gi = 0
    for s, ln in zip(row_start.tolist(), row_len.tolist()):
        nch = -(-int(ln) // L)
        for hh in range(h):
            st = torch.zeros((p, n), dtype=x.dtype)
            for c in range(nch):
                t0, l_ = chunks[gi + c]
                dtl, lc = decay_of(t0, l_, hh)
                w = torch.exp((lc[-1] - lc).clamp(max=0)) * dtl
                states[gi + c, hh] = st
                st = torch.exp(lc[-1]) * st + (
                    w[:, None] * chunk_of(t0, l_, hh, x, p)).T @ \
                    chunk_of(t0, l_, hh, bm, n)
            ds = torch.zeros((p, n), dtype=x.dtype)
            for c in reversed(range(nch)):
                t0, l_ = chunks[gi + c]
                dtl, lc = decay_of(t0, l_, hh)
                dstates[gi + c, hh] = ds
                ds = torch.exp(lc[-1]) * ds + (
                    torch.exp(lc)[:, None] * chunk_of(t0, l_, hh, dy, p)).T \
                    @ chunk_of(t0, l_, hh, cm, n)
        gi += nch
    # pass 2: one (chunk, head) at a time
    dx = torch.zeros_like(x)
    ddt = torch.zeros_like(dt)
    dbp = torch.zeros((tt, h, n), dtype=x.dtype)
    dcp = torch.zeros_like(dbp)
    da_part = torch.zeros((g, h), dtype=x.dtype)
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    for gi, (t0, l_) in enumerate(chunks):
        for hh in range(h):
            xs, dys = chunk_of(t0, l_, hh, x, p), chunk_of(t0, l_, hh, dy, p)
            bs, cs = chunk_of(t0, l_, hh, bm, n), chunk_of(t0, l_, hh, cm, n)
            dtl, lc = decay_of(t0, l_, hh)
            s_in, ds = states[gi, hh], dstates[gi, hh]
            last = lc[-1]
            cf = torch.exp((last - lc).clamp(max=0)) * dtl
            w = torch.where(tri, torch.exp((lc[:, None] - lc[None])
                                           .clamp(max=0)), 0.0)
            gm, dxm = cs @ bs.T, dys @ xs.T
            sc, dg, vv = gm * w * dtl[None], dxm * w * dtl[None], dxm * gm * w
            sy, sx = dys @ s_in, xs @ ds
            dx[t0:t0 + l_, hh] = (sc.T @ dys + cf[:, None] * (bs @ ds.T))[:l_]
            dcp[t0:t0 + l_, hh] = (dg @ bs + torch.exp(lc)[:, None] * sy)[:l_]
            dbp[t0:t0 + l_, hh] = (dg.T @ cs + cf[:, None] * sx)[:l_]
            colv = vv.sum(0)
            ud = torch.exp((last - lc).clamp(max=0)) * (bs * sx).sum(1)
            dlc = (vv * dtl[None]).sum(1) - colv * dtl + \
                torch.exp(lc) * (cs * sy).sum(1) - ud * dtl
            dlc[l_ - 1] += torch.exp(last) * (ds * s_in).sum() + \
                (ud * dtl).sum()
            dl = torch.flip(torch.cumsum(torch.flip(dlc, [0]), 0), [0])
            ddt[t0:t0 + l_, hh] = (colv + ud + dl * a[hh])[:l_]
            da_part[gi, hh] = (dl * dtl).sum()
    # pass 3
    return dx, dbp.sum(1), dcp.sum(1), ddt, da_part.sum(0) * a


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
