"""The Mamba2 chunk-scan kernel's plain PyTorch version and the port's
Mamba2 blocks and state storage against the JAX package, on the CPU.

* ``mamba_chunk_scan`` (plain) against the Pallas kernel in interpret mode
  and the token-sequential oracle ``mamba_scan_ref``, on the cases of
  ``test_kernels_flash_mamba.py``: 2e-4 abs / 2e-3 rel, that test's own
  bound (fp32 chunked vs sequential sums);
* ``mamba_chunk_scan_varlen`` (plain) against a token-sequential numpy
  recurrence with non-zero initial states, ragged rows, a zero-length row
  and rows that start mid-stream: 2e-4 abs / 2e-3 rel, the same bound;
* ``mamba2_chunked`` and ``mamba2_packed`` (the SSD through the varlen
  scan) against JAX's on the same weights, states and streams: the
  padded rows with a non-zero init_state and ragged last_idx; the packed
  stream with killed (-1) segments, a segment that owns no token and
  segments that straddle JAX's 128-token chunk. Outputs within 2 bf16 ulps
  of the largest |output| (the bf16 residual sum after fp32 sums taken in
  another order: JAX chunks the stream at 128, the port each row at 64);
  final SSM states within 1e-5 of the largest |state| (fp32, reordered);
  conv states equal (they are the bf16 projection inputs);
* the bf16-pair state storage bit for bit against JAX, and
  ``read_state`` / ``write_state`` on the same buffer bytes (eid -1
  reads zeros; its write lands on the scratch page, which JAX drops);
* the wrapper's input checks; a ``cuda``-marked kernel-vs-plain test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import get_model  # noqa: E402
from repro.kernels.mamba_scan.kernel import \
    mamba_chunk_scan as jax_kernel  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks_seq as JBS  # noqa: E402
from repro.models.tp import shard_map, single_device_dist  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_chunk_scan, mamba_chunk_scan_plain, mamba_chunk_scan_varlen,
    mamba_chunk_scan_varlen_plain)
from repro_torch.kernels.mamba_scan.kernel import (  # noqa: E402
    CHUNK, ZERO_TILE, check_inputs, scan_blocks)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks_seq as BS  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.lm import unstack  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402

ARCH = "zamba2-1.2b"
SCAN_TOL = dict(atol=2e-4, rtol=2e-3)


def t(a):
    return tensor_from_numpy(np.asarray(a))


def scan_inputs(seed, tt, h, p, n):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((tt, h, p)).astype(np.float32),
            0.5 * rng.standard_normal((tt, n)).astype(np.float32),
            0.5 * rng.standard_normal((tt, n)).astype(np.float32),
            (0.1 + 0.5 * rng.random((tt, h))).astype(np.float32),
            (0.3 * rng.standard_normal(h)).astype(np.float32))


@pytest.mark.parametrize("b,t_,h,p,n,chunk", [
    (1, 128, 2, 16, 16, 32),
    (2, 64, 1, 32, 16, 16),
    (1, 256, 4, 64, 64, 64),
])
def test_plain_scan_matches_pallas_and_oracle(b, t_, h, p, n, chunk):
    x, bm, cm, dt, a_log = scan_inputs(2, b * t_, h, p, n)
    x, dt = x.reshape(b, t_, h, p), dt.reshape(b, t_, h)
    bm, cm = bm.reshape(b, t_, n), cm.reshape(b, t_, n)
    args = (x, bm, cm, dt, a_log)
    ours = mamba_chunk_scan(*(t(a) for a in args), chunk=chunk)
    assert ours.dtype == torch.float32 and ours.shape == (b, t_, h, p)
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jax_kernel(*jargs, chunk=chunk,
                                            interpret=True)), **SCAN_TOL)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(mamba_scan_ref(*jargs)), **SCAN_TOL)


def sequential_rows(x, bm, cm, dt, a_log, starts, lens, s0):
    """Token-sequential recurrence per row (numpy, fp64): S <- S
    exp(-dt e^{A}) + dt x B^T; y = C . S."""
    y = np.zeros(x.shape, np.float64)
    s = s0.astype(np.float64).copy()
    rate = -np.exp(a_log.astype(np.float64))
    for r, (st, ln) in enumerate(zip(starts, lens)):
        for i in range(st, st + ln):
            dec = np.exp(dt[i] * rate)                         # (H,)
            s[r] = s[r] * dec[:, None, None] + np.einsum(
                "h,hp,n->hpn", dt[i], x[i], bm[i])
            y[i] = np.einsum("n,hpn->hp", cm[i], s[r])
    return y, s


def test_plain_varlen_matches_sequential_rows():
    """Ragged rows with non-zero initial states, one of length 0, one that
    spans three 64-token chunks, rows that start mid-stream and tokens
    that belong to no row (y exactly 0 there)."""
    h, p, n = 3, 16, 16
    x, bm, cm, dt, a_log = scan_inputs(3, 300, h, p, n)
    starts = np.array([0, 37, 37, 200, 299], np.int32)
    lens = np.array([30, 150, 0, 99, 1], np.int32)
    rng = np.random.default_rng(4)
    s0 = rng.standard_normal((5, h, p, n)).astype(np.float32)
    y, s = mamba_chunk_scan_varlen(*(t(a) for a in (x, bm, cm, dt, a_log,
                                                     starts, lens, s0)))
    ry, rs = sequential_rows(x, bm, cm, dt, a_log, starts, lens, s0)
    np.testing.assert_allclose(y.numpy(), ry, **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), rs, **SCAN_TOL)
    assert torch.equal(s[2], t(s0[2]))                 # length 0: unchanged
    assert (y[30:37] == 0).all() and (y[187:200] == 0).all()


def test_wrapper_takes_plain_version_on_cpu_only():
    h, p, n = 2, 16, 16
    x, bm, cm, dt, a_log = (t(a) for a in scan_inputs(5, 40, h, p, n))
    rows = (t(np.array([0, 20], np.int32)), t(np.array([20, 13], np.int32)))
    s0 = torch.zeros((2, h, p, n))
    before = mamba_chunk_scan_varlen.launches
    y, s = mamba_chunk_scan_varlen(x, bm, cm, dt, a_log, *rows, s0)
    assert mamba_chunk_scan_varlen.launches == before     # no kernel here
    ry, rs = mamba_chunk_scan_varlen_plain(x, bm, cm, dt, a_log, *rows, s0)
    assert torch.equal(y, ry) and torch.equal(s, rs)
    yb = mamba_chunk_scan(x.view(2, 20, h, p), bm.view(2, 20, n),
                          cm.view(2, 20, n), dt.view(2, 20, h), a_log,
                          chunk=4)
    assert torch.equal(yb, mamba_chunk_scan_plain(
        x.view(2, 20, h, p), bm.view(2, 20, n), cm.view(2, 20, n),
        dt.view(2, 20, h), a_log, chunk=4))
    with pytest.raises(ValueError):
        mamba_chunk_scan(x.view(2, 20, h, p), bm.view(2, 20, n),
                         cm.view(2, 20, n), dt.view(2, 20, h), a_log,
                         chunk=16)
    with pytest.raises(ValueError):
        mamba_chunk_scan_varlen(*(a.to("meta") for a in (
            x, bm, cm, dt, a_log, *rows, s0)))


def test_check_inputs_rejects_what_the_kernel_does_not_take():
    h, p, n, tt = 4, 64, 64, 24
    x, bm, cm, dt, a_log = (t(a) for a in scan_inputs(6, tt, h, p, n))
    x, bm, cm = (a.to(torch.bfloat16) for a in (x, bm, cm))
    rs, rl = t(np.array([0, 10], np.int32)), t(np.array([10, 14], np.int32))
    s0 = torch.zeros((2, h, p, n))
    assert check_inputs(x, bm, cm, dt, a_log, rs, rl, s0) == (tt, 2, h, p, n)
    # views the serve path passes: x, B and C sliced out of one xbc row
    xbc = torch.zeros((tt, h * p + 2 * n), dtype=torch.bfloat16)
    xs = xbc[:, :h * p].view(tt, h, p)
    bs, cs = xbc[:, h * p:h * p + n], xbc[:, h * p + n:]
    flat = torch.zeros((2, h * p * n + 100))
    s0v = flat[:, :h * p * n].view(2, h, p, n)
    assert check_inputs(xs, bs, cs, dt, a_log, rs, rl, s0v)[0] == tt
    bad = [
        (x.float(), bm, cm, dt, a_log, rs, rl, s0),            # dtype
        (x, bm, cm, dt.to(torch.bfloat16), a_log, rs, rl, s0),
        (x.transpose(1, 2).contiguous().transpose(1, 2), bm, cm, dt, a_log,
         rs, rl, s0),                                          # strided x
        (x, bm, cm[:, :32], dt, a_log, rs, rl, s0),            # shape
        (x, bm, cm.t().contiguous().t(), dt, a_log, rs, rl, s0),
        (x, bm, cm, dt, a_log, rs.long(), rl, s0),             # int64
        (x, bm, cm, dt, a_log, rs, rl[:1], s0),                # rows
        (x, bm, cm, dt, a_log, rs, rl, s0.transpose(2, 3)),    # state
        (x[..., :48], bm, cm, dt, a_log, rs, rl, s0[..., :48, :]),  # P 48
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            check_inputs(*args)


# --------------------------------------------------------------- blocks
def _layer(idx=0):
    """(JAX layer params with tp squeezed, port layer params, md, cfg)."""
    model, jcfg, jparams = get_model(ARCH)
    cfg = reduced(ARCHS[ARCH])
    sq = model._squeeze_params(jparams)["mamba_main"]
    jp = jax.tree.map(lambda a: a[idx], sq)
    pp = unstack(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")["mamba_main"])[idx]
    return jp, pp, model.md, cfg


def jrun(fn, *args, **kw):
    """A JAX block under ``shard_map`` on the one-device mesh (its tp
    psums need the "model" axis), every input and output replicated."""
    dist = single_device_dist()
    spec = jax.sharding.PartitionSpec()
    body = shard_map(lambda *a: fn(*a, dist=dist, **kw), mesh=dist.mesh,
                     in_specs=(spec,) * len(args), out_specs=spec)
    return jax.jit(body)(*args)


def _kw(cfg):
    return dict(d_state=cfg.mamba_d_state, headdim=cfg.mamba_headdim,
                conv_width=cfg.mamba_conv_width, norm_eps=cfg.norm_eps)


def _states(rng, n, md, cfg):
    """Finite fp32 entry states whose conv part is bf16-representable (it
    is stored from bf16 projection inputs)."""
    ssm = 0.3 * rng.standard_normal((n, md["ssm_units"]))
    conv = 0.5 * rng.standard_normal((n, md["conv_units"]))
    conv = np.asarray(jnp.asarray(conv, jnp.bfloat16).astype(jnp.float32))
    return np.concatenate([ssm, conv], axis=1).astype(np.float32)


def _x(rng, shape):
    return np.asarray(jnp.asarray(0.5 * rng.standard_normal(shape),
                                  jnp.bfloat16))


def _close_out(ours, ref, rows):
    a = ours.float().numpy()[rows]
    b = np.asarray(ref, np.float32)[rows]
    tol = 2 * 2.0 ** -8 * np.abs(b).max()
    assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


def _close_state(ours, ref, md):
    a, b = ours.numpy(), np.asarray(ref)
    n = md["ssm_units"]
    assert np.abs(a[:, :n] - b[:, :n]).max() <= 1e-5 * np.abs(b[:, :n]).max()
    assert np.array_equal(a[:, n:], b[:, n:])


@pytest.mark.parametrize("t_", [5, 150])
def test_mamba2_chunked_matches_jax(t_):
    """Padded rows (T > 1 serving): non-zero init_state, ragged last_idx,
    a pad row of one token; T = 150 straddles JAX's 128-token chunk."""
    jp, pp, md, cfg = _layer(1)
    rng = np.random.default_rng(t_)
    b = 4
    x = _x(rng, (b, t_, cfg.d_model))
    st = _states(rng, b, md, cfg)
    last = np.array([t_ - 1, t_ // 2, 0, max(0, t_ - 3)], np.int32)
    lmask = np.arange(t_)[None] <= last[:, None]
    out, state = jrun(
        lambda p, x, s, m, li, dist: JBS.mamba2_chunked(
            p, x, dist, md, init_state=s, length_mask=m, last_idx=li,
            **_kw(cfg)),
        jp, jnp.asarray(x), jnp.asarray(st), jnp.asarray(lmask),
        jnp.asarray(last))
    ours, ostate = BS.mamba2_chunked(
        pp, t(x), md, init_state=t(st), length_mask=t(lmask),
        last_idx=t(last), **_kw(cfg))
    _close_out(ours, out, lmask)
    _close_state(ostate, state, md)


def packed_stream(tt, segs):
    """(seg_ids, seg_start, seg_last) of a stream holding segments of the
    given lengths back to back (pads after them); a length of 0 is a pad
    segment, a negative length a segment of that many tokens killed in
    flight (its tokens re-tagged -1)."""
    seg_ids = np.full((tt,), -1, np.int32)
    seg_start = np.zeros((tt,), np.int32)
    seg_last = np.zeros((len(segs),), np.int32)
    off = 0
    for si, n in enumerate(segs):
        if n == 0:
            continue
        k = abs(n)
        seg_ids[off:off + k] = si if n > 0 else -1
        seg_start[off:off + k] = off
        seg_last[si] = off + k - 1
        off += k
    return seg_ids, seg_start, seg_last


@pytest.mark.parametrize("segs,tt", [
    ((100, 60, 1, -20, 90, 0, 1, 7), 288),    # straddles 128, killed, pad
    ((1, 1, -1, 1, 1, 0, 0, 0), 8),           # decode-only step
    ((250,), 256),                            # one long chunk
])
def test_mamba2_packed_matches_jax(segs, tt):
    jp, pp, md, cfg = _layer(2)
    rng = np.random.default_rng(len(segs) + tt)
    seg_ids, seg_start, seg_last = packed_stream(tt, segs)
    x = _x(rng, (1, tt, cfg.d_model))
    st = _states(rng, len(segs), md, cfg)
    out, state = jrun(
        lambda p, x, si, ss, sl, s, dist: JBS.mamba2_packed(
            p, x, dist, md, seg_ids=si, seg_start=ss, seg_last=sl,
            init_state=s, **_kw(cfg)),
        jp, jnp.asarray(x), *(jnp.asarray(a) for a in (
            seg_ids, seg_start, seg_last, st)))
    seg = dict(seg_ids=t(seg_ids), seg_start=t(seg_start),
               seg_last=t(seg_last))
    meta = BS.packed_meta(**seg, conv_width=cfg.mamba_conv_width)
    assert meta["row_len"].tolist() == [max(n, 0) for n in segs]
    ours, ostate = BS.mamba2_packed(pp, t(x), md, init_state=t(st), **seg,
                                    **_kw(cfg))
    _close_out(ours[0], np.asarray(out)[0], seg_ids >= 0)
    _close_state(ostate, state, md)
    n = md["ssm_units"]
    for si, ln in enumerate(segs):            # no token: state unchanged
        if ln <= 0:
            assert torch.equal(ostate[si, :n], t(st[si, :n]))


def test_mamba2_step_matches_jax():
    jp, pp, md, cfg = _layer(3)
    rng = np.random.default_rng(9)
    x = _x(rng, (3, 1, cfg.d_model))
    st = _states(rng, 3, md, cfg)
    out, state = jrun(
        lambda p, x, s, dist: JBS.mamba2_step(p, x, s, dist, md,
                                              **_kw(cfg)),
        jp, jnp.asarray(x), jnp.asarray(st))
    ours, ostate = BS.mamba2_step(pp, t(x), t(st), md, **_kw(cfg))
    _close_out(ours, out, slice(None))
    _close_state(ostate, state, md)


# ---------------------------------------------------------------- state
def test_bf16_pairs_bit_exact_against_jax():
    """Every fp32 bit pattern (NaNs, infinities and denormals included)
    round-trips, and the pair bytes equal JAX's bitcast."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2 ** 32, (6, 34), dtype=np.uint64).astype(
        np.uint32)
    bits[0, :4] = [0x7F800000, 0xFF800001, 0x00000001, 0x80000000]
    f = bits.view(np.float32)
    jpair = np.asarray(JA.f32_to_bf16_pair(jnp.asarray(f)))
    pair = A.f32_to_bf16_pair(t(f))
    assert pair.shape == (6, 68)
    assert np.array_equal(pair.view(torch.int16).numpy(),
                          jpair.view(np.int16))
    back = A.bf16_pair_to_f32(pair)
    assert np.array_equal(back.view(torch.int32).numpy(), bits.view(np.int32))
    jback = np.asarray(JA.bf16_pair_to_f32(jnp.asarray(jpair)))
    assert np.array_equal(jback.view(np.int32), bits.view(np.int32))


def test_read_write_state_match_jax_on_the_same_bytes():
    """A (VP, L, 2U) state view over random finite buffer bytes: reads of
    live eids equal JAX's bit for bit and eid -1 reads zeros; writes equal
    JAX's on every byte but the scratch page (the view's last page),
    where the port puts the eid -1 row that JAX drops."""
    rng = np.random.default_rng(12)
    vp, nl, u = 6, 3, 10
    buf0 = rng.standard_normal(vp * nl * 2 * u).astype(np.float32)
    jbuf0 = jnp.asarray(buf0, jnp.bfloat16)
    view = (vp, nl, 2 * u)
    eids = np.array([2, -1, 0, 4], np.int32)
    state = rng.standard_normal((4, u)).astype(np.float32)
    for layer in (0, 2):
        jst = np.asarray(JA.read_state(jbuf0.reshape(view), layer,
                                       jnp.asarray(eids)))
        buf = t(np.asarray(jbuf0))
        st = A.read_state(buf.view(view), layer, t(eids))
        assert np.array_equal(st.view(torch.int32).numpy(),
                              jst.view(np.int32))
        assert (st[1] == 0).all()
        jw = np.asarray(JA.write_state(jbuf0, view, layer, jnp.asarray(eids),
                                       jnp.asarray(state)))
        A.write_state(buf, view, layer, t(eids), t(state))
        ours = buf.view(torch.int16).numpy()
        scratch = (vp - 1) * nl * 2 * u
        assert np.array_equal(ours[:scratch], jw.view(np.int16)[:scratch])
        assert np.array_equal(
            A.bf16_pair_to_f32(buf.view(view)[vp - 1, layer]).numpy(),
            state[1])


# ------------------------------------------------- the kernel's numerics
MAMBA_TOL = 1e-3    # chip_smoke.py phase 2c's: of the largest |value|


def device_items(row_len, tt, h):
    """numpy mirror of the kernel's device-side work rule for a launch of
    ``scan_blocks(tt, len(row_len), h)`` blocks: ticket w < ceil(tt /
    ZERO_TILE) zeroes tile w of y; the rest map to chunk unit u = (w -
    tiles) // h, head (w - tiles) % h, and the unit to (row, chunk) by a
    prefix sum of max(1, ceil(len / 64)) over the rows. Returns (blocks,
    items in ticket order: ("tile", k), ("chunk", r, c, head) or None for
    a block past the real count)."""
    blocks = scan_blocks(tt, len(row_len), h)
    tiles = -(-tt // ZERO_TILE)
    units = np.maximum(1, -(-np.asarray(row_len) // CHUNK))
    ends = np.cumsum(units)
    items = []
    for w in range(blocks):
        if w < tiles:
            items.append(("tile", w))
            continue
        u, head = divmod(w - tiles, h)
        r = int(np.searchsorted(ends, u, side="right"))
        items.append(None if r >= len(units) else
                     ("chunk", r, u - int(ends[r] - units[r]), head))
    return blocks, items


def _pairs(v):
    """An fp32 operand as the bf16 hi + lo pair the kernel multiplies."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def emulate_kernel(x, bm, cm, dt, a_log, row_start, row_len, s0):
    """The CUDA kernel's arithmetic, work item by work item in ticket order
    (``device_items``): C B^T per chunk and head (exact: bf16 inputs,
    fp32 sums); score @ x, (sfac x)^T B and C S^T with the
    fp32 operand as a bf16 hi + lo pair; the state chained in chunk order
    in fp32 (S_c = S_{c-1} exp(lc_last) + dS); one-token rows by the light
    path (S' = S exp(dt a) + dt x B^T, y = C . S'); zero-length rows
    copied; y zero outside every row."""
    tt, h, p = x.shape
    x, bm, cm = x.float(), bm.float(), cm.float()
    a = -torch.exp(a_log.float())
    y = torch.full((tt, h, p), float("nan"))
    s1 = torch.full(s0.shape, float("nan"))
    starts, lens = row_start.tolist(), row_len.tolist()
    _, items = device_items(lens, tt, h)
    covered = np.zeros(tt, bool)
    for st, ln in zip(starts, lens):
        covered[st:st + ln] = True
    for item in items:
        if item is None:
            continue
        if item[0] == "tile":
            k = item[1]
            for t_ in range(k * ZERO_TILE, min(tt, (k + 1) * ZERO_TILE)):
                if not covered[t_]:
                    y[t_] = 0
            continue
        _, r, c, head = item
        hs = slice(head, head + 1)
        st, ln = starts[r], lens[r]
        if ln == 0:
            s1[r, hs] = s0[r, hs]
            continue
        if ln == 1:
            d = dt[st, hs]
            s = s0[r, hs] * torch.exp(d * a[hs])[:, None, None] + \
                (d[:, None] * x[st, hs])[..., None] * bm[st]
            s1[r, hs] = s
            y[st, hs] = (s * cm[st]).sum(-1)
            continue
        cl = min(CHUNK, ln - c * CHUNK)
        tk = slice(st + c * CHUNK, st + c * CHUNK + cl)
        xc, bc, cc, dc = x[tk, hs], bm[tk], cm[tk], dt[tk, hs]
        cb = cc @ bc.T
        lc = torch.cumsum(dc * a[hs], 0)                 # (l, G)
        dec = torch.exp((lc[:, None] - lc[None]).clamp(max=0)) * dc[None]
        tri = torch.ones(cl, cl, dtype=torch.bool).tril()[..., None]
        score = torch.where(tri, cb[..., None] * dec, torch.zeros(()))
        yi = sum(torch.einsum("tsg,sgp->tgp", q, xc) for q in _pairs(score))
        sfac = torch.exp((lc[-1:] - lc).clamp(max=0)) * dc
        ds = sum(torch.einsum("sgp,sn->gpn", q, bc)
                 for q in _pairs(sfac[..., None] * xc))
        prev = (s0 if c == 0 else s1)[r, hs]
        ys = sum(torch.einsum("tn,gpn->tgp", cc, q) for q in _pairs(prev))
        y[tk, hs] = yi + torch.exp(lc)[..., None] * ys
        s1[r, hs] = prev * torch.exp(lc[-1])[:, None, None] + ds
    return y, s1


def _stream(seed, tt, h, p, n, starts, lens):
    x, bm, cm, dt, a_log = scan_inputs(seed, tt, h, p, n)
    rng = np.random.default_rng(seed + 1)
    s0 = (0.3 * rng.standard_normal((len(lens), h, p, n))).astype(np.float32)
    return [t(a) for a in (x, bm, cm, dt, a_log)] + [
        t(np.asarray(v, np.int32)) for v in (starts, lens)] + [t(s0)]


def _packed(lens):
    return np.concatenate([[0], np.cumsum(lens)[:-1]]), lens


# (tt, h, p, n, starts, lens): the serve path's layouts at reduced heads
EMULATED_SCAN = {
    "ragged, zero-length and one-token rows P=N=64": (
        330, 4, 64, 64, *_packed([150, 1, 0, 37, 2, 64, 70, 1])),
    "1024-token row beside one-token rows P=N=64": (
        1027, 2, 64, 64, *_packed([1024, 1, 1, 1])),
    "padded layout with gaps P=N=16": (
        1024, 8, 16, 16, np.arange(4) * 256, [256, 100, 1, 37]),
    "packed mixed step P=N=16": (
        512, 8, 16, 16, *_packed([256, 150, 1, 1, 1, 60, 0, 30])),
    "P=16 N=64, stream tail in no row": (
        200, 4, 16, 64, *_packed([65, 64, 1, 3])),
}


@pytest.mark.parametrize("case", list(EMULATED_SCAN))
def test_tensor_core_rounding_fits_card_tolerance(case):
    """The emulated kernel (``emulate_kernel``) against the plain version
    and the token-sequential fp64 oracle, y and final states within
    MAMBA_TOL of the largest |value| (with a tenfold margin: the hi + lo
    pairs leave ~2^-17 relative errors that add up along a long row's
    chunks), zero-length rows bit for bit, y exactly 0 outside rows."""
    tt, h, p, n, starts, lens = EMULATED_SCAN[case]
    args = _stream(31, tt, h, p, n, starts, lens)
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    y, s = emulate_kernel(*args)
    ry, rs = mamba_chunk_scan_varlen_plain(*args)
    sy, ss = sequential_rows(*(a.float().numpy() for a in args[:5]),
                             starts, lens, args[7].numpy())
    for ours, ref in ((y, ry), (s, rs), (y, sy), (s, ss)):
        ref = torch.as_tensor(ref, dtype=torch.float32)
        err = (ours - ref).abs().max().item()
        assert err <= 0.1 * MAMBA_TOL * ref.abs().max().item(), err
    inside = np.zeros(tt, bool)
    for st, ln in zip(starts, lens):
        inside[st:st + ln] = True
    assert (y[torch.from_numpy(~inside)] == 0).all()
    for i, ln in enumerate(lens):
        if ln == 0:
            assert torch.equal(s[i], args[7][i])


@pytest.mark.parametrize("b,t_,h,p,n", [(2, 192, 2, 64, 64),
                                        (3, 128, 4, 16, 16)])
def test_emulated_kernel_matches_pallas_on_tpu_shapes(b, t_, h, p, n):
    """Equal rows and a zero initial state (the TPU kernel's contract):
    the emulated kernel against the Pallas kernel in interpret mode,
    within MAMBA_TOL of the largest |y|."""
    x, bm, cm, dt, a_log = scan_inputs(8, b * t_, h, p, n)
    starts, lens = np.arange(b) * t_, [t_] * b
    bf = [t(a).to(torch.bfloat16) for a in (x, bm, cm)]
    y, _ = emulate_kernel(*bf, t(dt), t(a_log),
                          *(t(np.asarray(v, np.int32)) for v in (starts,
                                                                  lens)),
                          torch.zeros((b, h, p, n)))
    jargs = [jnp.asarray(a.float().numpy().reshape(b, t_, *a.shape[1:]))
             for a in bf] + [jnp.asarray(dt.reshape(b, t_, h)),
                             jnp.asarray(a_log)]
    ref = np.asarray(jax_kernel(*jargs, chunk=64, interpret=True))
    err = np.abs(y.numpy().reshape(ref.shape) - ref).max()
    assert err <= MAMBA_TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("tt,h,lens", [
    (512, 64, [256, 150, 1, 1, 1, 60, 0, 30]),     # chip_smoke's mixed
    (8, 64, [1, 1, 1, 0, 1, 1, 1, 1]),             # decode
    (2055, 64, [2048] + [1] * 7),                  # long row
    (1024, 64, [256, 100, 1, 37]),                 # padded (gaps)
    (512, 8, [256, 150, 1, 1, 1, 60, 0, 30]),      # reduced heads
    (130, 6, [0, 0, 64, 65, 1]),                   # empty rows first
    (4096, 64, [64] * 64),                         # every chunk full
])
def test_device_work_rule_covers_every_chunk_once(tt, h, lens):
    """The device-side work rule (``device_items``) gives every (row,
    chunk, head) of the rows exactly one block and every ZERO_TILE-token
    tile of y one, within the grid ``scan_blocks`` sizes from TT // 64 + R
    without reading the lengths; a chunk's predecessor in its row has the
    smaller ticket (the order the chained state pass waits in)."""
    blocks, items = device_items(lens, tt, h)
    assert blocks == -(-tt // ZERO_TILE) + (tt // 64 + len(lens)) * h
    want = {("chunk", r, c, head) for r, ln in enumerate(lens)
            for c in range(max(1, -(-ln // 64))) for head in range(h)}
    want |= {("tile", k) for k in range(-(-tt // ZERO_TILE))}
    got = [i for i in items if i is not None]
    assert len(got) == len(set(got)) and set(got) == want
    ticket = {i: w for w, i in enumerate(items) if i is not None}
    for (kind, *rest), w in ticket.items():
        if kind == "chunk" and rest[1] > 0:
            r, c, head = rest
            assert ticket[("chunk", r, c - 1, head)] < w


@pytest.mark.cuda
@pytest.mark.parametrize("tt,h,p,n,starts,lens", [
    (300, 64, 64, 64, [0, 37, 37, 200], [30, 150, 0, 100]),
    (1027, 64, 64, 64, *_packed([1024, 1, 1, 1])),          # long row
    (8, 64, 64, 64, *_packed([1, 1, 1, 0, 1, 1, 1, 1])),    # one-token rows
    (512, 8, 16, 16, *_packed([256, 150, 1, 1, 1, 60, 0, 30])),
])
def test_cuda_kernel_matches_plain(tt, h, p, n, starts, lens):
    """The CUDA kernel against its plain version on the card at zamba2's
    widths (H 64, P 64, N 64) and the reduced ones (P = N = 16): ragged
    rows with non-zero states, a zero-length row passing its state bit for
    bit, a 1024-token row over 16 chained chunks, one-token rows,
    repeatable bytes. Tolerance MAMBA_TOL of the largest |value| (fp32
    sums in another order; bf16 hi + lo tensor-core operands)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    dev = torch.device("cuda")
    args = [a.to(dev) for a in _stream(13, tt, h, p, n, starts, lens)]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    before = mamba_chunk_scan_varlen.launches
    y, s = mamba_chunk_scan_varlen(*args)
    y2, s2 = mamba_chunk_scan_varlen(*args)
    torch.cuda.synchronize()
    assert mamba_chunk_scan_varlen.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2)
    ry, rs = mamba_chunk_scan_varlen_plain(*args)
    for a, b in ((y, ry), (s, rs)):
        assert (a - b).abs().max().item() <= MAMBA_TOL * b.abs().max().item()
    for i, ln in enumerate(lens):
        if ln == 0:
            assert torch.equal(s[i], args[7][i])
