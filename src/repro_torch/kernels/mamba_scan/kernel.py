"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper, its launch plan and its
plain PyTorch version.

The kernel (``csrc/mamba_scan.cu``) replaces the TPU kernel
``repro/kernels/mamba_scan/kernel.py::mamba_chunk_scan``. It computes the
same function over a wider contract: a list of independent token runs
("rows") of one stream, each with its own fp32 initial state, returning
each row's final state besides the outputs. ``mamba_chunk_scan`` keeps the
TPU kernel's shapes (equal rows, zero initial state) on top of it.

Two public entries, both launching the one kernel:

* ``mamba_chunk_scan(x, bm, cm, dt, a_log, *, chunk=64)``;
* ``mamba_chunk_scan_varlen(x, bm, cm, dt, a_log, row_start, row_len,
  init_state)``, which the serve step calls: packed steps pass one row per
  segment, padded steps one row per batch row.

``mamba_chunk_scan_varlen.launches`` counts launches of either entry.

On the H100 a call is bound by the bytes it moves and, in practice, by
latency; the kernel spreads the chunks of long rows over blocks that pass
the state along in order, runs its products on the tensor cores, and
takes a light path for one-token rows (``csrc/mamba_scan.cu``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..flash_attention.kernel import _check
from ..scratch import stream_scratch

_DIMS = (16, 32, 64, 128)


def _scan_rows(x, bm, cm, dt, a, s, chunk):
    """The chunked SSD scan over equal-length rows (the algebra of the
    reference's ``mamba2_chunked`` chunk step, every decay exponent clamped
    at <= 0): x (R, T, H, P), bm/cm (R, T, N), dt (R, T, H) fp32 with T a
    multiple of ``chunk``, a (H,) = -exp(a_log), s (R, H, P, N) fp32.
    Returns (y (R, T, H, P), final s)."""
    t = x.shape[1]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    ys = []
    for c0 in range(0, t, chunk):
        xc, bc, cc, dc = (v[:, c0:c0 + chunk] for v in (x, bm, cm, dt))
        lcum = torch.cumsum(dc * a, dim=1)                    # (R, L, H)
        cb = torch.einsum("rtn,rsn->rts", cc, bc)
        diff = (lcum[:, :, None] - lcum[:, None]).clamp(max=0)
        dec = torch.where(tri[None, :, :, None], torch.exp(diff),
                          torch.zeros((), device=x.device))
        score = cb[..., None] * dec * dc[:, None]             # (R, t, s, H)
        y = torch.einsum("rtsh,rshp->rthp", score, xc)
        y = y + torch.einsum("rtn,rhpn,rth->rthp", cc, s, torch.exp(lcum))
        sfac = torch.exp((lcum[:, -1:] - lcum).clamp(max=0)) * dc
        s = s * torch.exp(lcum[:, -1])[..., None, None] + torch.einsum(
            "rlh,rlhp,rln->rhpn", sfac, xc, bc)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def mamba_chunk_scan_varlen_plain(x, bm, cm, dt, a_log, row_start, row_len,
                                  init_state, *, chunk=64):
    """The kernel's contract in fp32 torch: rows are gathered into an
    (R, T_max) layout with zeros past each row's end (dt = 0 there: no
    decay and no contribution), scanned chunk by chunk, and scattered
    back. Returns (y (TT, H, P) fp32, zero outside every row; final state
    (R, H, P, N) fp32)."""
    tt, h, p = x.shape
    s = init_state.float().clone()
    y = torch.zeros((tt, h, p), dtype=torch.float32, device=x.device)
    lmax = int(row_len.max()) if row_len.numel() else 0
    if lmax == 0:
        return y, s
    t = -(-lmax // chunk) * chunk
    ar = torch.arange(t, device=x.device)
    valid = ar[None] < row_len[:, None].long()                # (R, T)
    idx = torch.where(valid, row_start[:, None].long() + ar[None], 0)

    def rows(v):
        g = v.float()[idx]
        return g * valid.reshape(*valid.shape, *(1,) * (g.dim() - 2))

    a = -torch.exp(a_log.float())
    yr, s = _scan_rows(rows(x), rows(bm), rows(cm), rows(dt), a, s, chunk)
    y[idx[valid]] = yr[valid]
    return y, s


def mamba_chunk_scan_plain(x, bm, cm, dt, a_log, *, chunk=64):
    """The TPU kernel's contract in fp32 torch: x (B, T, H, P), bm/cm
    (B, T, N), dt (B, T, H), a_log (H,), zero initial state, T a multiple
    of ``chunk``. Returns y (B, T, H, P) fp32."""
    b, t, h, p = x.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    s = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    y, _ = _scan_rows(x.float(), bm.float(), cm.float(), dt.float(),
                      -torch.exp(a_log.float()), s, chunk)
    return y


# The kernel's launch plan (csrc/mamba_scan.cu): rows are cut into
# CHUNK-token chunks, each split over its H heads, one block a head.
CHUNK = 64
ZERO_TILE = 16           # tokens of y a zeroing block checks
_SYNC_BASE = 32          # the ticket, then one flag per (row, head)


def scan_blocks(tt, r, h):
    """The kernel's grid for TT = tt tokens in r rows of h heads. Row r has
    max(1, ceil(len / CHUNK)) chunk units, at most tt // CHUNK + r over
    all rows whatever the lengths (which the host never reads); each unit
    takes h blocks, and ceil(tt / ZERO_TILE) more blocks zero y outside
    the rows."""
    return -(-tt // ZERO_TILE) + (tt // CHUNK + r) * h


def check_inputs(x, bm, cm, dt, a_log, row_start, row_len, init_state):
    """Validate the kernel's inputs (any device) and return its launch
    sizes (tt, r, h, p, n). x (TT, H, P) and bm/cm (TT, N) are bf16 whose
    inner dims are contiguous, with token strides that are multiples of 8
    (bm and cm share theirs) and 16-byte aligned data: the kernel reads
    them through tensor maps. dt (TT, H), a_log (H,), row_start/row_len
    (R,) contiguous; init_state (R, H, P, N) fp32 with contiguous
    (H, P, N), a row stride that is a multiple of 4 and 16-byte aligned
    data (16-byte state loads). P and N are 16, 32, 64 or 128. Every call
    of the serve path makes these checks, so each tensor is tested in one
    condition, and explained only when it fails."""
    tt, h, p = x.shape
    n = bm.shape[-1] if bm.dim() == 2 else -1
    r = row_start.shape[0] if row_start.dim() == 1 else -1
    if p not in _DIMS or n not in _DIMS:
        raise ValueError(f"head dim {p} / state dim {n} not in {_DIMS}")
    dev = x.device
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    xs = x.stride()
    if x.dtype is not bf16 or x.device != dev or xs[2] != 1 or \
            xs[1] != p or xs[0] % 8 or x.data_ptr() % 16:
        _check("x", x, bf16, (tt, h, p), dev)
        raise ValueError(f"x: (H, P) must be contiguous, the token stride a "
                         f"multiple of 8, the data 16-byte aligned (strides "
                         f"{xs})")
    bs = bm.stride(0)
    for name, v in (("bm", bm), ("cm", cm)):
        if v.dtype is not bf16 or v.shape != (tt, n) or v.device != dev or \
                v.stride() != (bs, 1) or bs % 8 or v.data_ptr() % 16:
            _check(name, v, bf16, (tt, n), dev)
            raise ValueError(f"{name}: N must be contiguous, the token stride "
                             f"a multiple of 8 shared by bm and cm, the data "
                             f"16-byte aligned (strides {v.stride()})")
    for name, v, dtype, shape in (
            ("dt", dt, f32, (tt, h)), ("a_log", a_log, f32, (h,)),
            ("row_start", row_start, i32, (r,)),
            ("row_len", row_len, i32, (r,))):
        if v.dtype is not dtype or v.shape != shape or v.device != dev or \
                not v.is_contiguous():
            _check(name, v, dtype, shape, dev)
            raise ValueError(f"{name}: must be contiguous")
    s = init_state
    if s.dtype is not f32 or s.shape != (r, h, p, n) or s.device != dev or \
            s.stride()[1:] != (p * n, n, 1) or s.stride(0) % 4 or \
            s.data_ptr() % 16:
        _check("init_state", s, f32, (r, h, p, n), dev)
        raise ValueError(f"init_state: (H, P, N) must be contiguous, the row "
                         f"stride a multiple of 4, the data 16-byte aligned "
                         f"(strides {s.stride()})")
    if not 1 <= r <= 65535 or tt < 1:
        raise ValueError(f"{r} rows over {tt} tokens: 1..65535 rows")
    return tt, r, h, p, n


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_varlen
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ptr, i64, ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr, i64,
                   ptr, ptr, i64, ptr] + [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
    lib.mamba_scan_error_string.restype = ctypes.c_char_p
    return lib


def mamba_chunk_scan_varlen(x, bm, cm, dt, a_log, row_start, row_len,
                            init_state):
    """Mamba2 SSD scan over rows ``[row_start[r], row_start[r] +
    row_len[r])`` of one token stream, row r starting from
    ``init_state[r]``.

    x: (TT, H, P) bf16; bm/cm: (TT, N) bf16; dt: (TT, H) fp32 (after
    softplus); a_log: (H,) fp32; row_start/row_len: (R,) int32 (rows must
    not overlap); init_state: (R, H, P, N) fp32. Returns (y (TT, H, P)
    fp32, zero outside every row; final state (R, H, P, N) fp32). A row of
    length 0 passes its state through.

    Tensors on the CPU take the plain version (the kernel has no CPU
    form; it accepts any float dtype there); CUDA tensors launch the
    kernel on the current stream or raise."""
    if x.device.type == "cpu":
        return mamba_chunk_scan_varlen_plain(x, bm, cm, dt, a_log, row_start,
                                             row_len, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tt, r, h, p, n = check_inputs(x, bm, cm, dt, a_log, row_start, row_len,
                                  init_state)
    dev = x.device
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty((tt, h, p), dtype=torch.float32, device=dev)
    final = torch.empty((r, h, p, n), dtype=torch.float32, device=dev)
    sync = stream_scratch(dev, stream, _SYNC_BASE + r * h)
    args = (x.data_ptr(), x.stride(0), bm.data_ptr(), cm.data_ptr(),
            bm.stride(0), dt.data_ptr(), a_log.data_ptr(),
            row_start.data_ptr(), row_len.data_ptr(), init_state.data_ptr(),
            init_state.stride(0), y.data_ptr(), final.data_ptr(),
            final.stride(0), sync.data_ptr(), tt, r, h, p, n,
            scan_blocks(tt, r, h), stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.mamba_scan_varlen(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.mamba_scan_varlen(*args)
    if rc != 0:
        msg = lib.mamba_scan_error_string(rc).decode()
        raise RuntimeError(f"mamba_scan launch failed: {msg} ({rc})")
    mamba_chunk_scan_varlen.launches += 1
    return y, final


mamba_chunk_scan_varlen.launches = 0


def mamba_chunk_scan(x, bm, cm, dt, a_log, *, chunk=64):
    """The TPU kernel's entry: x (B, T, H, P), bm/cm (B, T, N), dt
    (B, T, H) (after softplus), a_log (H,); zero initial state, T a
    multiple of ``chunk``. Returns y (B, T, H, P) fp32 (before the
    D-residual and gating).

    On the CPU the plain version chunks at ``chunk``; on the card the
    kernel (``mamba_chunk_scan_varlen`` with one row per batch row) chunks
    at 64 whatever ``chunk`` is: the result differs only by summation
    order."""
    b, t, h, p = x.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    if x.device.type == "cpu":
        return mamba_chunk_scan_plain(x, bm, cm, dt, a_log, chunk=chunk)
    n = bm.shape[-1]
    dev = x.device
    rows = torch.arange(b, dtype=torch.int32, device=dev) * t
    lens = torch.full((b,), t, dtype=torch.int32, device=dev)
    s0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    y, _ = mamba_chunk_scan_varlen(
        x.reshape(b * t, h, p), bm.reshape(b * t, n), cm.reshape(b * t, n),
        dt.reshape(b * t, h), a_log, rows, lens, s0)
    return y.view(b, t, h, p)
