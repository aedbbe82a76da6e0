"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper and its plain PyTorch
version.

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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..flash_attention.kernel import _check

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


def check_inputs(x, bm, cm, dt, a_log, row_start, row_len, init_state):
    """Validate the kernel's inputs (any device) and return its launch
    sizes (tt, r, h, p, n). x (TT, H, P) and bm/cm (TT, N) are bf16 whose
    inner dims are contiguous, with any token stride (bm and cm share
    theirs); dt (TT, H), a_log (H,), row_start/row_len (R,) contiguous;
    init_state (R, H, P, N) fp32 with contiguous (H, P, N) and any row
    stride. P and N are 16, 32, 64 or 128."""
    tt, h, p = x.shape
    n = bm.shape[-1] if bm.dim() == 2 else -1
    r = row_start.shape[0] if row_start.dim() == 1 else -1
    if p not in _DIMS or n not in _DIMS:
        raise ValueError(f"head dim {p} / state dim {n} not in {_DIMS}")
    dev = x.device
    _check("x", x, torch.bfloat16, (tt, h, p), dev)
    if x.stride(2) != 1 or x.stride(1) != p:
        raise ValueError(f"x: (H, P) must be contiguous (strides "
                         f"{x.stride()})")
    for name, v in (("bm", bm), ("cm", cm)):
        _check(name, v, torch.bfloat16, (tt, n), dev)
        if v.stride(1) != 1 or v.stride(0) != bm.stride(0):
            raise ValueError(f"{name}: N must be contiguous, token stride "
                             f"shared by bm and cm (strides {v.stride()})")
    for name, v, dtype, shape in (
            ("dt", dt, torch.float32, (tt, h)),
            ("a_log", a_log, torch.float32, (h,)),
            ("row_start", row_start, torch.int32, (r,)),
            ("row_len", row_len, torch.int32, (r,))):
        _check(name, v, dtype, shape, dev)
        if not v.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    _check("init_state", init_state, torch.float32, (r, h, p, n), dev)
    if init_state.stride()[1:] != (p * n, n, 1):
        raise ValueError(f"init_state: (H, P, N) must be contiguous "
                         f"(strides {init_state.stride()})")
    if not 1 <= r <= 65535 or tt < 1:
        raise ValueError(f"{r} rows over {tt} tokens: 1..65535 rows")
    return tt, r, h, p, n


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_varlen
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ptr, i64, ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr, i64,
                   ptr, ptr, i64] + [ctypes.c_int] * 4 + [ptr]
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
    lib = _bind()
    y = torch.zeros((tt, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((r, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.mamba_scan_varlen(
            x.data_ptr(), x.stride(0), bm.data_ptr(), cm.data_ptr(),
            bm.stride(0), dt.data_ptr(), a_log.data_ptr(),
            row_start.data_ptr(), row_len.data_ptr(), init_state.data_ptr(),
            init_state.stride(0), y.data_ptr(), final.data_ptr(),
            final.stride(0), r, h, p, n,
            torch.cuda.current_stream(x.device).cuda_stream)
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
