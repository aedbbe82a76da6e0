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

Training: ``mamba_chunk_scan_bwd`` launches the backward kernel
(``csrc/mamba_scan_bwd.cu``, which replaces no TPU kernel: the reference
differentiates its jnp scan) over the same rows from zero states, and
``mamba_chunk_scan_train`` is the autograd Function whose forward is
``mamba_chunk_scan_varlen`` and whose backward is
``mamba_chunk_scan_bwd``; ``mamba_chunk_scan_bwd.launches`` counts the
backward's calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


def _check_stream(x, bm, cm, dt, a_log, row_start, row_len):
    """``check_inputs`` without the state: x, bm, cm, dt, a_log and the
    rows. Returns (tt, r, h, p, n)."""
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
    if not 1 <= r <= 65535 or tt < 1:
        raise ValueError(f"{r} rows over {tt} tokens: 1..65535 rows")
    return tt, r, h, p, n


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
    tt, r, h, p, n = _check_stream(x, bm, cm, dt, a_log, row_start, row_len)
    dev, f32 = x.device, torch.float32
    s = init_state
    if s.dtype is not f32 or s.shape != (r, h, p, n) or s.device != dev or \
            s.stride()[1:] != (p * n, n, 1) or s.stride(0) % 4 or \
            s.data_ptr() % 16:
        _check("init_state", s, f32, (r, h, p, n), dev)
        raise ValueError(f"init_state: (H, P, N) must be contiguous, the row "
                         f"stride a multiple of 4, the data 16-byte aligned "
                         f"(strides {s.stride()})")
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


# ------------------------------------------------------------------ backward
_BWD_DIMS = (16, 32, 64)    # P == N, the kernel's instances
HEAD_GROUP = 4              # heads of one launch-B block (the .cu's kGroup)
STATE_UNIT = 4              # chunks of one launch-A block (the .cu's kKA)


class BwdPlan(NamedTuple):
    """The backward kernel's launch plan (``csrc/mamba_scan_bwd.cu``) for
    TT tokens in R rows of H heads of P x N, sized without reading the
    row lengths (the host never sees them).

    * ``blocks_a``: launch A, one block per (unit, head), a row's chunks
      but its last cut into units of STATE_UNIT in order (at most
      TT // (64 STATE_UNIT) + R units over all rows), heads innermost.
    * ``blocks_b``: launch B, ``tiles`` blocks that zero the outputs of
      ZERO_TILE-token tiles outside every row, then one block per (chunk,
      head group) of every chunk (at most ``chunks`` = TT // 64 + R), a
      row's chunks in reverse, groups innermost.
    * Both number the rows' chunks level by level (every row's first,
      then every row's second, ...: the chains of all rows advance
      together); a block waits only on its row's previous chunk, which
      has the smaller ticket.
    * scratch: ``states`` (chunks, H, P, N) fp32, each chunk's S_in from
      launch A; ``carry`` (R, H, P, N) fp32, the dS hand-off of launch B;
      ``parts`` (2, TT, groups, N) fp32, each head group's dB and dC sums;
      ``da_part`` (chunks, H) fp32; ``sync`` int32 of the stream scratch:
      the ticket and done counter, a flag per (row, head), a counter per
      chunk."""
    groups: int
    chunks: int
    tiles: int
    blocks_a: int
    blocks_b: int
    states: tuple
    carry: tuple
    parts: tuple
    da_part: tuple
    sync: int


def bwd_plan(tt, r, h, p, n):
    groups = -(-h // HEAD_GROUP)
    chunks = tt // CHUNK + r
    tiles = -(-tt // ZERO_TILE)
    return BwdPlan(groups=groups, chunks=chunks, tiles=tiles,
                   blocks_a=(tt // CHUNK // STATE_UNIT + r) * h,
                   blocks_b=tiles + chunks * groups,
                   states=(chunks, h, p, n), carry=(r, h, p, n),
                   parts=(2, tt, groups, n), da_part=(chunks, h),
                   sync=_SYNC_BASE + r * h + chunks)


def mamba_chunk_scan_bwd_plain(x, bm, cm, dt, a_log, row_start, row_len, dy):
    """The backward's contract in fp32 torch: autograd through
    ``mamba_chunk_scan_varlen_plain`` (zero initial states) for the
    upstream gradient ``dy`` (TT, H, P). Returns (dx, dbm, dcm, ddt,
    da_log), each in its input's dtype."""
    ins = (x, bm, cm, dt, a_log)
    leaves = [v.detach().float().requires_grad_(True) for v in ins]
    s0 = torch.zeros((row_start.shape[0], x.shape[1], x.shape[2],
                      bm.shape[-1]), dtype=torch.float32, device=x.device)
    with torch.enable_grad():
        y, _ = mamba_chunk_scan_varlen_plain(*leaves, row_start, row_len, s0)
        grads = torch.autograd.grad(y, leaves, dy.float())
    return tuple(g.to(v.dtype) for g, v in zip(grads, ins))


def check_bwd_inputs(x, bm, cm, dt, a_log, row_start, row_len, dy):
    """The backward kernel's inputs: the forward's (``check_inputs``, no
    state) with P == N in 16, 32 or 64, and dy (TT, H, P) fp32
    contiguous. Returns (tt, r, h, p, n)."""
    tt, r, h, p, n = _check_stream(x, bm, cm, dt, a_log, row_start, row_len)
    if p != n or p not in _BWD_DIMS:
        raise ValueError(f"backward: head dim {p} / state dim {n}: the "
                         f"kernel takes P == N in {_BWD_DIMS}")
    if dy.dtype is not torch.float32 or dy.shape != (tt, h, p) or \
            dy.device != x.device or not dy.is_contiguous():
        _check("dy", dy, torch.float32, (tt, h, p), x.device)
        raise ValueError("dy: must be contiguous")
    return tt, r, h, p, n


@functools.lru_cache(maxsize=None)
def _bind_bwd():
    lib = build.load("mamba_scan_bwd")
    fn = lib.mamba_scan_bwd
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ptr, i64, ptr, ptr, i64] + [ptr] * 15 + \
        [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    lib.mamba_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.mamba_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def mamba_chunk_scan_bwd(x, bm, cm, dt, a_log, row_start, row_len, dy):
    """Gradients of ``mamba_chunk_scan_varlen``'s y with zero initial
    states, for the upstream gradient dy (TT, H, P) fp32: (dx, dbm, dcm,
    ddt, da_log) in the dtypes of x, bm, cm, dt and a_log; 0 on tokens
    outside every row. There is no gradient with respect to the initial or
    final states.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    kernel (``csrc/mamba_scan_bwd.cu``, two launches on the plan of
    ``bwd_plan``) on the current stream or raise. The kernel writes every
    output in its final dtype (dx, dB and dC in bf16) and every element of
    it, so nothing is zero-filled. Two calls on the same inputs give the
    same bytes."""
    if x.device.type == "cpu":
        return mamba_chunk_scan_bwd_plain(x, bm, cm, dt, a_log, row_start,
                                          row_len, dy)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tt, r, h, p, n = check_bwd_inputs(x, bm, cm, dt, a_log, row_start,
                                      row_len, dy)
    dev = x.device
    lib = _bind_bwd()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = bwd_plan(tt, r, h, p, n)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((tt, h, p), dtype=x.dtype, device=dev)
    dbm = torch.empty((tt, n), dtype=bm.dtype, device=dev)
    dcm = torch.empty((tt, n), dtype=cm.dtype, device=dev)
    ddt = torch.empty((tt, h), **f32)
    da_log = torch.empty((h,), **f32)
    states = torch.empty(plan.states, **f32)
    carry = torch.empty(plan.carry, **f32)
    parts = torch.empty(plan.parts, **f32)
    da_part = torch.empty(plan.da_part, **f32)
    sync = stream_scratch(dev, stream, plan.sync)
    args = (x.data_ptr(), x.stride(0), bm.data_ptr(), cm.data_ptr(),
            bm.stride(0), dt.data_ptr(), a_log.data_ptr(),
            row_start.data_ptr(), row_len.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dbm.data_ptr(), dcm.data_ptr(), ddt.data_ptr(),
            da_log.data_ptr(), states.data_ptr(), carry.data_ptr(),
            parts.data_ptr(), da_part.data_ptr(), sync.data_ptr(), tt, r, h,
            p, plan.blocks_a, plan.blocks_b, stream)
    with torch.cuda.device(dev):
        rc = lib.mamba_scan_bwd(*args)
    if rc != 0:
        msg = lib.mamba_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"mamba_scan_bwd launch failed: {msg} ({rc})")
    mamba_chunk_scan_bwd.launches += 1
    return dx, dbm, dcm, ddt, da_log


mamba_chunk_scan_bwd.launches = 0


class _ScanTrain(torch.autograd.Function):
    """y of the scan with zero initial states: the forward through
    ``mamba_chunk_scan_varlen``, the backward through
    ``mamba_chunk_scan_bwd`` (each the kernel on the card, the plain
    version on the CPU). The backward recomputes the chunk states."""

    @staticmethod
    def forward(ctx, x, bm, cm, dt, a_log, row_start, row_len):
        s0 = torch.zeros((row_start.shape[0], x.shape[1], x.shape[2],
                          bm.shape[-1]), dtype=torch.float32,
                         device=x.device)
        y, _ = mamba_chunk_scan_varlen(x, bm, cm, dt, a_log, row_start,
                                       row_len, s0)
        ctx.save_for_backward(x, bm, cm, dt, a_log, row_start, row_len)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bm, cm, dt, a_log, row_start, row_len = ctx.saved_tensors
        grads = mamba_chunk_scan_bwd(x, bm, cm, dt, a_log, row_start,
                                     row_len, dy.float().contiguous())
        return (*grads, None, None)


def mamba_chunk_scan_train(x, bm, cm, dt, a_log, row_start, row_len,
                           init_state=None):
    """``mamba_chunk_scan_varlen``'s y (TT, H, P) fp32, differentiable with
    respect to x, bm, cm, dt and a_log: the training route. Initial states
    are zero; there is no gradient with respect to a state, so an
    ``init_state`` raises."""
    if init_state is not None:
        raise ValueError("mamba_chunk_scan_train: the backward takes zero "
                         "initial states and gives no state gradient")
    return _ScanTrain.apply(x, bm, cm, dt, a_log, row_start, row_len)
