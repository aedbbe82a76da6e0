"""Varlen (token-packed) segment-id flash attention: the CUDA kernel's
wrapper, its launch plan and its plain PyTorch version.

The kernel (``csrc/varlen_flash.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_varlen_tpu``
with one change of contract: k/v may carry ``BH / G`` heads, and q head
``h`` reads kv head ``h // G`` (no repeated K/V). On the H100 the packed
serve step's calls are bound by the bytes they move and, in practice, by
latency; the kernel runs its products on the tensor cores (wgmma, fed by
a TMA ring), packs the G q heads of a kv head into one q tile's rows so
each K/V tile is staged once for all of them, loads only the kv tiles a q
tile can hit (``varlen_kv_tiles``, computed once per serve step), and
splits a long kv stream into equal ranges of tiles, one block a range,
whose partials the last one combines in a fixed order: a row's output
does not depend on tiles it cannot see. Head dim 120 (h2o-danube-3-4b) runs the
D 128 instance with the true head dim at run time (its tensor maps read
columns 120-127 as zeros, its stores stop at column 120), so nothing is
padded or copied.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import build
from ..scratch import stream_scratch

NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 120, 128)

# The kernel's tiling (csrc/varlen_flash.cu): 128 GQA-packed q rows per
# block (two warpgroups of 64 rows, floor(64 / G) tokens each), kv tiles
# of KV_TILE slots, at most MAX_KV_TILES of them in a stream.
Q_ROWS = 128
KV_TILE = 128
MAX_KV_TILES = 2048
# The kv stream is cut into n_splits equal ranges of at least SPLIT_TILES
# tiles, one block of a q tile each; n_splits aims at about two blocks for
# each of the H100's SMS (scripts/sweep_varlen_split.py times the
# alternatives; PERF.md).
SPLIT_TILES = 8
SMS = 132
_BIG = 1 << 30


def flash_attention_varlen_plain(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *,
                                 window=0, return_lse=False):
    """Masked-softmax form of the kernel's contract (the reference's
    ``flash_attention_varlen_ref``), with GQA: q (BH, T, D); k/v
    (BH/G, S, D); q_seg/q_pos (T,); kv_seg/kv_pos (S,). Rows with no
    visible slot are exactly zero. Returns (BH, T, D) in q.dtype, and with
    ``return_lse`` also each row's natural-log log-sum-exp of its scaled
    scores over the slots it sees, (BH, T) fp32, -inf for a row that sees
    nothing."""
    g = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    mask = (kv_seg[None, :] == q_seg[:, None]) & \
        (kv_pos[None, :] <= q_pos[:, None])
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    d = q.shape[-1]
    logit = torch.einsum("btd,bsd->bts", q.float(), k.float()) / (d ** 0.5)
    logit = torch.where(mask[None], logit,
                        torch.full((), NEG_INF, device=logit.device))
    mx = logit.amax(-1, keepdim=True)
    p = torch.exp(logit - mx)
    z = p.sum(-1, keepdim=True)
    p = p / torch.clamp(z, min=1e-30)
    seen = mask.any(-1, keepdim=True)[None]
    out = torch.einsum("bts,bsd->btd", p * seen, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(seen, mx + torch.log(z),
                      torch.full((), -torch.inf, device=q.device))
    return out, lse[..., 0]


def varlen_kv_tiles(kv_seg, kv_pos):
    """Per KV_TILE-slot tile of the kv stream, over its slots with segment
    id >= 0: (min seg, max seg, min pos, max pos), int32 (ceil(S /
    KV_TILE), 4); a tile with no such slot gets (2^30, -2^30, 2^30,
    -2^30). The kernel skips a tile for a q tile when the segment
    intervals do not meet or no position can be seen. The same for every
    layer of a serve step: ``packed_attention_meta`` computes it once."""
    s = kv_seg.shape[0]
    n = -(-s // KV_TILE)
    pad = n * KV_TILE - s
    seg = F.pad(kv_seg, (0, pad), value=-2).view(n, KV_TILE)
    pos = F.pad(kv_pos, (0, pad)).view(n, KV_TILE)
    live = seg >= 0
    cols = []
    for a in (seg, pos):
        cols += [torch.where(live, a, _BIG).amin(1),
                 torch.where(live, a, -_BIG).amax(1)]
    return torch.stack(cols, 1).to(torch.int32).contiguous()


def varlen_plan(t, s, g, kvh):
    """The kernel's launch plan for a stream of t tokens over s slots with
    G = g q heads on each of kvh kv heads: (tokens per q tile, q tiles,
    kv splits). Split sp of a q tile takes its hit tiles whose index lies
    in [sp * n_kt // n_splits, (sp + 1) * n_kt // n_splits); the splits
    with hits combine."""
    tq = 2 * (64 // g)
    n_qt = -(-t // tq)
    n_kt = -(-s // KV_TILE)
    ns = min(-(-n_kt // SPLIT_TILES), -(-2 * SMS // (n_qt * kvh)))
    return tq, n_qt, max(1, ns)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_rows(name, t):
    """bf16 (heads, tokens, D) with a contiguous head dim and the other
    strides multiples of 16 bytes, 16-byte aligned: the kernel reads
    through tensor maps and writes 16-byte vectors."""
    sh, st, sd = t.stride()
    if sd != 1 or sh % 8 or st % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                         f"aligned (strides {t.stride()})")


def check_inputs(q, k, v, q_seg, kv_seg, q_pos, kv_pos, blk_q, blk_k,
                 kv_tiles=None):
    """Validate the kernel's inputs (any device) and return its launch
    sizes (bh, t, s, d, g). q/k/v may be strided views (head-major views
    of token-major tensors); the int32 metadata must be contiguous.
    ``blk_q``/``blk_k`` are the reference's tile sizes, checked only for
    being positive. Every call of the serve path makes these checks, so
    each tensor is tested in one condition, and explained only when it
    fails."""
    bh, t, d = q.shape
    kvh, s = k.shape[0], k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if kvh < 1 or bh % kvh:
        raise ValueError(f"q heads {bh} not a multiple of kv heads {kvh}")
    if bh // kvh > 64:
        raise ValueError(f"{bh // kvh} q heads per kv head: at most 64")
    n_kt = -(-s // KV_TILE)
    if n_kt > MAX_KV_TILES:
        raise ValueError(f"{s} kv slots: at most {KV_TILE * MAX_KV_TILES}")
    dev = q.device
    bf16 = torch.bfloat16
    for name, a, shape in (("q", q, (bh, t, d)), ("k", k, (kvh, s, d)),
                           ("v", v, (kvh, s, d))):
        if a.dtype is not bf16 or a.shape != shape or a.device != dev:
            _check(name, a, bf16, shape, dev)
        _check_rows(name, a)
    for name, a, n in (("q_seg", q_seg, t), ("kv_seg", kv_seg, s),
                       ("q_pos", q_pos, t), ("kv_pos", kv_pos, s)):
        if a.dtype is not torch.int32 or a.shape != (n,) or \
                a.device != dev:
            _check(name, a, torch.int32, (n,), dev)
        if not a.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if kv_tiles is not None:
        _check("kv_tiles", kv_tiles, torch.int32, (n_kt, 4), dev)
        if not kv_tiles.is_contiguous() or kv_tiles.data_ptr() % 16:
            raise ValueError("kv_tiles: must be contiguous and 16-byte "
                             "aligned")
    if int(blk_q) < 1 or int(blk_k) < 1:
        raise ValueError(f"tile ({blk_q}, {blk_k}) out of range")
    return bh, t, s, d, bh // kvh


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load("varlen_flash")
    fn = lib.varlen_flash_bf16
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.varlen_flash_error_string.argtypes = [ctypes.c_int]
    lib.varlen_flash_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_varlen(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *,
                           window=0, blk_q=128, blk_k=128, kv_tiles=None,
                           out=None, return_lse=False):
    """Varlen flash attention over one packed stream.

    q: (BH, T, D) bf16; k/v: (BH/G, S, D) bf16 (views with a contiguous
    head dim are fine); q_seg/q_pos: (T,) int32; kv_seg/kv_pos: (S,) int32.
    Returns (BH, T, D) bf16, laid out like q.

    ``blk_q``/``blk_k`` are kept for the reference's contract (they set
    the TPU kernel's skip granularity); the kernel ignores them and skips,
    at its own tiles (GQA-packed q tiles of floor(64 / G) x 2 tokens, kv
    tiles of KV_TILE slots), every tile pair no row can see, which never
    changes the function. ``kv_tiles`` (``varlen_kv_tiles(kv_seg,
    kv_pos)``) is the per-step skip metadata; without it the wrapper
    computes it. ``out`` (CUDA only): a (BH, T, D) bf16 tensor with the
    row layout q may have, written in place of a new one. With
    ``return_lse`` the call also returns each row's natural-log
    log-sum-exp of its scaled scores over the slots it sees, (BH, T)
    fp32, -inf for a row that sees nothing: (out, lse). The kernel writes
    it beside its output; without it the launch is the same as before.

    Tensors on the CPU take the plain version (the kernel has no CPU
    form); CUDA tensors launch the kernel on the current stream or raise.
    ``flash_attention_varlen.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_varlen_plain(q, k, v, q_seg, kv_seg, q_pos,
                                            kv_pos, window=window,
                                            return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bh, t, s, d, g = check_inputs(q, k, v, q_seg, kv_seg, q_pos, kv_pos,
                                  blk_q, blk_k, kv_tiles)
    if not -_BIG < int(window) < _BIG:
        raise ValueError(f"window {window} out of range")
    if kv_tiles is None:
        kv_tiles = varlen_kv_tiles(kv_seg, kv_pos)
    kvh = bh // g
    _, n_qt, ns = varlen_plan(t, s, g, kvh)
    lib = _bind()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if out is None:
        out = torch.empty_like(q)    # same strides as q (a dense view)
    elif out.dtype is not torch.bfloat16 or out.shape != q.shape or \
            out.device != q.device:
        _check("out", out, torch.bfloat16, tuple(q.shape), q.device)
    _check_rows("out", out)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device) \
        if return_lse else None
    part_acc = part_ml = counters = None
    if ns > 1:
        part_acc = torch.empty((kvh * n_qt * ns, Q_ROWS, 128 if d == 120
                                else d),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((kvh * n_qt * ns, Q_ROWS, 2),
                              dtype=torch.float32, device=q.device)
        counters = stream_scratch(q.device, stream, kvh * n_qt)
    ptr = [None if a is None else a.data_ptr()
           for a in (part_acc, part_ml, counters)]
    strides = (ctypes.c_int64 * 8)(*q.stride()[:2], *k.stride()[:2],
                                   *v.stride()[:2], *out.stride()[:2])
    with torch.cuda.device(q.device):
        rc = lib.varlen_flash_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
            kv_seg.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            kv_tiles.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), *ptr,
            ctypes.addressof(strides), bh, t, s, d, g, int(window), ns,
            stream)
    if rc != 0:
        msg = lib.varlen_flash_error_string(rc).decode()
        raise RuntimeError(f"varlen_flash launch failed: {msg} ({rc})")
    flash_attention_varlen.launches += 1
    return (out, lse) if return_lse else out


flash_attention_varlen.launches = 0
