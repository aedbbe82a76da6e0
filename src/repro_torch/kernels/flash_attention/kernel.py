"""Varlen (token-packed) segment-id flash attention: the CUDA kernel's
wrapper and its plain PyTorch version.

The kernel (``csrc/varlen_flash.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_varlen_tpu``
with one change of contract: k/v may carry ``BH / G`` heads, and q head
``h`` reads kv head ``h // G`` (no repeated K/V).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_varlen_plain(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *,
                                 window=0):
    """Masked-softmax form of the kernel's contract (the reference's
    ``flash_attention_varlen_ref``), with GQA: q (BH, T, D); k/v
    (BH/G, S, D); q_seg/q_pos (T,); kv_seg/kv_pos (S,). Rows with no
    visible slot are exactly zero. Returns (BH, T, D) in q.dtype."""
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
    p = torch.exp(logit - logit.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    p = p * mask.any(-1, keepdim=True)[None]
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_rows(name, t):
    """bf16 (heads, tokens, D) with a contiguous head dim and every row
    16-byte aligned: the kernel reads rows with 16-byte vector loads."""
    if t.stride(-1) != 1 or t.stride(0) % 8 or t.stride(1) % 8 \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                         f"aligned (strides {t.stride()})")


def check_inputs(q, k, v, q_seg, kv_seg, q_pos, kv_pos, blk_q, blk_k):
    """Validate the kernel's inputs (any device) and return its launch
    sizes (bh, t, s, d, g, blk_q, blk_k). q/k/v may be strided views
    (head-major views of token-major tensors); the int32 metadata must be
    contiguous."""
    bh, t, d = q.shape
    kvh, s = k.shape[0], k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if kvh < 1 or bh % kvh:
        raise ValueError(f"q heads {bh} not a multiple of kv heads {kvh}")
    dev = q.device
    for name, a, shape in (("q", q, (bh, t, d)), ("k", k, (kvh, s, d)),
                           ("v", v, (kvh, s, d))):
        _check(name, a, torch.bfloat16, shape, dev)
        _check_rows(name, a)
    for name, a, n in (("q_seg", q_seg, t), ("kv_seg", kv_seg, s),
                       ("q_pos", q_pos, t), ("kv_pos", kv_pos, s)):
        _check(name, a, torch.int32, (n,), dev)
        if not a.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    blk_q, blk_k = min(int(blk_q), t), min(int(blk_k), s)
    if not (1 <= blk_q <= 128 and blk_k >= 1):
        raise ValueError(f"tile ({blk_q}, {blk_k}) out of range")
    return bh, t, s, d, bh // kvh, blk_q, blk_k


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load("varlen_flash")
    fn = lib.varlen_flash_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.varlen_flash_error_string.argtypes = [ctypes.c_int]
    lib.varlen_flash_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_varlen(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *,
                           window=0, blk_q=128, blk_k=128):
    """Varlen flash attention over one packed stream.

    q: (BH, T, D) bf16; k/v: (BH/G, S, D) bf16 (views with a contiguous
    head dim are fine); q_seg/q_pos: (T,) int32; kv_seg/kv_pos: (S,) int32.
    Tiles are (blk_q, blk_k), clamped to the stream, as in the TPU kernel; a
    tile pair whose segment intervals do not overlap is skipped. Returns
    (BH, T, D) bf16, laid out like q.

    Tensors on the CPU take the plain version (the kernel has no CPU
    form); CUDA tensors launch the kernel on the current stream or raise.
    ``flash_attention_varlen.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_varlen_plain(q, k, v, q_seg, kv_seg, q_pos,
                                            kv_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bh, t, s, d, g, blk_q, blk_k = check_inputs(
        q, k, v, q_seg, kv_seg, q_pos, kv_pos, blk_q, blk_k)
    lib = _bind()
    out = torch.empty_like(q)        # same strides as q (a dense view)
    _check_rows("out", out)
    strides = (ctypes.c_int64 * 8)(
        *(a.stride(i) for a in (q, k, v, out) for i in (0, 1)))
    with torch.cuda.device(q.device):
        rc = lib.varlen_flash_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
            kv_seg.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            out.data_ptr(), ctypes.addressof(strides), bh, t, s, d, g,
            int(window), blk_q, blk_k,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.varlen_flash_error_string(rc).decode()
        raise RuntimeError(f"varlen_flash launch failed: {msg} ({rc})")
    flash_attention_varlen.launches += 1
    return out


flash_attention_varlen.launches = 0
