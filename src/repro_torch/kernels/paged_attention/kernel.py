"""Paged decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

The kernel (``csrc/paged_decode.cu``) replaces the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_decode_attention`` with the
same contract: one query token per sequence attends its pages through the
block table, reading ONE layer's strided view of the unified buffer where it
lies (no gather, no contiguous copy of the pool).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
MAX_G = 16


def paged_decode_attention_plain(q, kv_view, tables, page_pos, positions, *,
                                 window=0):
    """The reference's ``paged_decode_attention_ref``: q (B, KVL, G, D);
    kv_view (VP, 2, TPP, KVL, D); tables/page_pos (B, P); positions (B,).
    Entries < 0 clamp to page 0; a slot is visible iff slot_pos <= qpos
    (and > qpos - window). Masked scores are -1e30 with no zero-row guard,
    so a row with no visible slot returns mean(V) over its P*TPP slots.
    In a row that sees some slot, masked slots' V enter as zeros, as the
    kernel (which never reads them) has it: page 0 may hold another type's
    bytes, and their probability 0 times a non-finite value would still
    be NaN. Returns (B, KVL, G, D) in q.dtype."""
    b, kvl, g, d = q.shape
    tpp = kv_view.shape[2]
    p = tables.shape[1]
    pages = kv_view.index_select(0, tables.clamp(min=0).reshape(-1).long())
    pages = pages.view(b, p, *kv_view.shape[1:])        # (B,P,2,TPP,KVL,D)
    k = pages[:, :, 0].reshape(b, p * tpp, kvl, d).float()
    v = pages[:, :, 1].reshape(b, p * tpp, kvl, d).float()
    ar = torch.arange(tpp, dtype=page_pos.dtype, device=page_pos.device)
    slot_pos = (page_pos[:, :, None] + ar).reshape(b, p * tpp)
    mask = slot_pos <= positions[:, None]
    if window:
        mask &= slot_pos > positions[:, None] - window
    logit = torch.einsum("bkgd,bskd->bkgs", q.float() * (1.0 / d ** 0.5), k)
    logit = torch.where(mask[:, None, None, :], logit,
                        torch.full((), NEG_INF, device=logit.device))
    pr = torch.exp(logit - logit.amax(-1, keepdim=True))
    pr = pr / torch.clamp(pr.sum(-1, keepdim=True), min=1e-30)
    unread = ~mask & mask.any(-1, keepdim=True)
    v = v.masked_fill(unread[:, :, None, None], 0)
    return torch.einsum("bkgs,bskd->bkgd", pr, v).to(q.dtype)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def check_inputs(q, kv_view, tables, page_pos, positions):
    """Validate the kernel's inputs (any device) and return its launch
    sizes (b, kvl, g, d, p, tpp). q must be contiguous; kv_view may be a
    strided layer view of the pool, with a contiguous head dim and every
    (page, K/V, slot, head) row 16-byte aligned; the int32 metadata must be
    contiguous."""
    b, kvl, g, d = q.shape
    vp, two, tpp = kv_view.shape[:3]
    p = tables.shape[1] if tables.dim() == 2 else -1
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"{g} q heads per kv head, at most {MAX_G}")
    dev = q.device
    _check("q", q, torch.bfloat16, (b, kvl, g, d), dev)
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q: must be contiguous and 16-byte aligned")
    _check("kv_view", kv_view, torch.bfloat16, (vp, 2, tpp, kvl, d), dev)
    if kv_view.stride(-1) != 1 or kv_view.data_ptr() % 16 or \
            any(kv_view.stride(i) % 8 for i in range(4)):
        raise ValueError(f"kv_view: rows must be contiguous and 16-byte "
                         f"aligned (strides {kv_view.stride()})")
    for name, a, shape in (("tables", tables, (b, p)),
                           ("page_pos", page_pos, (b, p)),
                           ("positions", positions, (b,))):
        _check(name, a, torch.int32, shape, dev)
        if not a.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if p < 1 or vp < 1 or tpp < 1 or two != 2:
        raise ValueError(f"empty table or pool (P={p}, VP={vp}, TPP={tpp})")
    return b, kvl, g, d, p, tpp


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load("paged_decode")
    fn = lib.paged_decode_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q, kv_view, tables, page_pos, positions, *,
                           window=0):
    """Paged decode attention over one layer of the unified buffer.

    q: (B, KVL, G, D) bf16; kv_view: (VP, 2, TPP, KVL, D) bf16, typically
    ``buffer.view(VP, L, 2, TPP, KVL, D)[:, layer]`` (read in place, never
    copied); tables/page_pos: (B, P) int32; positions: (B,) int32. Returns
    (B, KVL, G, D) bf16.

    Tensors on the CPU take the plain version (the kernel has no CPU
    form); CUDA tensors launch the kernel on the current stream or raise.
    ``paged_decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kv_view, tables, page_pos,
                                            positions, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, kvl, g, d, p, tpp = check_inputs(q, kv_view, tables, page_pos,
                                        positions)
    lib = _bind()
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 4)(*(kv_view.stride(i) for i in range(4)))
    with torch.cuda.device(q.device):
        rc = lib.paged_decode_bf16(
            q.data_ptr(), kv_view.data_ptr(), tables.data_ptr(),
            page_pos.data_ptr(), positions.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, kvl, g, d, p, tpp, int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.paged_decode_error_string(rc).decode()
        raise RuntimeError(f"paged_decode launch failed: {msg} ({rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
