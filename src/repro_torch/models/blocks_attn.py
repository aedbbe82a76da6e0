"""Transformer blocks of the packed serve path (``repro/models/blocks_attn.py``):
the QKV projection, the three attention phases (gather, compute, write)
and the SwiGLU MLP, on one device.

Packed self-attention always runs through the varlen flash kernel in one
call over [old page slots ++ fresh chunk K/V] (the reference's
``attention_impl="kernel"`` route, ``packed_kernel_attention``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention_varlen
from . import attention as A
from .common import dense, rms_norm
from .rotary import rotate

# Block-size caps for the segment-block-sparse packed attention schedule
# (sparse_blocks scales them down for small streams).
Q_BLOCK = 128
KV_BLOCK = 512


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def sparse_blocks(t: int, s: int) -> tuple:
    """(q_block, kv_block) for the segment-block-sparse packed schedule:
    ~4 query blocks and ~16 KV blocks, clamped to 128 x 512 at scale and
    8 x 64 below. ``ModelRunner._attn_block_stats`` mirrors this sizing on
    the host — keep the two in sync."""
    return (max(8, min(Q_BLOCK, _pow2_floor(t // 4))),
            max(64, min(KV_BLOCK, _pow2_floor(s // 16))))


def qkv_proj(p, xn, *, kv_local: int, head_dim: int, rope):
    """Project + rope (``rope``: the step's ``rotary.rope_tables``).
    Returns q (B,T,KVL,G,D), k, v (B,T,KVL,D)."""
    b, t, _ = xn.shape
    q = dense(xn, p["q"], p.get("q_bias"))
    k = dense(xn, p["k"], p.get("k_bias"))
    v = dense(xn, p["v"], p.get("v_bias"))
    q = rotate(q.reshape(b, t, -1, head_dim), *rope)
    k = rotate(k.reshape(b, t, kv_local, head_dim), *rope)
    v = v.reshape(b, t, kv_local, head_dim)
    return A.group_q(q, kv_local), k, v


def page_slots(page_pos, page_seg, tpp: int):
    """Absolute position and owning segment of every slot of a flat page
    stream: (B, P) page starts/owners -> (B, P*TPP) each."""
    b, p = page_pos.shape
    ar = torch.arange(tpp, dtype=page_pos.dtype, device=page_pos.device)
    slot_pos = (page_pos[:, :, None] + ar).reshape(b, p * tpp)
    slot_seg = page_seg[:, :, None].expand(b, p, tpp).reshape(b, p * tpp)
    return slot_pos, slot_seg


def attn_gather(buf, view_shape, tables, layer, index=None):
    """Phase 1 (READ): this layer's old pages, copied out of the buffer
    (k, v: (B, P*TPP, KVL, D)). Must run before any buffer write of the
    same cycle."""
    return A.gather_pages(buf.view(view_shape), tables, layer, index)


def packed_attention_meta(slot_pos, slot_seg, positions, seg_ids,
                          chunk_start):
    """The varlen call's segment ids, positions and tile sizes for one
    packed step over [old page slots ++ fresh chunk] — the same for every
    layer of the step.

    Old slots are gated by their segment's chunk start (the reference's
    strict ``slot_pos < chunk_start``): a scatter-max over the token stream
    recovers each segment's chunk start, and slots at or past it — plus
    dead/pad slots (seg -2) — are re-tagged seg -2 so they never match.
    Fresh tokens ride with kv_pos = positions, so the kernel's
    ``kpos <= qpos`` rule is the intra-chunk causal mask."""
    t = seg_ids.shape[1]
    s = slot_pos.shape[1]
    sid = seg_ids[0]
    cs = chunk_start.expand(1, t)[0]
    seg_cs = torch.full((t,), -1, dtype=cs.dtype, device=cs.device)
    seg_cs = seg_cs.scatter_reduce(0, sid.clamp(0, t - 1).long(),
                                   torch.where(sid >= 0, cs, -1), "amax")
    slot_cs = seg_cs[slot_seg[0].clamp(0, t - 1).long()]
    live = (slot_seg[0] >= 0) & (slot_pos[0] < slot_cs)
    kv_seg = torch.cat([torch.where(live, slot_seg[0], -2), sid])
    kv_pos = torch.cat([slot_pos[0], positions[0]])
    blk_q, blk_k = sparse_blocks(t, s + t)
    return dict(q_seg=sid.int(), kv_seg=kv_seg.int(),
                q_pos=positions[0].int(), kv_pos=kv_pos.int(),
                blk_q=blk_q, blk_k=blk_k)


def packed_kernel_attention(q, k_old, v_old, k_fresh, v_fresh, meta, *,
                            window=0):
    """One segment-block-sparse varlen flash call over [old page slots ++
    fresh chunk K/V] (``meta``: ``packed_attention_meta``).

    q: (1,T,KVL,G,D); k_old/v_old: (1,S,KVL,D); k_fresh/v_fresh:
    (1,T,KVL,D). Returns (1,T,KVL,G,D) in q.dtype; rows with no visible KV
    come out zero. The kernel takes head-major views of these token-major
    tensors (no copies) and maps q head h to kv head h // G, so K/V keep
    their KVL heads."""
    _, t, kvl, g, d = q.shape
    kk = torch.cat([k_old[0], k_fresh[0]])                 # (S+T, KVL, D)
    vv = torch.cat([v_old[0], v_fresh[0]])
    out = flash_attention_varlen(
        q[0].reshape(t, kvl * g, d).transpose(0, 1), kk.transpose(0, 1),
        vv.transpose(0, 1), meta["q_seg"], meta["kv_seg"], meta["q_pos"],
        meta["kv_pos"], window=window, blk_q=meta["blk_q"],
        blk_k=meta["blk_k"])                               # (H, T, D)
    return out.transpose(0, 1).reshape(1, t, kvl, g, d)


def attn_compute(p, x, k_old, v_old, *, meta, rope, kv_local, head_dim,
                 window=0, norm_eps=1e-5):
    """Phase 2 (COMPUTE): packed attention over the gathered old pages and
    this step's fresh K/V (still in hand — the buffer write happens in
    phase 3). Returns (x_out, k_fresh, v_fresh)."""
    b, t, _ = x.shape
    xn = rms_norm(x, p["attn_norm"], norm_eps)
    q, k, v = qkv_proj(p, xn, kv_local=kv_local, head_dim=head_dim,
                       rope=rope)
    out = packed_kernel_attention(q, k_old, v_old, k, v, meta, window=window)
    y = dense(out.reshape(b, t, -1), p["o"])
    return x + y, k, v


def mlp_block(p, x, norm_eps=1e-5):
    """SwiGLU MLP: silu in fp32, times u in fp32, then cast (as the
    reference)."""
    xn = rms_norm(x, p["mlp_norm"], norm_eps)
    g = dense(xn, p["gate"])
    u = dense(xn, p["up"])
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return x + dense(h, p["down"])
