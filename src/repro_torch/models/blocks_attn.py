"""Transformer blocks (``repro/models/blocks_attn.py``): the QKV
projection, the serve path's attention phases (gather, compute, write),
training's self-attention, the SwiGLU MLP and the capacity MoE.

Training attention (``attn_train``) runs through the dense flash kernel,
forward and backward, in one call per layer. Training's attention and MLP
take this rank's heads and ``d_ff`` columns of a ``(data, model)`` mesh
and end in ``psum_tp``, as the reference's do; training's MoE takes this
rank's experts and their ffe columns and exchanges the routed copies by
an all-to-all over the data axis. Serving on a mesh does the same with
the rank's heads, and where a sequence's pages are split over ranks (K/V
replica groups, ``sp``: ``Dist.combine_axes``) each member attends its
own pages with the kernels' log-sum-exp output, the partials combine over
the group (``tp.combine_all``), and the fresh chunk (or token) merges
once, after the combine, on every rank with its own heads, as the
reference's ``attn_compute`` does.

Packed self-attention always runs through the varlen flash kernel in one
call over [old page slots ++ fresh chunk K/V] (the reference's
``attention_impl="kernel"`` route, ``packed_kernel_attention``). Padded
rows with T > 1 take the reference's jnp route in plain torch
(``prefill_flash`` over the gathered old pages, merged with the fresh
chunk); padded T == 1 steps write their K/V first and read every page in
place through the paged decode kernel (``attn_decode``). The cores of the
padded routes (``padded_prefill_attention``, ``decode_attention``) take
projected q/k/v, so the enc-dec family's biased, rope-free projections
share them. Packed cross attention (enc-dec) is one varlen kernel call
over the cross slots (``packed_cross_attention``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.layout import page_view
from ..kernels.flash_attention import (dense_flash_attention,
                                      flash_attention_varlen)
from ..kernels.flash_attention.kernel import varlen_kv_tiles
from ..kernels.paged_attention import paged_decode_attention
from . import attention as A
from .common import dense, rms_norm
from .rotary import rotate
from .tp import all_to_all_dp, combine_all, psum_tp

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
    return A.gather_pages(page_view(buf, view_shape), tables, layer,
                          index)


def packed_attention_meta(slot_pos, slot_seg, positions, seg_ids,
                          chunk_start, split=False):
    """The varlen call's segment ids, positions and tile sizes for one
    packed step over [old page slots ++ fresh chunk] — the same for every
    layer of the step.

    Old slots are gated by their segment's chunk start (the reference's
    strict ``slot_pos < chunk_start``): a scatter-max over the token stream
    recovers each segment's chunk start, and slots at or past it — plus
    dead/pad slots (seg -2) — are re-tagged seg -2 so they never match.
    Fresh tokens ride with kv_pos = positions, so the kernel's
    ``kpos <= qpos`` rule is the intra-chunk causal mask. ``kv_tiles`` is
    the kernel's per-tile skip metadata (``varlen_kv_tiles``), computed
    here once for all layers.

    ``split`` (a member of a combine group, ``packed_split_attention``):
    two calls' metadata, ``old`` over the old slots alone and ``fresh``
    over the chunk alone, each with its own tiles."""
    t = seg_ids.shape[1]
    s = slot_pos.shape[1]
    sid = seg_ids[0]
    cs = chunk_start.expand(1, t)[0]
    seg_cs = torch.full((t,), -1, dtype=cs.dtype, device=cs.device)
    seg_cs = seg_cs.scatter_reduce(0, sid.clamp(0, t - 1).long(),
                                   torch.where(sid >= 0, cs, -1), "amax")
    slot_cs = seg_cs[slot_seg[0].clamp(0, t - 1).long()]
    live = (slot_seg[0] >= 0) & (slot_pos[0] < slot_cs)
    old_seg = torch.where(live, slot_seg[0], -2)
    if split:
        return dict(old=_varlen_meta(sid, positions[0], old_seg,
                                     slot_pos[0]),
                    fresh=_varlen_meta(sid, positions[0], sid, positions[0]))
    return _varlen_meta(sid, positions[0], torch.cat([old_seg, sid]),
                        torch.cat([slot_pos[0], positions[0]]))


def _varlen_meta(q_seg, q_pos, kv_seg, kv_pos):
    """One varlen call's int32 metadata, its skip tiles and tile sizes."""
    blk_q, blk_k = sparse_blocks(q_seg.shape[0], kv_seg.shape[0])
    kv_seg, kv_pos = kv_seg.int(), kv_pos.int()
    return dict(q_seg=q_seg.int(), kv_seg=kv_seg, q_pos=q_pos.int(),
                kv_pos=kv_pos, kv_tiles=varlen_kv_tiles(kv_seg, kv_pos),
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
        blk_k=meta["blk_k"], kv_tiles=meta["kv_tiles"])    # (H, T, D)
    return out.transpose(0, 1).reshape(1, t, kvl, g, d)


def _varlen_partials(q, k, v, meta, window):
    """One varlen call with its log-sum-exp, as partials (o (1,KVL,G,T,D),
    m, l (1,KVL,G,T)): ``attention.lse_partials``."""
    _, t, kvl, g, d = q.shape
    out, lse = flash_attention_varlen(
        q[0].reshape(t, kvl * g, d).transpose(0, 1), k[0].transpose(0, 1),
        v[0].transpose(0, 1), meta["q_seg"], meta["kv_seg"], meta["q_pos"],
        meta["kv_pos"], window=window, blk_q=meta["blk_q"],
        blk_k=meta["blk_k"], kv_tiles=meta["kv_tiles"], return_lse=True)
    return A.lse_partials(out.unflatten(0, (kvl, g))[None],
                          lse.view(1, kvl, g, t))


def packed_split_attention(q, k_old, v_old, k_fresh, v_fresh, meta, dist, *,
                           window=0):
    """Packed attention of a member of a combine group (``meta``:
    ``packed_attention_meta(..., split=True)``): the varlen kernel over
    this rank's old page slots with its log-sum-exp, the partials combined
    over ``dist.combine_axes``, then a second call over the fresh chunk
    merged in, once, on every rank: the reference's order (its old part
    ``slot_pos < chunk_start`` combined over the group, then the fresh
    part's intra-chunk causal mask). The fresh chunk must not ride with
    every member's old slots: the combine would count it once per member,
    and with K/V replicas (whose q heads differ) with another rank's
    heads. Returns (1,T,KVL,G,D) in q.dtype."""
    o, m, l = combine_all(*_varlen_partials(q, k_old, v_old, meta["old"],
                                            window), dist)
    o, m, l = A.merge_partials(o, m, l, *_varlen_partials(
        q, k_fresh, v_fresh, meta["fresh"], window))
    return A.finalize_softmax(o, l).to(q.dtype)


def packed_cross_meta(slot_pos, slot_seg, seg_ids, enc_lens):
    """The varlen call's segment ids, positions and tile sizes for a packed
    step's cross attention over the flat stream of cross (encoder) slots:
    token i sees slot j of its own segment iff ``slot_pos[j] < enc_lens
    [i]``, the kernel's ``kpos <= qpos`` rule with ``q_pos := enc_lens -
    1`` (the reference's ``packed_cross_attn_kernel``). Tokens with no
    encoder (``enc_lens`` 0, pads) get q_pos -1, see nothing and come out
    exactly zero. There is no fresh part: the encoder's K/V are in the
    pages before any layer reads them. The same for every layer."""
    t = seg_ids.shape[1]
    kv_seg, kv_pos = slot_seg[0].int(), slot_pos[0].int()
    blk_q, blk_k = sparse_blocks(t, kv_seg.shape[0])
    return dict(q_seg=seg_ids[0].int(), kv_seg=kv_seg,
                q_pos=(enc_lens[0] - 1).int(), kv_pos=kv_pos,
                kv_tiles=varlen_kv_tiles(kv_seg, kv_pos), blk_q=blk_q,
                blk_k=blk_k)


def packed_cross_attention(q, k, v, meta):
    """One varlen flash call of a packed step's cross attention (``meta``:
    ``packed_cross_meta``). q: (1,T,KVL,G,D); k/v: (1,S,KVL,D) gathered
    cross slots. Returns (1,T,KVL,G,D) in q.dtype, rows of tokens with no
    encoder exactly zero."""
    _, t, kvl, g, d = q.shape
    out = flash_attention_varlen(
        q[0].reshape(t, kvl * g, d).transpose(0, 1), k[0].transpose(0, 1),
        v[0].transpose(0, 1), meta["q_seg"], meta["kv_seg"],
        meta["q_pos"], meta["kv_pos"], blk_q=meta["blk_q"],
        blk_k=meta["blk_k"], kv_tiles=meta["kv_tiles"])    # (H, T, D)
    return out.transpose(0, 1).reshape(1, t, kvl, g, d)


def attn_compute(p, x, k_old, v_old, *, meta, rope, kv_local, head_dim,
                 window=0, norm_eps=1e-5, dist=None):
    """Phase 2 (COMPUTE): packed attention over the gathered old pages and
    this step's fresh K/V (still in hand — the buffer write happens in
    phase 3), the o-projection summed over the model axis of ``dist``.
    A member of a combine group (``meta`` has ``old`` and ``fresh``) takes
    ``packed_split_attention``. Returns (x_out, k_fresh, v_fresh)."""
    b, t, _ = x.shape
    xn = rms_norm(x, p["attn_norm"], norm_eps)
    q, k, v = qkv_proj(p, xn, kv_local=kv_local, head_dim=head_dim,
                       rope=rope)
    if "old" in meta:
        out = packed_split_attention(q, k_old, v_old, k, v, meta, dist,
                                     window=window)
    else:
        out = packed_kernel_attention(q, k_old, v_old, k, v, meta,
                                      window=window)
    y = dense(out.reshape(b, t, -1), p["o"])
    return x + psum_tp(y, dist), k, v


def padded_prefill_meta(slot_pos, positions, *, window=0, block=512):
    """The masks of a padded T > 1 step — the same for every layer of a
    type. Old slots are visible iff ``slot_pos < chunk_start`` (the row's
    first position: the chunk's own slots come through the fresh part)
    and inside the window, one (B, 1, 1, T', blk) mask per kv block of
    ``block`` slots; the fresh part is intra-chunk causal by position
    (T <= 256, materialized) or by row index (longer chunks, through
    ``flash_attention_partials``)."""
    chunk_start = positions[:, :1]
    blocks = []
    for j0 in range(0, slot_pos.shape[1], block):
        sp = slot_pos[:, None, j0:j0 + block]
        mask = sp < chunk_start[:, :, None]
        if window:
            mask = mask & (sp > positions[:, :, None] - window)
        blocks.append((j0, j0 + sp.shape[-1], mask[:, None, None]))
    fresh = None
    if positions.shape[1] <= 256:
        fresh = positions[:, None, :] <= positions[:, :, None]
        if window:
            fresh &= positions[:, None, :] > positions[:, :, None] - window
    return dict(blocks=blocks, fresh=fresh)


def prefill_flash(q, k, v, blocks):
    """Flash attention of a padded chunk over its gathered OLD pages, block
    by block (the reference's ``_prefill_flash`` without segments).
    ``blocks``: ``padded_prefill_meta(...)["blocks"]``. Returns
    un-normalized fp32 partials (acc (B,KVL,G,T,D), m, l)."""
    qf, state = A.flash_state(q)
    for j0, j1, mask in blocks:
        state = A.flash_block(state, qf, k[:, j0:j1], v[:, j0:j1], mask)
    m, l, acc = state
    return acc, m, l


def attn_compute_padded(p, x, k_old, v_old, *, meta, rope, kv_local,
                        head_dim, window=0, norm_eps=1e-5, dist=None):
    """Phase 2 (COMPUTE) of a padded T > 1 step: flash over the gathered
    old pages merged with the fresh chunk (still in hand — the buffer
    write happens in phase 3), the o-projection summed over the model
    axis of ``dist``. ``meta``: ``padded_prefill_meta``.
    Returns (x_out, k_fresh, v_fresh)."""
    xn = rms_norm(x, p["attn_norm"], norm_eps)
    q, k, v = qkv_proj(p, xn, kv_local=kv_local, head_dim=head_dim,
                       rope=rope)
    out = padded_prefill_attention(q, k, v, k_old, v_old, meta,
                                   window=window, dist=dist)
    return x + psum_tp(dense(out, p["o"]), dist), k, v


def padded_prefill_attention(q, k, v, k_old, v_old, meta, *, window=0,
                             dist=None):
    """The attention of a padded T > 1 step: flash over the gathered old
    pages merged with the fresh chunk (q (B,T,KVL,G,D); k/v (B,T,KVL,D);
    ``meta``: ``padded_prefill_meta``). On a combine group the old part's
    partials combine over ``dist.combine_axes`` before the fresh merge, as
    the reference's do. Returns (B, T, KVL*G*D) in q.dtype."""
    b, t = q.shape[:2]
    o, m, l = combine_all(*prefill_flash(q, k_old, v_old, meta["blocks"]),
                          dist)
    if meta["fresh"] is not None:
        of, mf, lf = A.attend_tokens(q, k, v, meta["fresh"])
    else:
        of, mf, lf = A.flash_attention_partials(q, k, v, window=window)
    o, m, l = A.merge_partials(o, m, l, of, mf, lf)
    return A.finalize_softmax(o, l).reshape(b, t, -1).to(q.dtype)


def attn_decode(p, x, buf, view_shape, layer, *, rows, tables, page_pos,
                qpos, plan, rope, kv_local, head_dim, window=0,
                norm_eps=1e-5, dist=None):
    """A padded T == 1 attention layer: project, write this token's K/V
    into its slot FIRST (``rows``: ``kv_rows``; pad and killed rows go to
    the scratch page), then one paged decode kernel call over this layer's
    view of the buffer, read in place, with visibility ``slot_pos <=
    qpos``. Writing first makes the token's own slot visible, which equals
    the reference's old-part (``slot_pos < qpos``) plus fresh-token merge.
    Only this layer's slots are written before it reads, so every other
    layer of the cycle still reads what it would before any write.
    ``plan``: the step's ``paged_decode_plan``, shared by every layer.
    On a combine group (``dist.combine_axes``) the layer takes
    ``split_decode_attention`` instead (``qpos`` and ``plan`` then the
    strict old part's); the o-projection is summed over the model axis
    of ``dist``."""
    xn = rms_norm(x, p["attn_norm"], norm_eps)
    q, k, v = qkv_proj(p, xn, kv_local=kv_local, head_dim=head_dim,
                       rope=rope)
    attend = split_decode_attention if dist is not None and \
        dist.combine_axes else decode_attention
    out = attend(q, k, v, buf, view_shape, layer, rows=rows, tables=tables,
                 page_pos=page_pos, qpos=qpos, plan=plan, window=window,
                 dist=dist)
    return x + psum_tp(dense(out, p["o"]), dist)


def decode_attention(q, k, v, buf, view_shape, layer, *, rows, tables,
                     page_pos, qpos, plan, window=0, dist=None):
    """The attention of a padded T == 1 layer (``attn_decode``): this
    token's K/V (k/v (B,1,KVL,D)) written into its slot first, then one
    paged decode kernel call over the layer's view of ``buf``, read in
    place. q: (B,1,KVL,G,D). Returns (B, 1, KVL*G*D) in q.dtype."""
    A.write_kv_rows(buf, view_shape, layer, rows, k, v)
    out = paged_decode_attention(q[:, 0],
                                 page_view(buf, view_shape)[:, layer],
                                 tables, page_pos, qpos, window=window,
                                 plan=plan)
    return out.reshape(q.shape[0], 1, -1)


def strict_old(positions, window: int):
    """The paged kernel's (positions, window) for the reference's strict
    old part of a T == 1 step, ``qpos - window < slot_pos < qpos``: its
    rule ``slot_pos <= qpos'`` and ``> qpos' - window'`` at qpos' = qpos -
    1 and window' = window - 1 (a window of 1 sees no old slot, which
    window' 0, no window, cannot say)."""
    if window == 1:
        raise NotImplementedError("a sliding window of 1 token")
    return positions - 1, max(0, window - 1)


def split_decode_attention(q, k, v, buf, view_shape, layer, *, rows,
                           tables, page_pos, qpos, plan, window=0,
                           dist=None):
    """The attention of a padded T == 1 layer on a member of a combine
    group: one paged decode kernel call over this rank's pages, read in
    place, with its log-sum-exp, at the strict old part's visibility
    (``qpos`` and ``plan`` from ``strict_old``); the partials combined
    over ``dist.combine_axes``; then the token's own K/V merged once, on
    every rank with its own heads (the reference's fresh part: one slot,
    weight 1), and only then the K/V written (``rows``: the member whose
    page holds the slot; the others' go to the scratch page). The token
    is not written first as on one device: the combine would count it on
    the member that holds its slot with that member's q heads, which at
    K/V replicas are not every rank's. Returns (B, 1, KVL*G*D)."""
    b = q.shape[0]
    out, lse = paged_decode_attention(
        q[:, 0], page_view(buf, view_shape)[:, layer], tables, page_pos, qpos,
        window=max(0, window - 1), plan=plan, return_lse=True)
    o, m, l = combine_all(*A.lse_partials(out[:, :, :, None],
                                          lse[..., None]), dist)
    fresh = torch.ones((b, 1, 1), dtype=torch.bool, device=q.device)
    o, m, l = A.merge_partials(o, m, l, *A.attend_tokens(q, k, v, fresh))
    A.write_kv_rows(buf, view_shape, layer, rows, k, v)
    return A.finalize_softmax(o, l).reshape(b, 1, -1).to(q.dtype)


def attn_train(p, x, *, kv_local, head_dim, rope, window=0, causal=True,
               norm_eps=1e-5, dist=None):
    """Full/SWA self-attention for training (no cache): RMSNorm, the QKV
    projection with rope at positions ``arange(T)`` (``rope``: their
    ``rotary.rope_tables``), attention, the o-projection summed over the
    model axis of ``dist`` (this rank's heads: ``kv_local`` K/V heads and
    their padded q groups), and the residual.

    The reference scans 1024-row q chunks so that jnp's score tensor stays
    bounded; the flash kernel never materialises scores, so one call over
    all T rows computes the same function. q (B,T,KVL,G,D) goes to the
    kernel as (B*H, T, D) and k/v as (B*KVL, T, D): q head b*H + kvl*G + g
    reads kv head b*KVL + kvl, the kernel's h // G."""
    b, t, _ = x.shape
    xn = rms_norm(x, p["attn_norm"], norm_eps)
    q, k, v = qkv_proj(p, xn, kv_local=kv_local, head_dim=head_dim,
                       rope=rope)
    g = q.shape[3]
    qh = q.permute(0, 2, 3, 1, 4).contiguous().view(-1, t, head_dim)
    kh = k.permute(0, 2, 1, 3).contiguous().view(-1, t, head_dim)
    vh = v.permute(0, 2, 1, 3).contiguous().view(-1, t, head_dim)
    out = dense_flash_attention(qh, kh, vh, causal=causal, window=window)
    out = out.view(b, kv_local * g, t, head_dim).transpose(1, 2)
    return x + psum_tp(dense(out.reshape(b, t, -1), p["o"]), dist)


def mlp_block(p, x, norm_eps=1e-5, dist=None):
    """SwiGLU MLP: silu in fp32, times u in fp32, then cast (as the
    reference); this rank's ``d_ff`` columns, summed over the model axis
    of ``dist``."""
    xn = rms_norm(x, p["mlp_norm"], norm_eps)
    g = dense(xn, p["gate"])
    u = dense(xn, p["up"])
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return x + psum_tp(dense(h, p["down"]), dist)


def _bmm_f32(a, b):
    """(E, C, m) @ (E, m, n) of bf16 batches with an fp32 result: exact
    products summed in fp32 and never rounded to bf16 (the reference's
    ``preferred_element_type=float32``). cuBLAS writes fp32 from bf16
    operands (``out_dtype``, CUDA only); on the CPU the same function is
    the fp32 product of the bf16 values."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _BmmF32(torch.autograd.Function):
    """``_bmm_f32`` with a gradient (cuBLAS's ``out_dtype`` product has
    none): the fp32 upstream gradient times the other operand's values in
    fp32, rounded once to each operand's dtype, as autograd gives for the
    CPU's fp32 product of the bf16 values. Serving and training both call
    it; without a gradient it is ``_bmm_f32``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        return (torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype),
                torch.bmm(a.float().transpose(1, 2), g).to(b.dtype))


def moe_top_k(probs, k: int):
    """The k largest entries of each row of ``probs`` and their indices,
    largest first, exact ties broken toward the lower index: the rule of
    ``jax.lax.top_k``, which ``torch.topk`` does not promise. A stable
    descending sort keeps equal entries in index order."""
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], order[:, :k]


def moe_probs(tok, router):
    """The router's softmax over fp32 x fp32 logits: (N, E) fp32."""
    return torch.softmax(torch.matmul(tok.float(), router.float()), dim=-1)


def moe_route(tok, router, *, num_experts, top_k, capacity_factor=1.25):
    """The reference's routing rule for N tokens (``tok``: (N, d), the
    normed stream): fp32 x fp32 router logits, softmax, top-k, gates
    normalised by max(sum, 1e-9); ``cap = round(N * top_k / E *
    capacity_factor)`` (Python's round, half to even; at least 1); each
    (token, k) copy's place in its expert's queue counted over the
    flattened (N * K, E) one-hot in token-major order. Returns (gates
    (N, K) fp32, idx (N, K), slot (N * K,), cap): a kept copy's row
    ``expert * cap + place`` of the (E * cap) dispatch, a dropped copy's
    (place >= cap) the row ``E * cap`` past it."""
    n, e = tok.shape[0], num_experts
    gates, idx = moe_top_k(moe_probs(tok, router), top_k)        # (N, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(max(1, round(n * top_k / e * capacity_factor)))
    return gates, idx, moe_slots(idx, e, cap), cap


def moe_slots(idx, num_experts: int, cap: int):
    """(N * K,) dispatch rows of the (N, K) routed copies ``idx``: a kept
    copy's ``expert * cap + place``, its place in the expert's queue
    counted over the flattened copies in token-major order; a dropped
    copy's (place >= cap) the row ``num_experts * cap``."""
    e_flat = idx.reshape(-1)                                     # (N*K,)
    # the one-hot by comparison: F.one_hot range-checks on the host
    flat = (e_flat[:, None] == torch.arange(num_experts,
                                            device=idx.device)).long()
    pos = (torch.cumsum(flat, 0) * flat - 1).amax(-1)
    return torch.where(pos < cap, e_flat * cap + pos, num_experts * cap)


def moe_aux(probs, idx, *, num_experts, top_k, aux_weight):
    """The Switch load-balance loss at the reference's rounding points:
    ``aux_weight * E * sum_e mean(probs)_e * count_e / (N * K)``, the
    counts of each expert among the (N, K) routed copies exact in fp32."""
    n, e = probs.shape[0], num_experts
    me = probs.mean(0)
    count = (idx.reshape(-1)[:, None] == torch.arange(
        e, device=idx.device)).sum(0).float()
    return (aux_weight * e) * torch.sum(me * (count / (n * top_k)))


def moe_block(p, x, *, num_experts, top_k, capacity_factor=1.25,
              norm_eps=1e-5, drops=None, aux_weight=None, dist=None):
    """GShard capacity MoE (the reference's ``moe_block``). Serving drops
    the aux loss and gets x back; training passes ``aux_weight`` and gets
    (x, aux) (``moe_aux``, over this rank's tokens).

    Every token of the (B, T) stream is routed (``moe_route``), pads and
    killed segments included: N = B * T sets the capacity, and a pad ahead
    of a real token in the flattened stream can push that token's copy
    past it; a dropped copy adds nothing. g and u come out of the expert
    products in fp32, ``silu(g) * u`` is rounded to bf16 once, the down
    product once, and the gated sum of a token's K rows is fp32, then
    bf16. The (E, cap, d) dispatch is zero where no copy landed, and the
    products run over it all, as the reference's do. ``drops`` (a list)
    gets this call's count of dropped copies as a device tensor (no host
    sync).

    On a mesh (``dist``) the experts are split over the data axis and
    each expert's ffe over the model axis (``p``'s expert leaves are this
    rank's (E / dp, d, ffe / tp) parts): the capacity comes from this
    rank's N tokens, the (E, cap, d) dispatch goes out by an all-to-all
    over "data" into (E / dp, dp * cap, d), the down product is summed
    over "model" in fp32 and rounded once, and a second all-to-all brings
    each copy's row home. At one data rank and one model rank no
    collective runs and the bytes are the single-device path's."""
    b, t, d = x.shape
    e = num_experts
    ep = 1 if dist is None else dist.dp
    tp = 1 if dist is None else dist.tp
    if e % ep:
        raise ValueError(f"{e} experts do not split over {ep} data ranks")
    e_local = e // ep
    xn = rms_norm(x, p["mlp_norm"], norm_eps)
    tok = xn.reshape(b * t, d)
    gates, idx, slot, cap = moe_route(tok, p["router"], num_experts=e,
                                      top_k=top_k,
                                      capacity_factor=capacity_factor)
    if drops is not None:
        drops.append((slot == e * cap).sum())
    dispatch = tok.new_zeros((e * cap + 1, d))
    dispatch.index_copy_(0, slot, tok.repeat_interleave(top_k, dim=0))
    disp = dispatch[:-1].view(e, cap, d)
    if ep > 1:
        # (E, cap, d) -> (ep, E_local, cap, d) -> (E_local, ep * cap, d)
        disp = all_to_all_dp(disp.view(ep, e_local, cap, d), dist)
        disp = disp.transpose(0, 1).reshape(e_local, ep * cap, d)
    g = _BmmF32.apply(disp, p["moe_gate"].to(x.dtype))
    u = _BmmF32.apply(disp, p["moe_up"].to(x.dtype))
    h = (F.silu(g) * u).to(x.dtype)
    if tp > 1:
        y = psum_tp(_BmmF32.apply(h, p["moe_down"].to(x.dtype)),
                    dist).to(x.dtype)
    else:
        y = torch.bmm(h, p["moe_down"].to(x.dtype))      # (E_local, C', d)
    if ep > 1:
        y = all_to_all_dp(y.view(e_local, ep, cap, d).transpose(0, 1), dist)
    back = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    gathered = back.index_select(0, slot).view(b * t, top_k, d)
    out = (gathered.float() * gates[..., None]).sum(1).to(x.dtype)
    out = x + out.view(b, t, d)
    if aux_weight is None:
        return out
    return out, moe_aux(moe_probs(tok, p["router"]), idx, num_experts=e,
                        top_k=top_k, aux_weight=aux_weight)
