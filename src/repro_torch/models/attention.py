"""Attention math and the paged unified-buffer reads/writes
(``repro/models/attention.py``): materialized and chunked (flash)
attention with partial-softmax merging, page gathers and K/V writes.

Local GQA convention: q is (B, T, KVL, G, D) — KVL kv heads, G q heads per
kv head; k/v are (B, S, KVL, D).

The unified buffer is one flat bf16 tensor. Each attention type views it as
(VP, L, 2, TPP, KVL, D) at its page stride (``core.layout.page_view``: the
page itself under the LCM geometry, the large page under MAX); gathers
copy pages out (``index_select``), writes go in place (``index_copy_`` at
int64 unit offsets) on the persistent buffer, so a caller must issue every
gather of a cycle before any of its writes.
"""
from __future__ import annotations

import torch

from ..core.layout import page_stride, page_view

NEG_INF = -1e30


def group_q(q: torch.Tensor, kv_local: int) -> torch.Tensor:
    """(B, T, q_local, D) -> (B, T, KVL, G, D)."""
    b, t, ql, d = q.shape
    assert ql % kv_local == 0
    return q.reshape(b, t, kv_local, ql // kv_local, d)


def segment_mask(q_seg, q_pos, kv_seg, kv_pos, *, window=0, chunk_start=None):
    """Packed-stream mask: token i sees slot j iff same segment and j is not
    in i's future (``kv_pos < chunk_start`` when ``chunk_start`` is given,
    else ``kv_pos <= q_pos``); window > 0 adds ``kv_pos > q_pos - window``.
    q_seg/q_pos: (B, T); kv_seg/kv_pos: (B, S). Returns (B, T, S) bool.
    Ids compare with ``==`` exactly as the reference does, so q pads (-1)
    see kv slots tagged -1; kv pads carry -2."""
    mask = q_seg[:, :, None] == kv_seg[:, None, :]
    if chunk_start is not None:
        mask &= kv_pos[:, None, :] < chunk_start[:, :, None]
    else:
        mask &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    return mask


def flash_state(q):
    """(fp32 scaled q, initial (m, l, acc)) of a chunked online softmax
    over q (B, T, KVL, G, D). q is scaled in its own dtype, as the
    reference does."""
    b, t, kvl, g, d = q.shape
    qf = (q * (1.0 / d ** 0.5)).float()
    return qf, (torch.full((b, kvl, g, t), NEG_INF, device=q.device),
                torch.zeros((b, kvl, g, t), device=q.device),
                torch.zeros((b, kvl, g, t, d), device=q.device))


def flash_block(state, qf, kb, vb, mask):
    """One kv block of the online softmax: kb/vb (B, blk, KVL, D), mask
    broadcastable to (B, KVL, G, T, blk). The probabilities are rounded to
    v's dtype before the PV product, as the reference does."""
    m, l, acc = state
    logit = torch.einsum("btkgd,bjkd->bkgtj", qf, kb.float())
    logit = torch.where(mask, logit, torch.full((), NEG_INF,
                                                device=logit.device))
    m_new = torch.maximum(m, logit.amax(dim=-1))
    p = torch.exp(logit - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bkgtj,bjkd->bkgtd", p.to(vb.dtype).float(), vb.float())
    return m_new, l, acc


def flash_attention_partials(q, k, v, *, window=0, block=512):
    """Causal chunked online-softmax attention over kv blocks of ``block``
    slots (the reference's ``flash_attention_partials`` with
    ``causal=True``, the padded serve path's fresh part for T > 256).
    Returns un-normalized fp32 partials (acc (B,KVL,G,T,D), m, l).
    q: (B, T, KVL, G, D); k, v: (B, S, KVL, D). Row i sits at position i,
    column j at j; window > 0 keeps positions > i - window."""
    t, s = q.shape[1], k.shape[1]
    qf, state = flash_state(q)
    q_pos = torch.arange(t, device=q.device)
    for j0 in range(0, s, block):
        kv_pos = torch.arange(j0, min(j0 + block, s), device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        state = flash_block(state, qf, k[:, j0:j0 + block],
                            v[:, j0:j0 + block], mask[None, None, None])
    m, l, acc = state
    return acc, m, l


def merge_partials(o1, m1, l1, o2, m2, l2):
    """Merge two partial-softmax results. A side may carry m -inf (a
    kernel's log-sum-exp of nothing, ``lse_partials``): it weighs 0, and
    a row neither side saw stays 0."""
    m = torch.maximum(m1, m2)
    o1, l1 = rescale_partials(o1, m1, l1, m)
    o2, l2 = rescale_partials(o2, m2, l2, m)
    return o1 + o2, m, l1 + l2


def rescale_partials(o, m, l, gmax):
    """The local half of the reference's ``combine_partials``: this
    member's (o, l) rescaled to the group's max ``gmax`` of ``m`` (the
    caller sums them over the group). A row that no member has seen
    (``gmax`` -inf, the kernels' log-sum-exp of nothing) is rescaled by
    0 instead of NaN."""
    mu = torch.where(gmax == -torch.inf, torch.zeros_like(gmax), gmax)
    corr = torch.exp(m - mu)
    return o * corr[..., None], l * corr


def replica_groups(kv_tp: int, repl: int):
    """Model-axis index groups [[kg*repl .. kg*repl+repl-1] ...]: the K/V
    replica sets that jointly hold one kv-head group's pages (the
    reference's ``replica_groups``)."""
    return [[kg * repl + r for r in range(repl)] for kg in range(kv_tp)]


def lse_partials(out, lse):
    """Partials (o, m, l) of a kernel's normalised output ``out`` (...,
    D) and its log-sum-exp ``lse`` (...): o = out in fp32, m = lse, l = 1,
    so that ``combine_partials`` and ``merge_partials`` weigh it by
    exp(lse). A row that saw nothing (lse -inf) gets o = l = 0: its
    output (zeros, or the paged kernel's mean(V), which may be NaN over
    a hybrid pool's state pages) weighs nothing."""
    seen = torch.isfinite(lse)
    o = torch.where(seen[..., None], out.float(),
                    torch.zeros((), device=out.device))
    return o, lse, seen.float()


def attend_tokens(q, k, v, mask):
    """Materialized attention. q: (B, T, KVL, G, D); k/v: (B, S, KVL, D);
    mask: (B, T, S) bool. Returns fp32 partials (out (B,KVL,G,T,D), m, l)."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    qs = (q * scale).float()
    logit = torch.einsum("btkgd,bskd->bkgts", qs, k.float())
    logit = torch.where(mask[:, None, None], logit,
                        torch.full((), NEG_INF, device=logit.device))
    m = logit.amax(dim=-1)
    p = torch.exp(logit - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype).float(), v.float())
    return out, m, l


def finalize_softmax(out, l):
    out = out / torch.clamp(l[..., None], min=1e-30)
    return torch.movedim(out, 3, 1)                         # (B, T, KVL, G, D)


def view_offset(view_shape, eid, layer, sel, slot):
    """Flat-buffer offset of (eid, layer, sel, slot, 0, 0) in an attention
    view (VP, L, 2, TPP, KVL, D) whose pages sit ``page_stride`` units
    apart, in int64: pools exceed 2^31 units."""
    vp, nl, _, tpp, kvl, d = view_shape
    eid = eid.long() if isinstance(eid, torch.Tensor) else eid
    return eid * page_stride(view_shape) + \
        ((((layer * 2 + sel) * tpp) + slot) * kvl * d)


def page_index(tables):
    """(flat page ids with pads clamped to 0, mask of the invalid entries
    broadcastable over gathered pages) of a (B, P) table — the same for
    every layer of a step."""
    return tables.clamp(min=0).reshape(-1).long(), \
        (tables < 0)[:, :, None, None, None, None]


def gather_pages(view, tables, layer, index=None):
    """view: (VP, L, 2, TPP, KVL, D); tables: (B, P) int (entries < 0 are
    pads/frees). Returns k, v: (B, P*TPP, KVL, D) copies. ``index`` is
    ``page_index(tables)``, when the caller has it already.

    Invalid entries read as ZEROS: a clamped read would hand arbitrary
    units of the unified buffer (other types' pages, fp32 state pairs that
    decode as NaN in bf16) to the softmax, and NaN survives masking."""
    idx, invalid = page_index(tables) if index is None else index
    lview = view[:, layer]                                  # (VP,2,TPP,KVL,D)
    b, p = tables.shape
    pages = lview.index_select(0, idx).view(b, p, *lview.shape[1:])
    pages.masked_fill_(invalid, 0)
    _, _, _, tpp, kvl, d = pages.shape
    return pages[:, :, 0].reshape(b, p * tpp, kvl, d), \
        pages[:, :, 1].reshape(b, p * tpp, kvl, d)


def kv_rows(view_shape, eids, slots):
    """The int64 unit offset (``view_offset``) of each token's K slot in
    layer 0 of an attention view; its V slot is TPP slots further and
    layer l 2*TPP*l slots further. eids < 0 (dropped writes) point into the
    SCRATCH page at the buffer tail, which the runner reserves and no table
    ever names: a negative index would wrap in torch and an out-of-range
    one faults on CUDA, so neither may reach the scatter (the reference's
    ``_write_token_kv_dus`` does the same)."""
    vp = view_shape[0]
    eid = torch.where(eids < 0, vp - 1, eids).reshape(-1).long()
    return view_offset(view_shape, eid, 0, 0, slots.reshape(-1).long())


def write_kv_rows(buf, view_shape, layer, rows, k_new, v_new):
    """Write K/V at ``rows`` (``kv_rows``) of one layer in place on the
    flat ``buf``: ``index_copy_`` of whole (KVL*D)-unit slots into a view
    of ``buf`` with a slot starting at every unit (``unfold``), so a page
    stride need not be a multiple of a slot (zamba2's 20,886,016-unit MAX
    page is not a multiple of its 2,048-unit slot). k_new/v_new:
    (..., KVL, D) with one token per row entry."""
    vp, nl, _, tpp, kvl, d = view_shape
    slots = buf.unfold(0, kvl * d, 1)
    for sel, data in ((0, k_new), (1, v_new)):
        data = data.reshape(-1, kvl * d)
        if data.dtype != buf.dtype:
            data = data.to(buf.dtype)
        slots.index_copy_(0, rows + (layer * 2 + sel) * tpp * kvl * d, data)
    return buf


def write_token_kv(buf, view_shape, layer, eids, slots, k_new, v_new):
    """Write T new tokens' K/V into their pages, in place on the flat
    ``buf``. eids: (B, T) exec page id per token (< 0 = drop, to the
    scratch page); slots: (B, T) slot within the page; k_new/v_new:
    (B, T, KVL, D)."""
    return write_kv_rows(buf, view_shape, layer,
                         kv_rows(view_shape, eids, slots), k_new, v_new)


def bf16_pair_to_f32(x: torch.Tensor) -> torch.Tensor:
    """(..., 2U) bf16 -> (..., U) fp32 holding the same bytes: fp32
    recurrent state lives bit-exact in the bf16 unified buffer, one fp32
    unit per two buffer units. On the little-endian byte order of both
    devices this is the reference's ``bitcast_convert_type`` of (U, 2)."""
    assert x.dtype == torch.bfloat16 and x.shape[-1] % 2 == 0
    return x.contiguous().view(torch.float32)


def f32_to_bf16_pair(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``bf16_pair_to_f32``: (..., U) fp32 -> (..., 2U)."""
    assert x.dtype == torch.float32
    return x.contiguous().view(torch.bfloat16)


def read_state(view, layer, eids):
    """State view: (VP, L, 2U) bf16; eids: (B,) int. Returns (B, U) fp32.
    Invalid (< 0: pad, killed) eids read as zero state: a clamped gather
    would hand foreign bytes that decode as NaN to the recurrent scan."""
    st = view[:, layer].index_select(0, eids.clamp(min=0).long())
    st = st.masked_fill((eids < 0)[:, None], 0)
    return bf16_pair_to_f32(st)


def write_state(buf, view_shape, layer, eids, state):
    """Store (B, U) fp32 ``state`` bit-exact as bf16 pairs into one layer
    of the state view (VP, L, 2U) at its page stride, in place on the flat
    ``buf``. eids < 0 go to the SCRATCH page at the buffer tail
    (``kv_rows``): the reference drops them, and no table ever names that
    page."""
    data = f32_to_bf16_pair(state.float())
    eid = torch.where(eids < 0, view_shape[0] - 1, eids).long()
    page_view(buf, view_shape)[:, layer].index_copy_(0, eid, data)
    return buf
