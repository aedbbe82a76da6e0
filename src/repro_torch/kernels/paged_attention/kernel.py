"""Paged decode attention: the CUDA kernel's wrapper, its per-step plan and
its plain PyTorch version.

The kernel (``csrc/paged_decode.cu``) replaces the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_decode_attention`` with the
same contract: one query token per sequence attends its pages through the
block table, reading ONE layer's strided view of the unified buffer where it
lies (no gather, no contiguous copy of the pool).

Which table entries a row must read, and how they are split over blocks,
depends only on the tables, page starts and positions, which every layer
of a serve step shares: ``paged_decode_plan`` works it out once per step
and every layer's call takes it. Head dim 120 (h2o-danube-3-4b) runs the
D 128 instance with the true head dim at run time: pages stay 120 wide in
the pool and are read in place.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import build
from ..scratch import stream_scratch

NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 120, 128)
MAX_G = 16

# The split rule (``paged_decode_plan``): a row's visible pages go to at
# least PAGES_PER_SPLIT pages a block, over at most max_splits(B) blocks,
# which aims at about SPLIT_BLOCKS blocks for the whole batch (several for
# each of the H100's 132 SMs) and never more than MAX_SPLITS for a row, so
# the block that combines a row's partials reads a bounded amount.
PAGES_PER_SPLIT = 8
SPLIT_BLOCKS = 512
MAX_SPLITS = 64
# The kernel's blocks (csrc/paged_decode.cu): 8 warps; HG <= 8 kv heads
# (head_group: stages of at most STAGE_BYTES, and at least MIN_UNITS
# (row, head group) pairs in the batch) and 8 q heads of each a block; a
# ring of up to 8 stages in about RING_BYTES of shared memory (two blocks
# an SM), and at least 8 / HG: a step takes one page to each warp of a
# head. The constants were chosen by timing the alternatives on the card
# (scripts/sweep_paged_split.py).
WARPS = 8
Q_HEADS = 8
STAGE_BYTES = 40 << 10
MIN_UNITS = 16
RING_BYTES = 100 << 10
MAX_RING_BYTES = 200 << 10


class PagedDecodePlan(NamedTuple):
    """What every layer of a T == 1 step shares (``paged_decode_plan``).

    pages: (B, P, 2) int32, per row the (page id clamped to >= 0, page
    start) of the table entries it reads, in table order, the first
    count[b] valid; count: (B,) int32; work: (B * n_splits(B, P), 8) int32,
    the split work list: per item (row, split | the row's splits << 16,
    first page, pages, the first page's id and start, 0, 0), rows in order
    and each row's splits in order, then (-1, 0, ...) to the end. ``tpp``
    and ``window`` are the ones it was built for."""
    pages: torch.Tensor
    count: torch.Tensor
    work: torch.Tensor
    tpp: int
    window: int


def max_splits(b):
    """The most blocks one of ``b`` rows is split over."""
    return max(1, min(MAX_SPLITS, -(-SPLIT_BLOCKS // b)))


def n_splits(b, p):
    """The most splits a row of a (``b``, ``p``) table can get."""
    return min(max_splits(b), -(-p // PAGES_PER_SPLIT))


def paged_decode_plan(tables, page_pos, positions, tpp, window=0):
    """The per-step plan of the paged decode kernel, from torch ops on the
    tables' device with no host sync.

    A table entry is read iff one of its slots is visible (``page_pos + t
    <= qpos``, and ``> qpos - window`` with a window); a row with no
    visible slot reads all P entries, which keeps the contract's mean(V)
    over every slot. An entry with no visible slot changes nothing for a
    row that sees some slot: its scores are -1e30 and weigh exp(-1e30 - m)
    = 0 once a visible one has set m. The entries are compacted in table
    order. A row of n entries is split into ceil(n / pps) blocks of pps
    pages, pps = max(PAGES_PER_SPLIT, ceil(n / max_splits(B))): the split
    of a row depends on its own entries and the batch size only."""
    b, p = tables.shape
    qpos = positions[:, None]
    vis = page_pos <= qpos
    if window:
        vis &= page_pos + (tpp - 1) > qpos - window
    take = vis | ~vis.any(1, keepdim=True)
    order = torch.sort((~take).to(torch.uint8), dim=1, stable=True).indices
    pages = torch.stack([tables.clamp(min=0).gather(1, order),
                         page_pos.gather(1, order)], -1).to(torch.int32)
    count = take.sum(1)
    cap = max_splits(b)
    pps = ((count + cap - 1) // cap).clamp(min=PAGES_PER_SPLIT)
    splits = (count + pps - 1) // pps
    # item k belongs to the row whose splits' running sum first exceeds k
    ends = splits.cumsum(0)
    k = torch.arange(b * n_splits(b, p), device=tables.device)
    row = torch.searchsorted(ends, k, right=True)
    live = row < b
    row = row.clamp(max=b - 1)
    split = k - (ends - splits)[row]
    first = split * pps[row] * live
    page0 = pages[row, first.clamp(max=p - 1)] * live[:, None]
    zero = torch.zeros_like(first)
    work = torch.stack([torch.where(live, row, -1),
                        (split | splits[row] << 16) * live, first,
                        torch.minimum(pps[row], count[row] - first) * live,
                        page0[:, 0], page0[:, 1], zero, zero], -1)
    return PagedDecodePlan(pages.contiguous(), count.to(torch.int32),
                           work.to(torch.int32).contiguous(), int(tpp),
                           int(window))


def paged_decode_attention_plain(q, kv_view, tables, page_pos, positions, *,
                                 window=0, plan=None, return_lse=False):
    """The reference's ``paged_decode_attention_ref``: q (B, KVL, G, D);
    kv_view (VP, 2, TPP, KVL, D); tables/page_pos (B, P); positions (B,).
    Entries < 0 clamp to page 0; a slot is visible iff slot_pos <= qpos
    (and > qpos - window). Masked scores are -1e30 with no zero-row guard,
    so a row with no visible slot returns mean(V) over its P*TPP slots.
    In a row that sees some slot, masked slots' V enter as zeros, as the
    kernel (which never reads them) has it: page 0 may hold another type's
    bytes, and their probability 0 times a non-finite value would still
    be NaN. With a ``plan`` only the entries it lists are read, as the
    kernel reads them: the same function. Returns (B, KVL, G, D) in
    q.dtype, and with ``return_lse`` also the natural-log log-sum-exp of
    each (row, head)'s scaled scores over the slots it sees, (B, KVL, G)
    fp32, -inf for a row that sees nothing."""
    b, kvl, g, d = q.shape
    tpp = kv_view.shape[2]
    p = tables.shape[1]
    listed = None
    if plan is not None:
        tables, page_pos = plan.pages[..., 0], plan.pages[..., 1]
        listed = torch.arange(p, device=q.device)[None] < \
            plan.count[:, None]
        listed = listed[:, :, None].expand(b, p, tpp).reshape(b, p * tpp)
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
    if listed is not None:
        mask &= listed
        logit = logit.masked_fill(~listed[:, None, None, :], -torch.inf)
    mx = logit.amax(-1, keepdim=True)
    pr = torch.exp(logit - mx)
    z = pr.sum(-1, keepdim=True)
    pr = pr / torch.clamp(z, min=1e-30)
    seen = mask.any(-1, keepdim=True)
    unread = ~mask & seen
    if listed is not None:
        unread |= ~listed
    v = v.masked_fill(unread[:, :, None, None], 0)
    out = torch.einsum("bkgs,bskd->bkgd", pr, v).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(seen[:, None, None], mx + torch.log(z),
                      torch.full((), -torch.inf, device=q.device))
    return out, lse[..., 0]


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _stage_bytes(hg, tpp, d):
    """A ring stage: a page's TPP K and TPP V rows of ``hg`` heads, as the
    kernel's page map lands them (per column chunk of 64, 1024-byte
    aligned). Head dim 120 runs the D 128 instance: its boxes are 128
    columns wide, 120-127 read as zeros."""
    d = 128 if d == 120 else d
    cw = min(d, 64)
    return d // cw * -(-(2 * hg * tpp * cw * 2) // 1024) * 1024


def head_group(b, kvl, tpp, d):
    """kv heads a block takes: the largest power of two <= 8 that divides
    KVL, keeps a stage within STAGE_BYTES and gives the batch's rows at
    least MIN_UNITS head groups in all, else 1 (granite-3-2b's 8 rows: 4;
    zamba2-1.2b's: 8; D 128: 4)."""
    hg = WARPS
    while hg > 1 and (kvl % hg or _stage_bytes(hg, tpp, d) > STAGE_BYTES
                      or b * kvl // hg < MIN_UNITS):
        hg //= 2
    return hg


@functools.lru_cache(maxsize=256)
def launch_shape(b, p, kvl, g, d, tpp):
    """The kernel's launch for these sizes: (kv heads a block, blocks a
    work item, the most splits of a row, ring stages, floats of split
    partials). A step takes 8 / HG pages, so the ring holds at least as
    many stages."""
    hg = head_group(b, kvl, tpp, d)
    stage = _stage_bytes(hg, tpp, d)
    stages = max(2, WARPS // hg, min(8, RING_BYTES // stage))
    if stages * stage > MAX_RING_BYTES:
        raise ValueError(f"pages of {tpp} slots x D {d} do not fit the "
                         f"ring ({stages} stages of {stage} bytes)")
    units = kvl // hg * -(-g // Q_HEADS)
    n_split = n_splits(b, p)
    part = b * units * n_split * hg * min(g, Q_HEADS) * (d + 2)
    return hg, units, n_split, stages, part if n_split > 1 else 0


def check_inputs(q, kv_view, tables, page_pos, positions, *, window=0,
                 plan=None):
    """Validate the kernel's inputs (any device) and return its launch
    sizes (b, kvl, g, d, p, tpp). q must be contiguous; kv_view may be a
    strided layer view of the pool, with a slot's (KVL, D) contiguous and
    every (page, K/V, slot) row 16-byte aligned; the int32 metadata must be
    contiguous, and a ``plan`` must be ``paged_decode_plan``'s for these
    tables, page size and window. Every layer's call of a serve step makes
    these checks, so each tensor is tested in one condition, and explained
    only when it fails."""
    b, kvl, g, d = q.shape
    vp, two, tpp = kv_view.shape[:3]
    p = tables.shape[1] if tables.dim() == 2 else -1
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"{g} q heads per kv head, at most {MAX_G}")
    dev = q.device
    bf16, i32 = torch.bfloat16, torch.int32
    if q.dtype is not bf16 or q.device != dev or not q.is_contiguous() or \
            q.data_ptr() % 16:
        _check("q", q, bf16, (b, kvl, g, d), dev)
        raise ValueError("q: must be contiguous and 16-byte aligned")
    st = kv_view.stride()
    if kv_view.dtype is not bf16 or kv_view.device != dev or \
            kv_view.shape[3:] != (kvl, d):
        _check("kv_view", kv_view, bf16, (vp, 2, tpp, kvl, d), dev)
    if st[4] != 1 or st[3] != d or kv_view.data_ptr() % 16 or \
            st[0] % 8 or st[1] % 8 or st[2] % 8:
        raise ValueError(f"kv_view: a slot's heads must be contiguous and "
                         f"16-byte aligned (strides {st})")
    for name, a, shape in (("tables", tables, (b, p)),
                           ("page_pos", page_pos, (b, p)),
                           ("positions", positions, (b,))):
        if a.dtype is not i32 or a.shape != shape or a.device != dev or \
                not a.is_contiguous():
            _check(name, a, i32, shape, dev)
            raise ValueError(f"{name}: must be contiguous")
    if p < 1 or vp < 1 or not 1 <= tpp <= 256 or two != 2:
        raise ValueError(f"empty table or pool, or pages of over 256 slots "
                         f"(P={p}, VP={vp}, TPP={tpp})")
    launch_shape(b, p, kvl, g, d, tpp)
    if plan is not None:
        for name, a, shape in (("plan.pages", plan.pages, (b, p, 2)),
                               ("plan.count", plan.count, (b,)),
                               ("plan.work", plan.work,
                                (b * n_splits(b, p), 8))):
            if a.dtype is not i32 or a.shape != shape or a.device != dev or \
                    not a.is_contiguous() or a.data_ptr() % 16:
                _check(name, a, i32, shape, dev)
                raise ValueError(f"{name}: must be contiguous and 16-byte "
                                 f"aligned")
        if plan.tpp != tpp or plan.window != window:
            raise ValueError(f"plan built for TPP {plan.tpp}, window "
                             f"{plan.window}; called with {tpp}, {window}")
    return b, kvl, g, d, p, tpp


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load("paged_decode")
    fn = lib.paged_decode_bf16
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q, kv_view, tables, page_pos, positions, *,
                           window=0, plan=None, out=None, return_lse=False):
    """Paged decode attention over one layer of the unified buffer.

    q: (B, KVL, G, D) bf16; kv_view: (VP, 2, TPP, KVL, D) bf16, typically
    one layer of the layout's view of the unified buffer,
    ``core.layout.page_view(buffer, view_shape)[:, layer]``: contiguous
    pages under the LCM geometry, pages a large page apart under MAX (read
    in place, never copied; the TMA map takes the page stride in bytes,
    64-bit, and a page id is a coordinate, never multiplied in 32 bits);
    tables/page_pos: (B, P) int32; positions: (B,) int32;
    ``plan``: ``paged_decode_plan(tables, page_pos, positions, TPP,
    window)``, built here when not given. Returns (B, KVL, G, D) bf16, in
    ``out`` (CUDA only; contiguous, 16-byte aligned) when given. With
    ``return_lse`` the call also returns each (row, head)'s natural-log
    log-sum-exp of its scaled scores over the slots it sees, (B, KVL, G)
    fp32, -inf for a row that sees nothing (whose output stays mean(V)):
    (out, lse). Without it the launch is the same as before.

    Tensors on the CPU take the plain version (the kernel has no CPU
    form); CUDA tensors launch the kernel on the current stream or raise.
    ``paged_decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kv_view, tables, page_pos,
                                            positions, window=window,
                                            plan=plan, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, kvl, g, d, p, tpp = check_inputs(q, kv_view, tables, page_pos,
                                        positions, window=window, plan=plan)
    if plan is None:
        plan = paged_decode_plan(tables, page_pos, positions, tpp, window)
    hg, units, n_split, stages, n_part = launch_shape(b, p, kvl, g, d, tpp)
    dev = q.device
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if out is None:
        out = torch.empty_like(q)
    elif out.dtype is not torch.bfloat16 or out.shape != q.shape or \
            out.device != dev or not out.is_contiguous() or \
            out.data_ptr() % 16:
        _check("out", out, torch.bfloat16, tuple(q.shape), dev)
        raise ValueError("out: must be contiguous and 16-byte aligned")
    lse = torch.empty((b, kvl, g), dtype=torch.float32, device=dev) \
        if return_lse else None
    part = counters = None
    if n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
        counters = stream_scratch(dev, stream, b * units)
    strides = (ctypes.c_int64 * 4)(*(kv_view.stride(i) for i in range(4)))
    args = (q.data_ptr(), kv_view.data_ptr(), plan.pages.data_ptr(),
            plan.work.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            ctypes.addressof(strides), b, kv_view.shape[0], kvl, g, d, p, tpp,
            int(window), hg, n_split, stages, stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.paged_decode_bf16(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.paged_decode_bf16(*args)
    if rc != 0:
        msg = lib.paged_decode_error_string(rc).decode()
        raise RuntimeError(f"paged_decode launch failed: {msg} ({rc})")
    paged_decode_attention.launches += 1
    return (out, lse) if return_lse else out


paged_decode_attention.launches = 0
