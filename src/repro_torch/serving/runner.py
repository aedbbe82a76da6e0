"""ModelRunner: builds device batches from Jenga manager state and issues
the serve step on a torch device (``repro/serving/runner.py``).

One dispatch executes a whole scheduler step — any number of concurrent
prefill chunks plus all decodes — in one of two layouts:

* PACKED (default): the step is flattened into ONE
  ``(total_tokens_bucket,)`` token stream with per-token ``segment_ids``,
  absolute ``positions``, per-token KV write targets, and per-segment
  ``(start, last_tok)`` metadata; per-type page tables are likewise
  flattened into one page stream with per-page owning segments.
* PADDED: one row per sequence, padded to the ``(B=_pow2(n),
  T=_pow2(max_chunk))`` bucket with SENTINEL positions at pads. A T == 1
  bucket reads its pages in place through the paged decode kernel.

A step is three phases, which the async engine drives separately:

  * ``prepare`` builds the whole batch as HOST numpy (``PreparedStep``) —
    copied from the reference unchanged;
  * ``dispatch`` uploads the batch, zeroes fresh pages, and issues the
    serve step and the fused greedy tail on the current CUDA stream
    without a host sync (no ``.item()``, ``.cpu()`` or ``.tolist()``);
    the ``StepHandle`` holds device tensors;
  * ``fetch`` / ``fetch_tokens`` are the one blocking point.

The port runs eagerly: there is no jit cache and no retrace. The unified
buffer is one flat bf16 tensor that the serve step and the page copies
update in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.layout import UnifiedLayout
from ..core.manager import JengaKVCacheManager, StateCopyOp
from ..core.request import SequenceState
from ..models.lm import DecodeBatch
from .request import Request
from .sampler import inject_tokens, rid_hash, sample_batch

SENTINEL_POS = np.int32(1 << 29)


def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _tok_bucket(n: int) -> int:
    """Packed-stream token bucket: pow2 below 16 (decode-only steps hit
    exact small buckets), then multiples of 16 — bounded retraces with
    <= 15 pad slots per dispatch instead of pow2's up-to-50% waste."""
    if n <= 16:
        return _pow2(n)
    return 16 * (-(-n // 16))


def _norm_items(items) -> List[Tuple[Request, int, int]]:
    """Normalize plan items to (request, num_tokens, start): 2-tuples keep
    the synchronous default ``start = seq.num_computed``; the async engine
    passes explicit starts that run ahead of ``num_computed`` while the
    previous step is still in flight."""
    out = []
    for it in items:
        r, nt = it[0], it[1]
        start = it[2] if len(it) > 2 and it[2] >= 0 else r.seq.num_computed
        out.append((r, nt, start))
    return out


@dataclasses.dataclass
class StepHandle:
    """Device tensors of one dispatched step: the per-segment fp32 logits
    and, when the dispatch carried the fused greedy tail, the sampled
    token vector. ``fetch_tokens`` blocks on 4 bytes per segment;
    ``fetch`` on the full ``(segments, v_pad)`` fp32 matrix."""

    logits: object
    tokens: object = None
    n: int = 0

@dataclasses.dataclass
class PreparedStep:
    """One plan's device batch, still host-side numpy (phase 1 of 3).

    ``pending`` lists segment indices whose (single) decode token id was
    not known at build time — the in-flight step samples it; the engine
    calls ``patch_token`` once the sample lands, or ``kill_segment`` if
    the request turned out to have finished instead. With device
    sampling, pending decode rows are instead moved to ``board_fed``:
    their token id is read ON DEVICE from the sampled-token board
    (``tok_src`` holds the board slot per token position, -1 elsewhere),
    so no host patch is needed and >1 step can stay in flight."""

    arrs: Dict[str, object]           # DecodeBatch field -> numpy / dict
    info: dict
    items: List[Tuple[Request, int, int]]
    packed: bool
    pending: List[int]
    dead: set = dataclasses.field(default_factory=set)
    samp: Optional[dict] = None       # fused sampling tail metadata
    tok_src: Optional[np.ndarray] = None
    board_fed: List[int] = dataclasses.field(default_factory=list)

    @property
    def n(self) -> int:
        return self.info["n"]

    def patch_token(self, si: int, tok: int) -> None:
        """Fill segment ``si``'s (single) decode token id."""
        if self.packed:
            off, nt = self.info["seg_off"][si]
            assert nt == 1, (si, nt)
            self.arrs["tokens"][0, off] = tok
        else:
            self.arrs["tokens"][si, 0] = tok
        if si in self.pending:
            self.pending.remove(si)

    def kill_segment(self, si: int) -> None:
        """Neutralize segment ``si`` to pad semantics: the request finished
        at the in-flight step, so its speculative slot must compute nothing
        and write nowhere. Its logits row becomes garbage (the engine skips
        it); no live token can see a pad, so the other segments' outputs
        are bit-identical with or without the dead slot."""
        self.dead.add(si)
        if si in self.pending:
            self.pending.remove(si)
        if si in self.board_fed:
            self.board_fed.remove(si)
        if self.samp is not None:
            # dead segment: no board write, no random draw needed
            self.samp["dst"][si] = -1
            self.samp["temps"][si] = 0.0
        a = self.arrs
        if self.packed:
            off, nt = self.info["seg_off"][si]
            sl = slice(off, off + nt)
            a["tokens"][0, sl] = 0
            a["positions"][0, sl] = SENTINEL_POS
            a["seg_ids"][0, sl] = -1
            a["chunk_start"][0, sl] = SENTINEL_POS
            if a["mm_mask"] is not None:
                a["mm_mask"][0, sl] = False
            for v in a["write_eids"].values():
                v[0, 0, 0, sl] = -1
            for v in a["page_seg"].values():
                np.place(v, v == si, -2)
        else:
            a["tokens"][si, :] = 0
            a["positions"][si, :] = SENTINEL_POS
            a["seq_lens"][si] = 1
            a["last_idx"][si] = 0
            if a["mm_mask"] is not None:
                a["mm_mask"][si, :] = False
            for v in a["write_eids"].values():
                v[0, 0, si, :] = -1
            for v in a["tables"].values():
                v[0, 0, si, :] = -1
            for v in a["page_pos"].values():
                v[0, 0, si, :] = SENTINEL_POS
        for v in a["state_eids"].values():
            v[0, si] = -1
        if self.tok_src is not None:
            if self.packed:
                off, nt = self.info["seg_off"][si]
                self.tok_src[0, off:off + nt] = -1
            else:
                self.tok_src[si, :] = -1


class _SeqMirror:
    """Persistent per-request device-batch state: block-table + slot-position
    arrays per KV type, grown geometrically and patched from manager deltas."""

    __slots__ = ("epoch", "evt_cursor", "trim_cursor", "table", "pos", "n")

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.evt_cursor = 0
        self.trim_cursor = 0
        self.table: Dict[str, np.ndarray] = {}
        self.pos: Dict[str, np.ndarray] = {}
        self.n: Dict[str, int] = {}

    def _ensure(self, name: str, cap: int) -> None:
        cur = self.table.get(name)
        if cur is not None and cur.shape[0] >= cap:
            return
        new_cap = _pow2(cap, 8)
        table = np.full((new_cap,), -1, np.int32)
        pos = np.full((new_cap,), SENTINEL_POS, np.int32)
        if cur is not None:
            table[: cur.shape[0]] = cur
            pos[: cur.shape[0]] = self.pos[name]
        self.table[name] = table
        self.pos[name] = pos


def _seg_intervals(vals: np.ndarray, block: int):
    """Per-block (lo, hi) segment-id intervals of a flat id stream, pads
    (negative ids) excluded; an all-pad block gets an empty interval that
    overlaps nothing."""
    n = -(-vals.shape[0] // block)
    pad = n * block - vals.shape[0]
    v = np.pad(vals, (0, pad), constant_values=-2).reshape(n, block)
    valid = v >= 0
    big = 1 << 30
    lo = np.where(valid, v, big).min(axis=1)
    hi = np.where(valid, v, -big).max(axis=1)
    return lo, hi



def refuse_mesh(model) -> None:
    """Raise for a model built for a mesh of more than one rank."""
    dist = model.dist
    if dist.size > 1:
        raise NotImplementedError(
            f"this model was built for a {dist.dp} x {dist.tp} mesh; an "
            "Engine or ModelRunner serves on one device (a (1, 1) buffer, "
            "as the reference's runner does): call its serve_step on each "
            "rank with launch.input_specs.split_batch's batch")


class ModelRunner:
    def __init__(self, model, manager: JengaKVCacheManager,
                 stub_embed_fn=None, device="cuda",
                 buffer: Optional[torch.Tensor] = None):
        """``buffer``: another runner's unified buffer to share (two models
        on one manager, as speculative decoding runs them); by default the
        runner allocates its own, zeroed.

        A model built for a ``(data, model)`` mesh of ranks is refused:
        the runner serves one device's (1, 1) buffer and batch, as the
        reference's does; a mesh's ranks take their share of a batch
        through ``launch.input_specs.split_batch``."""
        refuse_mesh(model)
        self.model = model
        self.mgr = manager
        self.device = resolve_device(device)
        self.specs = {s.name: s for s in model.kv_specs()}
        self.stub_embed_fn = stub_embed_fn
        # Every type's pages sit at its geometry stride (the page itself
        # under "lcm", the large page under "max"), and one large page
        # follows the pool: the scratch page where dropped writes land
        # (``kv_rows``). Under "lcm" the large page is the LCM of EVERY
        # type the manager holds, not only this model's, so with several
        # models on one buffer each type's ``vp - 1`` is past its last
        # real page.
        self.layout = UnifiedLayout(manager.geometry, model.page_shapes(),
                                    scratch=1)
        self.page_strides = {n: self.layout.stride(n) for n in self.specs}
        units = self.layout.buffer_units
        if buffer is None:
            buffer = self.layout.alloc_buffer(self.device)
        assert tuple(buffer.shape) == (units,) and \
            buffer.device.type == self.device.type, \
            (tuple(buffer.shape), units, buffer.device, self.device)
        self.buffer = buffer
        self._mirrors: Dict[str, _SeqMirror] = {}
        self._table_specs = {n: s for n, s in self.specs.items()
                             if s.kind not in ("mamba", "rwkv")}
        self._state_specs = {n: s for n, s in self.specs.items()
                             if s.kind in ("mamba", "rwkv")}
        # dispatch-efficiency counters: real tokens vs. stream slots paid
        self.tokens_dispatched = 0
        self.slots_dispatched = 0
        self.dispatch_count = 0
        # attention-work counters (host-modeled, see _attn_block_stats)
        self.kv_blocks_scanned = 0
        self.kv_blocks_skipped = 0
        self.attn_flops_modeled = 0.0
        self.attn_bytes_modeled = 0.0
        # device->host traffic (fetch/fetch_tokens)
        self.bytes_fetched = 0
        # sampled-token board: persistent device int32 vector the fused
        # sampling tail scatters into and later dispatches read from (see
        # serving.sampler); its last element is the trash slot for -1
        # writes. Slots are per-request (rid-keyed, with a free list).
        self._board = torch.zeros((64 + 1,), dtype=torch.int32,
                                  device=self.device)
        self._board_slots: Dict[str, int] = {}
        self._board_free: List[int] = []
        self._board_top = 0

    # -------------------------------------------------------------- mirrors
    def _mirror(self, seq: SequenceState) -> _SeqMirror:
        """Sync this sequence's mirror from the manager's deltas: new table
        entries are appended, freed entries patched from ``freed_events``,
        trailing pops clamped from ``trim_events`` (speculative rollback —
        no epoch bump, so the cursors survive), and a stale ``epoch``
        (free/preemption) forces a rebuild."""
        m = self._mirrors.get(seq.rid)
        if m is None or m.epoch != seq.epoch:
            m = _SeqMirror(seq.epoch)
            self._mirrors[seq.rid] = m
        for name, idx in seq.freed_events[m.evt_cursor:]:
            if idx < m.n.get(name, 0):
                m.table[name][idx] = -1
                m.pos[name][idx] = SENTINEL_POS
        m.evt_cursor = len(seq.freed_events)
        for name, new_len in seq.trim_events[m.trim_cursor:]:
            if new_len < m.n.get(name, 0):
                m.n[name] = new_len
        m.trim_cursor = len(seq.trim_events)
        for name, spec in self._table_specs.items():
            entries = seq.page_tables.get(name)
            if not entries:
                continue
            n0 = m.n.get(name, 0)
            if len(entries) <= n0:
                continue
            m._ensure(name, len(entries))
            new = np.fromiter(entries[n0:], np.int32, len(entries) - n0)
            m.table[name][n0:len(entries)] = new
            tpp = spec.tokens_per_page
            m.pos[name][n0:len(entries)] = np.where(
                new == SequenceState.FREED, SENTINEL_POS,
                np.arange(n0, len(entries), dtype=np.int32) * tpp)
            m.n[name] = len(entries)
        return m

    def forget(self, rid: str) -> None:
        """Drop the mirror (and board slot) of a finished request. The
        freed board slot may be handed to a new request immediately:
        device dispatch order guarantees any still-queued write of the
        old owner lands before the new owner's first write."""
        self._mirrors.pop(rid, None)
        slot = self._board_slots.pop(rid, None)
        if slot is not None:
            self._board_free.append(slot)

    # ----------------------------------------------------------- token board
    def board_slot(self, rid: str) -> int:
        """Stable board slot of a request (allocated on first use)."""
        s = self._board_slots.get(rid)
        if s is None:
            if self._board_free:
                s = self._board_free.pop()
            else:
                s = self._board_top
                self._board_top += 1
            self._board_slots[rid] = s
        return s

    def _ensure_board(self, cap: int) -> None:
        cur = int(self._board.shape[0]) - 1          # last slot: trash
        if cap <= cur:
            return
        new_cap = _pow2(cap, 64)
        grown = torch.zeros((new_cap + 1,), dtype=torch.int32,
                            device=self.device)
        grown[:cur] = self._board[:cur]
        self._board = grown

    # ------------------------------------------- shared per-item builders
    def _mm_enc_flags(self, items) -> Tuple[bool, bool]:
        """Whether this batch carries mm-embed / encoder fields. Keyed on
        each item's chunk START, not ``req.in_prefill`` — under async
        scheduling ``num_computed`` lags the in-flight step, and a
        speculative first decode built while the final prefill chunk is in
        flight must produce the SAME batch fields (and jit key) as the
        synchronous loop would."""
        cfg = self.model.cfg
        has_mm = cfg.family == "vlm" and any(
            start < len(r.prompt) for r, _, start in items)
        has_enc = cfg.family == "encdec" and any(
            start == 0 for r, _, start in items)
        return has_mm, has_enc

    def _fresh_state_of(self, seq: SequenceState, start: int
                        ) -> List[Tuple[str, int]]:
        """A request's very first chunk must see zero recurrent state; its
        freshly allocated state pages hold whatever bytes last lived in
        those units (prefix-cache restores land at start > 0, so they are
        never clobbered here). Under async scheduling the chunk START, not
        ``num_computed``, decides — a continuation chunk built while the
        first chunk is still in flight must NOT re-zero the state the
        in-flight chunk is writing."""
        if start != 0:
            return []
        return [(name, seq.state_pages[name])
                for name in self._state_specs if name in seq.state_pages]

    def _fill_mm(self, seq, start, t_real, mm_embeds, mm_mask, row, col0):
        """Route this chunk's vision embeddings: destination is
        (row, col0 + p - start) — padded rows pass (bi, 0), the packed
        stream (0, stream_offset)."""
        d_model = self.model.cfg.d_model
        for it in seq.mm_items:
            for off in range(it.length):
                p = it.start + off
                if start <= p < start + t_real:
                    mm_embeds[row, col0 + p - start] = self.stub_embed_fn(
                        it.mm_hash, off, d_model)
                    mm_mask[row, col0 + p - start] = True

    def _fill_encoder(self, seq, mirror, enc_embeds, enc_write, row):
        """First-chunk encdec prefill: stub encoder embeddings + cross-KV
        write targets for one request, into row ``row`` (batch row when
        padded, segment index when packed)."""
        cfg = self.model.cfg
        total_enc = sum(it.length for it in seq.encoder_items)
        off0 = 0
        for it in seq.encoder_items:
            for off in range(it.length):
                enc_embeds[row, off0 + off] = self.stub_embed_fn(
                    it.mm_hash, off, cfg.d_model)
            off0 += it.length
        ctab = mirror.table.get("cross_attn")
        tpp = self.specs["cross_attn"].tokens_per_page
        for j in range(min(total_enc, cfg.encoder_seq)):
            pg = j // tpp
            if ctab is not None and pg < mirror.n.get(
                    "cross_attn", 0) and ctab[pg] >= 0:
                enc_write[0, 0, row, j] = ctab[pg]

    # ---------------------------------------------------- attention stats
    def _attn_block_stats(self, TT: int, seg_ids_row: np.ndarray,
                          page_seg: Dict[str, np.ndarray]) -> dict:
        """Host mirror of the device segment-block-sparse schedule: per-step
        counts of (q block, KV block) tiles scanned vs skipped over the
        OLD-page self-attention streams (full_attn/swa; fresh-part and
        cross-attn work is small by comparison), plus modeled attention
        FLOPs and HBM bytes for the scanned tiles. Mirrors
        ``blocks_attn.sparse_blocks`` sizing — keep the two in sync."""
        from ..models.blocks_attn import sparse_blocks
        cfg = self.model.cfg
        scanned = skipped = 0
        flops = bytes_ = 0.0
        for name, spec in self._table_specs.items():
            if spec.kind not in ("full_attn", "swa"):
                continue
            ps = page_seg[name][0, 0, 0]
            tpp = spec.tokens_per_page
            slot_seg = np.repeat(ps, tpp)
            s = slot_seg.shape[0]
            qb, kb = sparse_blocks(TT, s)
            q_lo, q_hi = _seg_intervals(seg_ids_row, qb)
            k_lo, k_hi = _seg_intervals(slot_seg, kb)
            hits = int(((k_lo[None, :] <= q_hi[:, None])
                        & (k_hi[None, :] >= q_lo[:, None])).sum())
            pairs = q_lo.shape[0] * k_lo.shape[0]
            L = spec.num_layers
            scanned += hits * L
            skipped += (pairs - hits) * L
            # per scanned tile: QK^T + PV matmuls over all query heads...
            flops += hits * L * 4.0 * qb * kb * cfg.head_dim * cfg.num_heads
            # ...and one read of the tile's K+V slots (bf16)
            bytes_ += hits * L * kb * cfg.num_kv_heads * cfg.head_dim * 2 * 2
        return dict(kv_blocks_scanned=scanned, kv_blocks_skipped=skipped,
                    attn_flops_modeled=flops, attn_bytes_modeled=bytes_)

    # ----------------------------------------------------------- batching
    def prepare(self, items, packed: bool = True, sample: bool = False,
                board_feed: bool = False, board_dst: Optional[List[int]] = None,
                board_src: Optional[List[int]] = None) -> PreparedStep:
        """Phase 1: flatten one scheduler step — ``items`` is
        [(request, num_tokens[, start])] with ragged per-sequence token
        counts — into a HOST-side device batch: token-packed stream
        (default) or padded (B, T) rows.

        ``sample=True`` attaches a fused greedy tail (per-segment pick on
        device, scattered into the token board at ``board_dst[si]`` —
        default: the request's rid slot). ``board_feed=True`` converts
        pending decode rows into on-device board reads from
        ``board_src[si]`` (default: rid slot) instead of requiring a host
        ``patch_token``."""
        items = _norm_items(items)
        if packed:
            arrs, info = self._build_host_packed(items)
        else:
            arrs, info = self._build_host_padded(items)
        prep = PreparedStep(arrs=arrs, info=info, items=items, packed=packed,
                            pending=info.pop("pending"))
        if sample:
            self._attach_sampling(prep, board_dst)
        if board_feed:
            self._attach_board_feed(prep, board_src)
        return prep

    def _attach_sampling(self, prep: PreparedStep,
                         board_dst: Optional[List[int]] = None) -> None:
        """Per-segment sampling metadata for the fused dispatch tail,
        sized to the segment bucket (padded rows sample garbage that is
        never read). The random key per row is (seed, rid_hash,
        position-of-sampled-token) — layout- and batch-independent."""
        S = prep.arrs["seq_lens"].shape[0]
        samp = dict(temps=np.zeros((S,), np.float32),
                    top_ks=np.zeros((S,), np.int32),
                    rhs=np.zeros((S,), np.uint32),
                    poss=np.zeros((S,), np.int32),
                    seeds=np.zeros((S,), np.int32),
                    dst=np.full((S,), -1, np.int32),
                    need_random=False)
        for si, (r, nt, start) in enumerate(prep.items):
            sp = r.sampling
            samp["temps"][si] = max(0.0, sp.temperature)
            samp["top_ks"][si] = max(0, getattr(sp, "top_k", 0))
            samp["rhs"][si] = rid_hash(r.rid)
            samp["poss"][si] = start + nt
            samp["seeds"][si] = sp.seed
            samp["dst"][si] = (board_dst[si] if board_dst is not None
                               else self.board_slot(r.rid))
            if sp.temperature > 0 and start + nt >= len(r.prompt):
                samp["need_random"] = True
        prep.samp = samp

    def _attach_board_feed(self, prep: PreparedStep,
                           board_src: Optional[List[int]] = None) -> None:
        """Convert pending (speculative, token-not-yet-sampled) decode
        rows into on-device board reads: the dispatch that samples their
        input token was issued earlier, so device execution order makes
        the read see the right value with no host round-trip."""
        if not prep.pending:
            return
        tok_src = np.full(prep.arrs["tokens"].shape, -1, np.int32)
        for si in list(prep.pending):
            r, nt, start = prep.items[si]
            assert nt == 1, (si, nt)
            slot = (board_src[si] if board_src is not None
                    else self.board_slot(r.rid))
            if prep.packed:
                off, _ = prep.info["seg_off"][si]
                tok_src[0, off] = slot
            else:
                tok_src[si, 0] = slot
            prep.pending.remove(si)
            prep.board_fed.append(si)
        prep.tok_src = tok_src

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host numpy -> device tensor without a host sync: the bytes go
        through pinned memory, so the copy is queued on the current stream
        and later host edits of ``a`` cannot reach the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _upload_ids(self, ids: Sequence[int]) -> torch.Tensor:
        """Host page ids -> an int64 device tensor (``_upload``)."""
        return self._upload(np.fromiter(ids, np.int64, len(ids)))

    def _to_batch(self, arrs: Dict[str, object]) -> DecodeBatch:
        """Upload a batch: the fields of each dtype go up in ONE copy of
        one flat array, then are viewed back into their fields on device —
        one copy for the int32 fields (``mrope_pos`` among them), and for a
        multimodal step one for the fp32 ``mm_embeds`` and one for the
        bool ``mm_mask``."""
        arrs = dict(arrs)
        strides = arrs.pop("page_strides", None)      # host ints
        out = {f: ({} if isinstance(v, dict) else None)
               for f, v in arrs.items()}
        groups: Dict[np.dtype, list] = {}
        for f, v in arrs.items():
            items = v.items() if isinstance(v, dict) else [(None, v)]
            for k, x in items:
                if x is not None:
                    groups.setdefault(x.dtype, []).append((f, k, x))
        for fields in groups.values():
            dev = self._upload(np.concatenate([x.reshape(-1)
                                               for _, _, x in fields]))
            off = 0
            for f, k, x in fields:
                t = dev[off:off + x.size].view(x.shape)
                off += x.size
                if k is None:
                    out[f] = t
                else:
                    out[f][k] = t
        return DecodeBatch(**out, page_strides=strides)

    def _build_host_padded(self, items: Sequence[Tuple[Request, int, int]]
                           ) -> Tuple[Dict[str, object], dict]:
        """Padded layout: one row per sequence padded to the (B, T) bucket.
        Padded slots get SENTINEL positions (never attended), padded rows
        get -1 exec ids (writes dropped)."""
        n = len(items)
        assert n > 0
        B = _pow2(n)
        T = _pow2(max(nt for _, nt, _ in items))
        mirrors = [self._mirror(r.seq) for r, _, _ in items]
        p_need: Dict[str, int] = {}
        for name in self._table_specs:
            longest = 1
            for m in mirrors:
                longest = max(longest, m.n.get(name, 0))
            p_need[name] = _pow2(longest, 4)
        tokens = np.zeros((B, T), np.int32)
        positions = np.full((B, T), SENTINEL_POS, np.int32)
        seq_lens = np.ones((B,), np.int32)
        last_idx = np.zeros((B,), np.int32)
        tables = {k: np.full((1, 1, B, p), -1, np.int32)
                  for k, p in p_need.items()}
        page_pos = {k: np.full((1, 1, B, p), SENTINEL_POS, np.int32)
                    for k, p in p_need.items()}
        write_eids = {k: np.full((1, 1, B, T), -1, np.int32)
                      for k in p_need}
        state_eids = {s.name: np.full((1, B), -1, np.int32)
                      for s in self._state_specs.values()}
        cfg = self.model.cfg
        has_mm, has_enc = self._mm_enc_flags(items)
        mm_embeds = mm_mask = mrope = None
        enc_embeds = enc_write = enc_lens = None
        if has_mm:
            mm_embeds = np.zeros((B, T, cfg.d_model), np.float32)
            mm_mask = np.zeros((B, T), bool)
        if cfg.family == "encdec":
            enc_lens = np.zeros((B,), np.int32)
            if has_enc:
                enc_embeds = np.zeros((B, cfg.encoder_seq, cfg.d_model),
                                      np.float32)
                enc_write = np.full((1, 1, B, cfg.encoder_seq), -1, np.int32)

        fresh_state: List[Tuple[str, int]] = []
        pending: List[int] = []
        for bi, ((r, t_real, start), m) in enumerate(zip(items, mirrors)):
            seq = r.seq
            fresh_state.extend(self._fresh_state_of(seq, start))
            toks = seq.tokens[start:start + t_real]
            if len(toks) < t_real:      # speculative decode: token patched in
                pending.append(bi)
            tokens[bi, :len(toks)] = toks
            positions[bi, :t_real] = np.arange(start, start + t_real)
            seq_lens[bi] = start + t_real
            last_idx[bi] = t_real - 1
            for name, spec in self._table_specs.items():
                np_ = p_need[name]
                nm = min(m.n.get(name, 0), np_)
                if nm:
                    tables[name][0, 0, bi, :nm] = m.table[name][:nm]
                    page_pos[name][0, 0, bi, :nm] = m.pos[name][:nm]
                if spec.kind in ("full_attn", "swa"):
                    tpp = spec.tokens_per_page
                    pgs = (start + np.arange(t_real)) // tpp
                    write_eids[name][0, 0, bi, :t_real] = \
                        m.table[name][pgs] if m.n.get(name, 0) else -1
            for name in state_eids:
                if name in seq.state_pages:
                    state_eids[name][0, bi] = seq.state_pages[name]
            if has_mm and self.stub_embed_fn:
                self._fill_mm(seq, start, t_real, mm_embeds, mm_mask, bi, 0)
            if cfg.family == "encdec":
                enc_lens[bi] = sum(it.length for it in seq.encoder_items)
                if has_enc and start == 0 and r.in_prefill \
                        and self.stub_embed_fn:
                    self._fill_encoder(seq, m, enc_embeds, enc_write, bi)
        if has_mm:
            mrope = np.broadcast_to(positions[None], (3, B, T)).copy()

        arrs = dict(
            tokens=tokens, positions=positions, seq_lens=seq_lens,
            tables=tables, page_pos=page_pos, write_eids=write_eids,
            state_eids=state_eids, mm_embeds=mm_embeds, mm_mask=mm_mask,
            mrope_pos=mrope, last_idx=last_idx, enc_embeds=enc_embeds,
            enc_write_eids=enc_write, enc_lens=enc_lens,
            seg_ids=None, chunk_start=None, seg_start_tok=None,
            seg_last_tok=None, page_seg=None, page_strides=self.page_strides)
        # T==1 buckets read their pages in place through the paged decode
        # kernel; any larger bucket (or an encoder run) uses the chunked
        # prefill path. Both are exact for every row thanks to
        # position-based masking.
        prefill = T > 1 or has_enc
        key = (prefill, B, T, tuple(sorted(p_need.items())), has_mm, has_enc)
        return arrs, {"key": key, "n": n, "prefill": prefill,
                      "fresh_state": fresh_state, "pending": pending,
                      "tokens": sum(nt for _, nt, _ in items),
                      "slots": B * T}

    def _build_host_packed(self, items: Sequence[Tuple[Request, int, int]]
                           ) -> Tuple[Dict[str, object], dict]:
        """Token-packed layout: flatten the whole step into ONE
        ``(TT,)`` token stream (TT = ``_tok_bucket(total_tokens)``) with
        per-token segment ids / positions / chunk starts / KV write
        targets, per-segment ``(start, last_tok)`` row metadata, and ONE
        flat page stream per KV type tagged with per-page owning segments.
        Pad tokens carry segment id -1 and SENTINEL positions; pad pages
        carry segment id -2 — pads never match anything."""
        n = len(items)
        assert n > 0
        total = sum(nt for _, nt, _ in items)
        TT = _tok_bucket(total)
        S = _pow2(n)                                  # segment bucket
        mirrors = [self._mirror(r.seq) for r, _, _ in items]
        p_need: Dict[str, int] = {}                   # flat page-stream cap
        for name in self._table_specs:
            p_need[name] = _pow2(
                max(1, sum(m.n.get(name, 0) for m in mirrors)), 4)
        tokens = np.zeros((1, TT), np.int32)
        positions = np.full((1, TT), SENTINEL_POS, np.int32)
        seg_ids = np.full((1, TT), -1, np.int32)
        chunk_start = np.full((1, TT), SENTINEL_POS, np.int32)
        seg_start_tok = np.zeros((1, TT), np.int32)
        seg_last_tok = np.zeros((S,), np.int32)
        seq_lens = np.ones((S,), np.int32)
        tables = {k: np.full((1, 1, 1, p), -1, np.int32)
                  for k, p in p_need.items()}
        page_pos = {k: np.full((1, 1, 1, p), SENTINEL_POS, np.int32)
                    for k, p in p_need.items()}
        page_seg = {k: np.full((1, 1, 1, p), -2, np.int32)
                    for k, p in p_need.items()}
        write_eids = {k: np.full((1, 1, 1, TT), -1, np.int32)
                      for k in p_need}
        state_eids = {s.name: np.full((1, S), -1, np.int32)
                      for s in self._state_specs.values()}
        cfg = self.model.cfg
        has_mm, has_enc = self._mm_enc_flags(items)
        mm_embeds = mm_mask = mrope = None
        enc_embeds = enc_write = enc_lens = None
        if has_mm:
            mm_embeds = np.zeros((1, TT, cfg.d_model), np.float32)
            mm_mask = np.zeros((1, TT), bool)
        if cfg.family == "encdec":
            enc_lens = np.zeros((1, TT), np.int32)    # per TOKEN when packed
            if has_enc:
                enc_embeds = np.zeros((S, cfg.encoder_seq, cfg.d_model),
                                      np.float32)
                enc_write = np.full((1, 1, S, cfg.encoder_seq), -1, np.int32)

        fresh_state: List[Tuple[str, int]] = []
        pending: List[int] = []
        seg_off: List[Tuple[int, int]] = []
        page_cursor = {name: 0 for name in p_need}
        off = 0
        for si, ((r, t_real, start), m) in enumerate(zip(items, mirrors)):
            seq = r.seq
            fresh_state.extend(self._fresh_state_of(seq, start))
            seg_off.append((off, t_real))
            toks = seq.tokens[start:start + t_real]
            if len(toks) < t_real:      # speculative decode: token patched in
                pending.append(si)
            tokens[0, off:off + len(toks)] = toks
            positions[0, off:off + t_real] = np.arange(start, start + t_real)
            seg_ids[0, off:off + t_real] = si
            chunk_start[0, off:off + t_real] = start
            seg_start_tok[0, off:off + t_real] = off
            seg_last_tok[si] = off + t_real - 1
            seq_lens[si] = start + t_real
            for name, spec in self._table_specs.items():
                nm = m.n.get(name, 0)
                pc = page_cursor[name]
                if nm:
                    tables[name][0, 0, 0, pc:pc + nm] = m.table[name][:nm]
                    page_pos[name][0, 0, 0, pc:pc + nm] = m.pos[name][:nm]
                    page_seg[name][0, 0, 0, pc:pc + nm] = si
                    page_cursor[name] = pc + nm
                if spec.kind in ("full_attn", "swa"):
                    tpp = spec.tokens_per_page
                    pgs = (start + np.arange(t_real)) // tpp
                    write_eids[name][0, 0, 0, off:off + t_real] = \
                        m.table[name][pgs] if nm else -1
            for name in state_eids:
                if name in seq.state_pages:
                    state_eids[name][0, si] = seq.state_pages[name]
            if has_mm and self.stub_embed_fn:
                self._fill_mm(seq, start, t_real, mm_embeds, mm_mask, 0, off)
            if cfg.family == "encdec":
                enc_lens[0, off:off + t_real] = \
                    sum(it.length for it in seq.encoder_items)
                if has_enc and start == 0 and r.in_prefill \
                        and self.stub_embed_fn:
                    self._fill_encoder(seq, m, enc_embeds, enc_write, si)
            off += t_real
        if has_mm:
            mrope = np.broadcast_to(positions[None], (3, 1, TT)).copy()

        arrs = dict(
            tokens=tokens, positions=positions, seq_lens=seq_lens,
            tables=tables, page_pos=page_pos, write_eids=write_eids,
            state_eids=state_eids, mm_embeds=mm_embeds, mm_mask=mm_mask,
            mrope_pos=mrope, last_idx=None, enc_embeds=enc_embeds,
            enc_write_eids=enc_write, enc_lens=enc_lens,
            seg_ids=seg_ids, chunk_start=chunk_start,
            seg_start_tok=seg_start_tok, seg_last_tok=seg_last_tok,
            page_seg=page_seg, page_strides=self.page_strides)
        key = ("packed", S, TT, tuple(sorted(p_need.items())),
               has_mm, has_enc)
        return arrs, {"key": key, "n": n, "prefill": True,
                      "fresh_state": fresh_state, "pending": pending,
                      "seg_off": seg_off, "tokens": total, "slots": TT,
                      "attn_work": self._attn_block_stats(
                          TT, seg_ids[0], page_seg)}


    def build_plan(self, items, packed: bool = True
                   ) -> Tuple[DecodeBatch, dict]:
        """Build one plan's device batch (host build + upload). Kept for
        direct layout inspection; the engine drives prepare/dispatch/fetch
        separately."""
        prep = self.prepare(items, packed=packed)
        return self._to_batch(prep.arrs), prep.info

    # ----------------------------------------------------------------- run
    def dispatch(self, params, prep: PreparedStep):
        """Phase 2: upload the prepared batch, zero freshly allocated pages,
        and issue the serve step (plus the fused greedy tail when attached)
        on the current stream. Returns device handles WITHOUT blocking —
        the device computes while the host schedules and builds the next
        plan."""
        info = prep.info
        assert not prep.pending, \
            f"segments {prep.pending} still await their decode token"
        san = self.mgr.sanitizer
        if san is not None:
            # gather-from-freed: every page this step reads or writes must
            # be live RIGHT NOW (killed segments are masked out via
            # page_seg/-1 sentinels and excluded from the check)
            san.check_dispatch(prep.arrs)
        # killed segments' tokens are pads now — count their slots as paid
        # (slots) but not as useful work (tokens): they ARE dispatch waste
        dead_tokens = sum(prep.items[si][1] for si in prep.dead)
        self.tokens_dispatched += info["tokens"] - dead_tokens
        self.slots_dispatched += info["slots"]
        self.dispatch_count += 1
        aw = info.get("attn_work")
        if aw is not None:
            self.kv_blocks_scanned += aw["kv_blocks_scanned"]
            self.kv_blocks_skipped += aw["kv_blocks_skipped"]
            self.attn_flops_modeled += aw["attn_flops_modeled"]
            self.attn_bytes_modeled += aw["attn_bytes_modeled"]
        self.zero_pages(self.mgr.drain_fresh_pages())
        for name, eid in info["fresh_state"]:
            self.zero_page(name, eid)
        batch = self._to_batch(prep.arrs)
        if prep.tok_src is not None and prep.board_fed:
            # feed still-in-flight decode tokens from the board, on device
            batch.tokens = inject_tokens(batch.tokens,
                                         self._upload(prep.tok_src),
                                         self._board)
        logits = self.model.serve_step(params, self.buffer, batch,
                                       prefill=info["prefill"])
        tokens_h = None
        if prep.samp is not None:
            sm = prep.samp
            self._ensure_board(int(sm["dst"].max(initial=-1)) + 1)
            samp = None
            if sm["need_random"]:
                # one upload: dst, then the draw's per-row fields
                up = self._upload(np.stack([
                    sm["dst"], sm["temps"].view(np.int32), sm["top_ks"],
                    sm["rhs"].view(np.int32), sm["poss"], sm["seeds"]]))
                dst = up[0]
                samp = (up[1].view(torch.float32), *up[2:])
            else:
                dst = self._upload(sm["dst"])
            tokens_h = sample_batch(logits, self._board, dst, samp)
        return StepHandle(logits=logits, tokens=tokens_h, n=info["n"])

    def fetch(self, handle, n: int) -> np.ndarray:
        """Phase 3: block on a dispatched step's logits; one row per
        segment, in plan order."""
        h = handle.logits if isinstance(handle, StepHandle) else handle
        # jengalint: allow[host-sync] fetch phase: this IS the intended blocking point
        out = h[:n].float().cpu().numpy()
        self.bytes_fetched += out.nbytes
        return out

    def fetch_tokens(self, handle: StepHandle,
                     n: Optional[int] = None) -> np.ndarray:
        """Block on a dispatched step's device-sampled tokens: 4 bytes
        per segment instead of the full vocab row."""
        assert handle.tokens is not None, "dispatch had no sampling tail"
        n = handle.n if n is None else n
        # jengalint: allow[host-sync] fetch phase: 4-byte/segment token fetch is the design
        out = handle.tokens[:n].cpu().numpy().astype(np.int32)
        self.bytes_fetched += out.nbytes
        return out

    def run_plan(self, params, items, packed: bool = True) -> np.ndarray:
        """Execute one mixed step plan in a single dispatch (prepare +
        dispatch + fetch back to back — the synchronous path). Returns
        last-token logits, one row per item, in plan order."""
        prep = self.prepare(items, packed=packed)
        return self.fetch(self.dispatch(params, prep), prep.n)

    # ------------------------------------------------------------- copies
    def _rows(self, type_name: str) -> torch.Tensor:
        """One type's pages of this runner's buffer as ``(VP,
        page_units)`` rows at its stride (``UnifiedLayout.rows``)."""
        return self.layout.rows(self.buffer, type_name)

    def apply_copies(self, ops: Sequence[StateCopyOp]) -> None:
        """Execute all StateCopyOps of one step phase, one gather + one
        in-place scatter per KV type. All sources are read (copied out)
        before any destination is written, which matches sequential
        execution because a phase never copies out of a page it also
        copies into."""
        if not ops:
            return
        by_type: Dict[str, List[StateCopyOp]] = {}
        for op in ops:
            by_type.setdefault(op.type_name, []).append(op)
        for name, group in by_type.items():
            rows = self._rows(name)
            srcs = self._upload_ids([op.src_page for op in group])
            dsts = self._upload_ids([op.dst_page for op in group])
            rows.index_copy_(0, dsts, rows.index_select(0, srcs))

    def zero_pages(self, pages: Sequence[Tuple[str, int]]) -> None:
        """Zero freshly allocated pages (one in-place fill per type):
        recycled large pages carry other types' stale bytes, which can
        decode as NaN when gathered as K/V — and NaN survives even fully
        masked softmax accumulation. A drain can surface pages of types
        this runner's model does not own (several models sharing one
        pool): the layout views every type the manager holds."""
        if not pages:
            return
        by_type: Dict[str, List[int]] = {}
        for name, eid in pages:
            by_type.setdefault(name, []).append(eid)
        for name, eids in by_type.items():
            self._rows(name).index_fill_(0, self._upload_ids(eids), 0)

    def zero_page(self, type_name: str, eid: int) -> None:
        """Zero one small page (fresh recurrent-state initialisation)."""
        self._rows(type_name)[eid].zero_()

    def adopt_pages(self, src_runner: "ModelRunner",
                    pairs: Sequence[Tuple[str, int, int]]) -> None:
        """Prefill->decode handoff copy stream: install exported pages from
        ANOTHER runner's unified buffer into this one, one gather from the
        source's rows and one in-place scatter into this buffer's rows per
        KV type (each buffer's rows at its own layout's stride). Both
        runners issue on the same device's current stream, so the copy
        reads the source pages after every source dispatch issued before
        it and before any issued after it — the order the reference gets
        from immutable arrays. Adopted pages are kept out of the
        fresh-page zeroing queue: they carry transferred content a later
        zeroing pass would destroy."""
        if not pairs:
            return
        assert src_runner.buffer.device == self.buffer.device, \
            (src_runner.buffer.device, self.buffer.device)
        by_type: Dict[str, List[Tuple[int, int]]] = {}
        for name, src, dst in pairs:
            by_type.setdefault(name, []).append((src, dst))
        for name, group in by_type.items():
            srcs = self._upload_ids([p[0] for p in group])
            dsts = self._upload_ids([p[1] for p in group])
            self._rows(name).index_copy_(
                0, dsts, src_runner._rows(name).index_select(0, srcs))
