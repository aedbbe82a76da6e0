"""One card's cell for every (arch x shape): the shapes, dtypes and bytes of
its batch and of its KV/state pool (``repro/launch/input_specs.py``).

Host-only (Python and numpy; no tensor is allocated). The card's share of
the cell comes from ``mesh.card_share``: one data shard of the reference's
16 x 16 mesh with the tensor-parallel shards folded onto the card, so a
serve cell's batch is the reference's padded ``DecodeBatch`` with the
(data, model) dims dropped, and its pool is the unified buffer that holds
exactly the card's KV footprint (rounded to the LCM geometry, plus the
scratch page). ``buffer_units_for``, ``default_micro_batches`` and
``wants_fsdp`` are copied from the reference unchanged. On a training
mesh of cards (``dryrun --mesh``) every data rank takes the rows one card
takes, so a train cell's batch is the same per card.

On a serving mesh (``serve_cell`` of a model built for one) the shapes are
one rank's, as the reference's ``serve_cell`` gives them: each data rank
holds one card's rows (or, under ``sp``, every row and 1 / dp of each
sequence), and each of a K/V group's ``repl`` replicas 1 / repl of its
attention pages. ``split_batch`` turns one (1, 1) batch (host numpy, the
``ModelRunner.prepare`` layout) into a rank's batch to that contract.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

from ..configs.base import ModelConfig, ShapeSpec
import numpy as np

from ..core.spec import BYTES_PER_UNIT
from ..core.spec import lcm as _lcm
from .mesh import card_share

SENTINEL_POS = 1 << 29      # serving.runner.SENTINEL_POS: a pad's position

DTYPE_BYTES = {"int32": 4, "bfloat16": 2, "float32": 4, "bool": 1}


@dataclasses.dataclass
class Cell:
    """One card's cell: its batch (name -> (shape, dtype)) and pool."""

    kind: str                  # train | prefill | decode
    arrays: Dict[str, Tuple[Tuple[int, ...], str]]
    buffer_units: int          # the card's unified buffer (0: training)
    notes: Dict[str, Any]

    @property
    def batch_bytes(self) -> int:
        return sum(math.prod(s) * DTYPE_BYTES[dt]
                   for s, dt in self.arrays.values())

    @property
    def pool_bytes(self) -> int:
        return self.buffer_units * BYTES_PER_UNIT


def buffer_units_for(model, cfg: ModelConfig, tokens_per_shard: int,
                     seqs_per_shard: int, enc_tokens_per_shard: int = 0,
                     margin: float = 1.05) -> int:
    """Units one device's pool needs for the workload, LCM-rounded.

    Attention-token counts are already divided by the KV replica factor
    by the caller (replica-group KV sequence split, DESIGN.md §5)."""
    units = 0
    for s in model.kv_specs():
        if s.kind in ("mamba", "rwkv"):
            units += seqs_per_shard * s.page_units
        elif s.kind == "cross_attn":
            units += s.pages_for_tokens(max(1, enc_tokens_per_shard)) \
                * s.page_units * seqs_per_shard
        elif s.kind == "swa":
            # Jenga retires out-of-window pages: pool holds window only
            w = min(s.sliding_window + s.tokens_per_page, tokens_per_shard)
            units += s.pages_for_tokens(w) * s.page_units * seqs_per_shard
        else:
            units += s.pages_for_tokens(tokens_per_shard) * s.page_units \
                * seqs_per_shard
    big = _lcm([s.page_units for s in model.kv_specs()])
    units = int(units * margin)
    # +1 large page: SCRATCH target for dropped dus writes (attention.py)
    return (-(-units // big) + 1) * big


def serve_cell(model, cfg: ModelConfig, shape: ShapeSpec,
               pods: int = 1) -> Cell:
    """The card's serve cell: one padded step of the card's rows (T = the
    whole sequence for prefill, 1 for decode) over a pool that holds the
    card's KV/state. On one card every KV type keeps every page. On a
    mesh (``model.dist``) the cell is one rank's: its rows and tokens
    (``card_share(shape, dp)``: an ``sp`` cell's sequences split over the
    data ranks), its attention pages 1 / repl of them (the reference's
    replica-group split), its page and state shapes the rank model's.
    ``pods``: the reference's pods (``mesh.card_share``)."""
    dist = model.dist
    mesh = dist.size > 1
    share = card_share(shape, dist.dp if mesh and dist.sp else 1, pods)
    b, s = share.rows, share.tokens
    repl = model.ri["repl"] if mesh else 1
    attn = -(-s // repl)
    prefill = shape.kind == "prefill"
    t = s if prefill else 1
    i32 = "int32"
    arrays = {"tokens": ((b, t), i32), "positions": ((b, t), i32),
              "seq_lens": ((b,), i32)}
    if prefill:
        arrays["last_idx"] = ((b,), i32)
    enc_seq = cfg.encoder_seq if cfg.family == "encdec" else 0
    for spec in model.kv_specs():
        name = spec.name
        if spec.kind in ("mamba", "rwkv"):
            arrays[f"state_eids/{name}"] = ((b,), i32)
            continue
        if spec.kind == "cross_attn":
            npg = spec.pages_for_tokens(enc_seq)
        elif spec.kind == "swa":
            npg = spec.pages_for_tokens(
                min(spec.sliding_window + spec.tokens_per_page, attn)) + 1
        else:
            npg = spec.pages_for_tokens(attn)
        arrays[f"tables/{name}"] = ((b, npg), i32)
        arrays[f"page_pos/{name}"] = ((b, npg), i32)
        if spec.kind != "cross_attn":
            arrays[f"write_eids/{name}"] = ((b, t), i32)
    if cfg.family == "encdec":
        arrays["enc_lens"] = ((b,), i32)
        if prefill:
            arrays["enc_embeds"] = ((b, enc_seq, cfg.d_model), "bfloat16")
            arrays["enc_write_eids"] = ((b, enc_seq), i32)
    if cfg.family == "vlm" and prefill:
        arrays["mm_embeds"] = ((b, t, cfg.d_model), "bfloat16")
        arrays["mm_mask"] = ((b, t), "bool")
        arrays["mrope_pos"] = ((3, b, t), i32)
    units = buffer_units_for(model, cfg, tokens_per_shard=attn,
                             seqs_per_shard=b, enc_tokens_per_shard=enc_seq)
    return Cell(kind=shape.kind, arrays=arrays, buffer_units=units,
                notes=dict(B=shape.global_batch, S=shape.seq_len, rows=b,
                           tokens=s, sp=share.sp, kv_repl_split=repl))


def example_pool(model, pages: int, states: int = 16):
    """A pool layout for ``example_batch``: (units, {type: (first small
    page id, small pages)}, the large page's units): each KV type gets
    whole large pages holding at least ``pages`` of its pages (a state
    type ``states``), in the order of ``model.kv_specs()``, then one large
    scratch page (the runner's). A type whose page is the large page
    (every type of a decoder) gets page ids 0 .. pages - 1 at any tp."""
    specs = model.kv_specs()
    big = _lcm([s.page_units for s in specs])
    first, n = {}, 0
    for s in specs:
        per = big // s.page_units
        k = -(-(states if s.kind in ("mamba", "rwkv") else pages) // per)
        first[s.name] = (n * per, k * per)
        n += k
    return (n + 1) * big, first, big


def example_batch(model, seqs, packed: bool, seed: int, pages: int):
    """A (1, 1) serving batch in the ``ModelRunner.prepare`` layout (host
    numpy) over random page ids of ``example_pool(model, pages)``: one
    segment (packed) or row (padded) per ``(old, new)`` of ``seqs`` (its
    first ``old`` positions already in pages, ``new`` tokens this step),
    random tokens, each sequence's pages in order, write ids of every new
    token, and one state page per sequence for a hybrid or RWKV6. Pads as
    the runner makes them (position ``SENTINEL_POS``, table -1, packed
    owner -2). An enc-dec model's sequences each hold a clip of
    ``encoder_seq`` frames (every second one 3 frames shorter) in its own
    cross pages (``enc_lens`` per row, or per token when packed); a
    sequence with no old tokens is at its first chunk and, in a step of
    T > 1, carries its stub frame embeddings and the cross pages' write
    ids (``enc_embeds``, ``enc_write_eids``), the others' cross pages
    already written. Returns (arrays, pool units)."""
    rng = np.random.default_rng(seed)
    units, first, _ = example_pool(model, pages)
    specs = model.kv_specs()
    attn = [s for s in specs if s.kind in ("full_attn", "swa")]
    ids = {s.name: first[s.name][0] + rng.permutation(first[s.name][1])
           for s in specs}
    pages_of = {}
    for s in attn:
        need = np.cumsum([0] + [-(-(o + n) // s.tokens_per_page)
                                for o, n in seqs])
        if need[-1] > len(ids[s.name]):
            raise ValueError(f"{need[-1]} pages of {s.name} in a pool of "
                             f"{len(ids[s.name])}")
        pages_of[s.name] = [ids[s.name][need[i]:need[i + 1]]
                            for i in range(len(seqs))]
    toks = [rng.integers(0, model.cfg.vocab_size, n) for _, n in seqs]
    i32 = np.int32
    a = dict(mm_embeds=None, mm_mask=None, mrope_pos=None, enc_embeds=None,
             enc_write_eids=None, enc_lens=None, seg_ids=None,
             chunk_start=None, seg_start_tok=None, seg_last_tok=None,
             page_seg=None, last_idx=None)
    a["seq_lens"] = np.array([o + n for o, n in seqs], i32)
    a["state_eids"] = {s.name: ids[s.name][None, :len(seqs)].astype(i32)
                       for s in specs if s.kind in ("mamba", "rwkv")}
    if packed:
        tt = sum(n for _, n in seqs) + 3
        rows, b, t = [(0, off) for off in np.cumsum(
            [0] + [n for _, n in seqs])[:-1]], 1, tt
        npg = {s.name: sum(len(p) for p in pages_of[s.name]) + 2
               for s in attn}
        a.update(seg_ids=np.full((1, tt), -1, i32),
                 chunk_start=np.full((1, tt), SENTINEL_POS, i32),
                 seg_start_tok=np.zeros((1, tt), i32),
                 seg_last_tok=np.zeros((len(seqs),), i32),
                 page_seg={k: np.full((1, 1, 1, p), -2, i32)
                           for k, p in npg.items()})
    else:
        b, t = len(seqs), max(n for _, n in seqs)
        rows = [(bi, 0) for bi in range(b)]
        npg = {s.name: max(len(p) for p in pages_of[s.name]) + 1
               for s in attn}
        a["last_idx"] = np.array([n - 1 for _, n in seqs], i32)
    a["tokens"] = np.zeros((b, t), i32)
    a["positions"] = np.full((b, t), SENTINEL_POS, i32)
    tb = 1 if packed else b
    a["tables"] = {k: np.full((1, 1, tb, p), -1, i32) for k, p in npg.items()}
    a["page_pos"] = {k: np.full((1, 1, tb, p), SENTINEL_POS, i32)
                     for k, p in npg.items()}
    a["write_eids"] = {s.name: np.full((1, 1, b, t), -1, i32) for s in attn}
    cur = dict.fromkeys(npg, 0)
    for si, ((o, n), tok, (r, off)) in enumerate(zip(seqs, toks, rows)):
        sl = slice(off, off + n)
        a["tokens"][r, sl] = tok
        a["positions"][r, sl] = np.arange(o, o + n)
        if packed:
            a["seg_ids"][0, sl] = si
            a["chunk_start"][0, sl] = o
            a["seg_start_tok"][0, sl] = off
            a["seg_last_tok"][si] = off + n - 1
        for s in attn:
            pg = pages_of[s.name][si]
            c = cur[s.name] if packed else 0
            cols = slice(c, c + len(pg))
            a["tables"][s.name][0, 0, 0 if packed else r, cols] = pg
            a["page_pos"][s.name][0, 0, 0 if packed else r, cols] = \
                np.arange(len(pg)) * s.tokens_per_page
            if packed:
                a["page_seg"][s.name][0, 0, 0, cols] = si
                cur[s.name] = c + len(pg)
            a["write_eids"][s.name][0, 0, r, sl] = \
                pg[np.arange(o, o + n) // s.tokens_per_page]
    _cross_batch(a, model, seqs, ids, packed, rng, t, rows)
    return a, units


def _cross_batch(a, model, seqs, ids, packed, rng, t, rows):
    """``example_batch``'s enc-dec fields (see there), into ``a``."""
    cross = [s for s in model.kv_specs() if s.kind == "cross_attn"]
    if not cross:
        return
    s = cross[0]
    cfg, tpp, i32 = model.cfg, s.tokens_per_page, np.int32
    enc = cfg.encoder_seq
    npc = s.pages_for_tokens(enc)
    n = len(seqs)
    if n * npc > len(ids[s.name]):
        raise ValueError(f"{n * npc} pages of {s.name} in a pool of "
                         f"{len(ids[s.name])}")
    pages = ids[s.name][:n * npc].reshape(n, npc).astype(i32)
    lens = np.array([enc - 3 * (i % 2) for i in range(n)], i32)
    shape = (1, 1, 1, n * npc) if packed else (1, 1, n, npc)
    a["tables"][s.name] = pages.reshape(shape)
    a["page_pos"][s.name] = np.broadcast_to(
        np.arange(npc, dtype=i32) * tpp, (n, npc)).reshape(shape).copy()
    if packed:
        a["page_seg"][s.name] = np.repeat(np.arange(n, dtype=i32),
                                          npc).reshape(shape)
        a["enc_lens"] = np.zeros((1, t), i32)
        for i, ((_, k), (_, off)) in enumerate(zip(seqs, rows)):
            a["enc_lens"][0, off:off + k] = lens[i]
    else:
        a["enc_lens"] = lens
    first = [i for i, (o, _) in enumerate(seqs) if o == 0]
    if not first or (not packed and max(k for _, k in seqs) == 1):
        return
    a["enc_embeds"] = np.zeros((n, enc, cfg.d_model), np.float32)
    a["enc_write_eids"] = np.full((1, 1, n, enc), -1, i32)
    for i in first:
        a["enc_embeds"][i, :lens[i]] = rng.standard_normal(
            (lens[i], cfg.d_model)).astype(np.float32)
        j = np.arange(lens[i])
        a["enc_write_eids"][0, 0, i, :lens[i]] = pages[i, j // tpp]


# the per-row fields of a padded batch and their row axis
_ROW_AXIS = {"tokens": 0, "positions": 0, "seq_lens": 0, "last_idx": 0,
             "mm_embeds": 0, "mm_mask": 0, "mrope_pos": 1, "enc_embeds": 0,
             "enc_lens": 0, "enc_write_eids": 2}
_PAGE_FIELDS = ("tables", "page_pos", "write_eids", "page_seg")


def page_member(model, data_rank: int, model_rank: int):
    """(this rank's member index, members) of the group that splits a
    sequence's attention pages: the ``repl`` K/V replicas of its model
    rank's set, times the data ranks under ``sp``. Page ``i`` of a
    sequence (positions ``i * TPP ..``) lives on member ``i % members``."""
    dist = model.dist
    repl = model.ri["repl"] if dist.tp > 1 else 1
    d = dist.dp if dist.sp else 1
    return (model_rank % repl) + repl * (data_rank if dist.sp else 0), \
        repl * d


def refuse_strided(arrs: dict, model) -> None:
    """Raise for a batch whose pages are not at the LCM stride."""
    strides = arrs.get("page_strides") or {}
    wide = {s.name: strides[s.name] for s in model.kv_specs()
            if strides.get(s.name, s.page_units) != s.page_units}
    if wide:
        raise NotImplementedError(
            f"this batch addresses {sorted(wide)} pages at a stride of "
            f"{wide} units (a geometry_mode='max' engine's): a mesh rank's "
            "buffer keeps the LCM geometry's contiguous pages; serve 'max' "
            "on one device (an Engine), or split an 'lcm' engine's batch")


def split_batch(arrs: dict, model, data_rank: int, model_rank: int) -> dict:
    """One rank's serving batch from a (1, 1) batch ``arrs`` (field ->
    numpy array, the ``ModelRunner.prepare`` layout: per-type tables
    (1, 1, B, P)), for ``model``'s mesh (``model.dist``: dp, tp, sp): the
    reference's ``serve_step`` input specs, host side.

    * Padded rows split over "data" (``B / dp`` each, in order), with
      their state ids and an enc-dec model's frames, clip lengths and
      cross write ids; a packed stream, or any batch under ``sp``, is
      every rank's whole.
    * Cross (encoder) pages are never split: every rank of a K/V replica
      set attends, and writes, every cross page of its rows (the
      reference's ``cross_attn`` tables are whole on every rank).
    * Each attention page goes to exactly one member of the group that
      splits its sequence (``page_member``: the K/V replica set, and the
      data ranks under ``sp``); on the others its table entry is a pad
      (-1, position ``SENTINEL_POS``, packed owner -2).
    * A token's K/V write is kept on the member that holds its page (by
      its position) and is -1 (dropped) on the others.

    Page ids stay the batch's: each rank's buffer has the (1, 1) layout
    at the rank's page shapes. Mamba2 state ids go with their rows.

    A mesh rank keeps the LCM geometry's stride (each page its own
    units): a batch whose pages sit further apart (``page_strides`` of a
    "max" geometry whose types' pages differ) is refused."""
    refuse_strided(arrs, model)
    dist = model.dist
    out = dict(arrs)
    packed = arrs.get("seg_ids") is not None
    if not packed and not dist.sp and dist.dp > 1:
        b = arrs["tokens"].shape[0]
        if b % dist.dp:
            raise ValueError(f"{b} rows do not split over {dist.dp} data "
                             "ranks")
        n = b // dist.dp
        rows = slice(data_rank * n, (data_rank + 1) * n)

        def take(a, axis):
            return None if a is None else np.take(
                a, np.arange(b)[rows], axis=axis)
        for f, axis in _ROW_AXIS.items():
            if arrs.get(f) is not None:
                out[f] = take(arrs[f], axis)
        for f, axis in [(f, 2) for f in _PAGE_FIELDS] + [("state_eids", 1)]:
            if arrs.get(f) is not None:
                out[f] = {k: take(v, axis) for k, v in arrs[f].items()}
    mi, members = page_member(model, data_rank, model_rank)
    if members == 1:
        return out
    tpp = {s.name: s.tokens_per_page for s in model.kv_specs()
           if s.kind in ("full_attn", "swa")}
    for f in _PAGE_FIELDS:
        if out.get(f) is not None:
            out[f] = dict(out[f])
    pos = out["positions"]
    for name, t in tpp.items():
        tab = out["tables"][name]
        mine = (tab < 0) | ((out["page_pos"][name] // t) % members == mi)
        out["tables"][name] = np.where(mine, tab, -1).astype(np.int32)
        out["page_pos"][name] = np.where(
            mine, out["page_pos"][name], SENTINEL_POS).astype(np.int32)
        if out.get("page_seg") is not None:
            out["page_seg"][name] = np.where(
                mine, out["page_seg"][name], -2).astype(np.int32)
        w = out["write_eids"][name]
        keep = (pos.reshape(w.shape) // t) % members == mi
        out["write_eids"][name] = np.where(keep, w, -1).astype(np.int32)
    return out


def train_cell(cfg: ModelConfig, shape: ShapeSpec,
               micro_batches: int = 1, pods: int = 1) -> Cell:
    """The card's training batch: its rows of tokens and targets and the
    family's extra inputs (``Trainer.extra_batch``); ``pods``: the
    reference's pods (``mesh.card_share``)."""
    share = card_share(shape, pods=pods)
    b, s = share.rows, share.tokens
    arrays = {"tokens": ((b, s), "int32"), "targets": ((b, s), "int32")}
    if cfg.family == "encdec":
        arrays["enc_embeds"] = ((b, cfg.encoder_seq, cfg.d_model),
                                "bfloat16")
    if cfg.family == "vlm":
        arrays["mm_embeds"] = ((b, s, cfg.d_model), "bfloat16")
        arrays["mm_mask"] = ((b, s), "bool")
        arrays["mrope_pos"] = ((3, b, s), "int32")
    return Cell(kind="train", arrays=arrays, buffer_units=0,
                notes=dict(B=shape.global_batch, S=shape.seq_len, rows=b,
                           tokens=s, micro_batches=micro_batches))


def default_micro_batches(cfg: ModelConfig) -> int:
    """Microbatch count so train activations/dispatch fit a 16G chip
    (validated against the dry-run memory_analysis; see EXPERIMENTS.md)."""
    if cfg.num_experts >= 64:
        return 32
    if cfg.num_experts > 0:
        return 16
    if cfg.d_model >= 5120:
        return 16
    if cfg.d_model >= 3000:
        return 4
    if cfg.family == "ssm":
        return 8
    return 4


def wants_fsdp(cfg: ModelConfig) -> bool:
    """Enable FSDP for training when TP16-sharded weights alone would
    crowd a 16GB chip (counting fp32 grads + Adam moments)."""
    return cfg.d_model * cfg.d_ff * cfg.num_layers >= 24 * 5120 * 13824
