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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

from ..configs.base import ModelConfig, ShapeSpec
from ..core.spec import BYTES_PER_UNIT
from ..core.spec import lcm as _lcm
from .mesh import card_share

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


def serve_cell(model, cfg: ModelConfig, shape: ShapeSpec) -> Cell:
    """The card's serve cell: one padded step of the card's rows (T = the
    whole sequence for prefill, 1 for decode) over a pool that holds the
    card's KV/state. Every KV type keeps every page (the port has no KV
    replica split: one card holds all KV heads)."""
    share = card_share(shape)
    b, s = share.rows, share.tokens
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
                min(spec.sliding_window + spec.tokens_per_page, s)) + 1
        else:
            npg = spec.pages_for_tokens(s)
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
    units = buffer_units_for(model, cfg, tokens_per_shard=s,
                             seqs_per_shard=b, enc_tokens_per_shard=enc_seq)
    return Cell(kind=shape.kind, arrays=arrays, buffer_units=units,
                notes=dict(B=shape.global_batch, S=shape.seq_len, rows=b,
                           tokens=s, sp=share.sp))


def train_cell(cfg: ModelConfig, shape: ShapeSpec,
               micro_batches: int = 1) -> Cell:
    """The card's training batch: its rows of tokens and targets and the
    family's extra inputs (``Trainer.extra_batch``)."""
    share = card_share(shape)
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
