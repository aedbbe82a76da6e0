"""Model / shape configuration dataclasses for all assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention pattern, cycled over layers: entries "full" | "swa"
    attn_pattern: Tuple[str, ...] = ("full",)
    sliding_window: int = 4096
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert FFN dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Mamba2 (hybrid / ssm families)
    mamba_d_state: int = 0
    mamba_headdim: int = 64
    mamba_expand: int = 2
    mamba_conv_width: int = 4
    attn_every: int = 0              # hybrid: shared attn block every k mamba blocks
    # RWKV6
    rwkv_head_size: int = 64
    # VLM
    mrope: bool = False
    mm_hidden: int = 0               # vision-embedding width (post-merger)
    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_seq: int = 1500          # stub frontend frames
    # misc
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    tokens_per_page: int = 16
    # serving-scale knob: max KV pool fraction of HBM (per device)
    kv_pool_bytes: int = 4 << 30

    # ------------------------------------------------------------- helpers
    @property
    def attn_kind_per_layer(self) -> Tuple[str, ...]:
        if self.family in ("ssm",):
            return ()
        n = self.num_layers
        pat = self.attn_pattern
        return tuple(pat[i % len(pat)] for i in range(n))

    @property
    def num_swa_layers(self) -> int:
        return sum(1 for k in self.attn_kind_per_layer if k == "swa")

    @property
    def num_full_layers(self) -> int:
        return sum(1 for k in self.attn_kind_per_layer if k == "full")

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch decode with bounded per-token state at 500k context?
        True for SSM / hybrid / all-SWA mixes with at least no unbounded
        full-attention requirement... full layers make it quadratic."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True   # few attn layers; we run them sequence-parallel
        return self.num_full_layers == 0

    def validate(self) -> None:
        assert self.d_model > 0 and self.num_layers > 0
        if self.family not in ("ssm",):
            assert self.num_heads % self.num_kv_heads == 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """The assigned shape set, with the long_500k skip rule for pure
    full-attention archs (documented in DESIGN.md)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.is_sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        tokens_per_page=4,
        kv_pool_bytes=64 << 20,
    )
    if cfg.num_experts:
        base.update(num_experts=4, experts_per_token=2, moe_d_ff=64)
    if cfg.mamba_d_state:
        base.update(mamba_d_state=16, mamba_headdim=16)
    if cfg.family == "hybrid":
        base.update(num_layers=5, attn_every=2)
    if cfg.family == "ssm":
        base.update(rwkv_head_size=16)
    if cfg.family == "encdec":
        base.update(encoder_layers=2, num_layers=2, encoder_seq=16)
    if cfg.family == "vlm":
        base.update(mm_hidden=64)
    if cfg.sliding_window:
        base.update(sliding_window=8)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
