"""The 10 assigned architectures, exact configs from the assignment.

Sources per entry are noted inline ([hf:...] / [arXiv:...] as given).
"""
from __future__ import annotations

from .base import ModelConfig

# --- MoE -------------------------------------------------------------------
# dbrx-132b [hf:databricks/dbrx-base]: 40L d6144 48H GQA(kv=8) ff/expert 10752
# vocab 100352, 16 experts top-4 fine-grained
DBRX_132B = ModelConfig(
    name="dbrx-132b", family="moe", num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=10752,
    vocab_size=100352, num_experts=16, experts_per_token=4, moe_d_ff=10752,
    rope_theta=5e5,
)

# qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family]: 94L d4096 64H GQA(kv=4)
# moe_d_ff 1536, vocab 151936, 128 experts top-8
QWEN3_MOE_235B = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
    vocab_size=151936, num_experts=128, experts_per_token=8, moe_d_ff=1536,
    rope_theta=1e6,
)

# --- hybrid ------------------------------------------------------------------
# zamba2-1.2b [arXiv:2411.15242]: 38 Mamba2 blocks d2048, shared attn block
# (32H, kv=32) every 6 blocks, d_ff 8192, vocab 32000, ssm_state 64
ZAMBA2_1P2B = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=32000,
    mamba_d_state=64, mamba_headdim=64, mamba_expand=2, attn_every=6,
)

# --- dense -------------------------------------------------------------------
# qwen2.5-32b [hf:Qwen/Qwen2.5 family]: 64L d5120 40H GQA(kv=8) ff27648
# vocab 152064, QKV bias
QWEN2P5_32B = ModelConfig(
    name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=27648,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

# h2o-danube-3-4b [arXiv:2401.16818]: 24L d3840 32H GQA(kv=8) ff10240
# vocab 32000 — llama+mistral mix: alternating full / sliding-window layers
H2O_DANUBE3_4B = ModelConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    num_heads=32, num_kv_heads=8, head_dim=120, d_ff=10240, vocab_size=32000,
    attn_pattern=("full", "swa"), sliding_window=4096, rope_theta=5e5,
)

# granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: 40L d2048 32H GQA(kv=8)
# ff8192 vocab 49155
GRANITE3_2B = ModelConfig(
    name="granite-3-2b", family="dense", num_layers=40, d_model=2048,
    num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=49155,
    tie_embeddings=True, rope_theta=1e6,
)

# internlm2-1.8b [arXiv:2403.17297]: 24L d2048 16H GQA(kv=8) ff8192 vocab 92544
INTERNLM2_1P8B = ModelConfig(
    name="internlm2-1.8b", family="dense", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=92544,
    rope_theta=1e6,
)

# --- ssm ---------------------------------------------------------------------
# rwkv6-3b (Finch) [arXiv:2404.05892]: 32L d2560 attn-free, d_ff 8960,
# vocab 65536, head_size 64, data-dependent decay
RWKV6_3B = ModelConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, head_dim=64, d_ff=8960, vocab_size=65536,
    rwkv_head_size=64,
)

# --- vlm ---------------------------------------------------------------------
# qwen2-vl-2b [arXiv:2409.12191]: 28L d1536 12H GQA(kv=2) ff8960 vocab 151936
# M-RoPE; modality frontend stubbed (precomputed patch embeddings)
QWEN2_VL_2B = ModelConfig(
    name="qwen2-vl-2b", family="vlm", num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, head_dim=128, d_ff=8960, vocab_size=151936,
    qkv_bias=True, mrope=True, mm_hidden=1536, rope_theta=1e6,
)

# --- audio -------------------------------------------------------------------
# whisper-tiny [arXiv:2212.04356]: 4L enc + 4L dec, d384 6H ff1536 vocab 51865
# conv frontend stubbed (precomputed frame embeddings)
WHISPER_TINY = ModelConfig(
    name="whisper-tiny", family="encdec", num_layers=4, d_model=384,
    num_heads=6, num_kv_heads=6, head_dim=64, d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_seq=1500, tie_embeddings=True,
)

ARCHS = {
    c.name: c for c in [
        DBRX_132B, QWEN3_MOE_235B, ZAMBA2_1P2B, QWEN2P5_32B, H2O_DANUBE3_4B,
        GRANITE3_2B, INTERNLM2_1P8B, RWKV6_3B, QWEN2_VL_2B, WHISPER_TINY,
    ]
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from None
