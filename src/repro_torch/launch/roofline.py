"""Roofline analysis of one card (``repro/launch/roofline.py``): two
analytic terms per (arch x shape), from the card's share of the cell
(``mesh.card_share``), and the table of the fit planner's records.

  compute = FLOPs of the card's share  / peak bf16 FLOP/s  (989 TFLOP/s)
  memory  = bytes of the card's share  / HBM bandwidth     (3.35 TB/s)

One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity, at
its full 700 W power limit. These are the constants every bound in the
port's measurements uses. One card runs no collective, so there is no link
term. MODEL_FLOPS uses 6·N·D for training and 2·N·D for inference steps,
with N_active for MoE. ``count_params``, ``model_flops_per_device`` and
``loop_factor`` are copied from the reference unchanged.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR]
prints the planner's records (``launch/dryrun.py``) as a markdown table
and writes them to <DIR>/roofline.json.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .mesh import card_share

PEAK_FLOPS = 989e12     # H100 SXM, dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12        # H100 SXM, HBM3 bytes/s


def count_params(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    V = cfg.vocab_size
    H, KV = cfg.num_heads, cfg.num_kv_heads
    attn = d * hd * (2 * H + 2 * KV)
    out = {"embed": V * d * (1 if cfg.tie_embeddings else 2)}
    if cfg.family == "ssm":
        att_dim = d
        per_layer = 5 * d * att_dim + att_dim * d + 2 * d * cfg.d_ff \
            + d * d + 64 * (d + att_dim)
        out["layers"] = cfg.num_layers * per_layer
        out["active"] = out["layers"] + out["embed"]
        out["total"] = out["active"]
        return out
    if cfg.family == "hybrid":
        di = cfg.mamba_expand * d
        N = cfg.mamba_d_state
        mamba = 2 * d * di + 2 * d * N + d * (di // cfg.mamba_headdim) \
            + di * d
        shared = attn + 3 * d * cfg.d_ff
        out["layers"] = cfg.num_layers * mamba + shared
        out["active"] = out["layers"] + out["embed"]
        out["total"] = out["active"]
        return out
    if cfg.family == "encdec":
        per = attn + 2 * d * cfg.d_ff
        dec = 2 * attn + 2 * d * cfg.d_ff
        out["layers"] = cfg.encoder_layers * per + cfg.num_layers * dec
        out["active"] = out["layers"] + out["embed"]
        out["total"] = out["active"]
        return out
    if cfg.num_experts:
        expert = 3 * d * cfg.moe_d_ff
        per_layer_dense = attn + d * cfg.num_experts
        out["layers"] = cfg.num_layers * (
            per_layer_dense + cfg.num_experts * expert)
        active = cfg.num_layers * (
            per_layer_dense + cfg.experts_per_token * expert)
        out["active"] = active + out["embed"]
        out["total"] = out["layers"] + out["embed"]
        return out
    per_layer = attn + 3 * d * cfg.d_ff
    out["layers"] = cfg.num_layers * per_layer
    out["active"] = out["layers"] + out["embed"]
    out["total"] = out["active"]
    return out


def model_flops_per_device(cfg, shape, devices, micro=1) -> float:
    n = count_params(cfg)
    n_active = n["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / devices
    # decode: one token per sequence + attention KV reads (2*2*S*d_kv FLOPs)
    toks = shape.global_batch
    attn_read = 4.0 * shape.seq_len * cfg.num_kv_heads * cfg.head_dim \
        * max(1, cfg.num_layers) * toks
    return (2.0 * n_active * toks + attn_read) / devices


def loop_factor(cfg, shape) -> int:
    """Static trip count of the layer scan (XLA cost_analysis counts while
    bodies ONCE — see EXPERIMENTS.md 'loop-accounting' note)."""
    if cfg.family == "hybrid":
        base = cfg.num_layers // cfg.attn_every
    elif cfg.family in ("ssm", "encdec"):
        base = cfg.num_layers
    else:
        base = cfg.num_layers // max(1, len(cfg.attn_pattern))
    if shape.kind == "train":
        from .input_specs import default_micro_batches
        base *= default_micro_batches(cfg)
    return max(1, base)


def kv_bytes_per_device(cfg, shape) -> int:
    """Bytes of KV/state the card holds for its share of the cell (every
    KV head: the card folds the tp shards, so there is no replica split).
    Sliding-window types hold their window, as in the reference."""
    from ..models import build_model
    share = card_share(shape)
    b_loc, toks = share.rows, share.tokens
    total = 0
    for sp in build_model(cfg).kv_specs():
        if sp.kind in ("mamba", "rwkv"):
            total += b_loc * sp.page_units
        elif sp.kind == "cross_attn":
            total += b_loc * sp.pages_for_tokens(cfg.encoder_seq) \
                * sp.page_units
        elif sp.kind == "swa":
            w = min(sp.sliding_window, toks)
            total += b_loc * sp.pages_for_tokens(max(1, w)) * sp.page_units
        else:
            total += b_loc * sp.pages_for_tokens(toks) * sp.page_units
    return 2 * total            # bf16


def analytic_terms(cfg, shape):
    """First-principles (FLOPs, bytes) of the card's share of the cell:
    the reference's ``analytic_terms`` with every weight on the card (tp
    1) and the card's rows (``card_share``) in place of a 16 x 16 mesh's
    per-device share."""
    n = count_params(cfg)
    share = card_share(shape)
    rows, seq = share.rows, share.tokens
    params_dev = 2 * n["total"]
    kvb = kv_bytes_per_device(cfg, shape)
    d_attn = cfg.num_kv_heads * cfg.head_dim
    lf = getattr(cfg, "num_layers", 0)
    if shape.kind == "train":
        tokens = rows * seq
        flops = 6.0 * n["active"] * tokens
        # causal attention flops (fwd+bwd ~3x fwd)
        flops += 3 * 2 * 2 * cfg.num_heads * cfg.head_dim \
            * seq ** 2 / 2 * rows * lf
        act = tokens * cfg.d_model * 2 * lf * 4
        bytes_dev = 3 * params_dev * 2 + act     # fp32 grads+params rw
    elif shape.kind == "prefill":
        tokens = rows * seq
        flops = 2.0 * n["active"] * tokens
        flops += 2 * 2 * cfg.num_heads * cfg.head_dim \
            * seq ** 2 / 2 * rows * lf
        bytes_dev = params_dev + 2 * kvb + tokens * cfg.d_model * 2 * lf
    else:
        flops = 2.0 * n["active"] * rows + 4.0 * seq * d_attn * lf * rows
        bytes_dev = params_dev + kvb
    return flops, bytes_dev


def load(dirname):
    """The planner's records in ``dirname`` with their roofline terms."""
    from ..configs import ARCHS, SHAPES_BY_NAME
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        if f.endswith("roofline.json"):
            continue
        with open(f) as fh:
            r = json.load(fh)
        cfg = ARCHS[r["arch"]]
        shape = SHAPES_BY_NAME[r["shape"]]
        t_c, t_m = r["roofline"]["t_compute_s"], r["roofline"]["t_memory_s"]
        mf = model_flops_per_device(cfg, shape, card_share(shape).cards)
        bound = max(t_c, t_m)
        rows.append(dict(
            r, t_compute_s=t_c, t_memory_s=t_m,
            dominant="compute" if t_c >= t_m else "memory",
            model_flops_per_dev=mf, loop_factor=loop_factor(cfg, shape),
            roofline_frac=(mf / PEAK_FLOPS) / bound if bound else 0.0))
    return rows


def _gb(x):
    return "-" if x is None else f"{x / 1e9:.2f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    with open(os.path.join(args.dir, "roofline.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    print("| arch | shape | layers | weights GB | pool GB | activations "
          "GB | predicted peak GB | fits | largest depth | measured peak "
          "GB | measured ms | compute s | memory s | dominant | roofline |")
    print("|" + "---|" * 15)
    for r in rows:
        m = r.get("measured") or {}
        print(f"| {r['arch']} | {r['shape']} | {r['full_depth']} "
              f"| {_gb(r['terms']['weights'])} "
              f"| {_gb(r['terms']['pool'])} "
              f"| {_gb(r['terms']['activations'])} "
              f"| {_gb(r['peak_bytes'])} | {'yes' if r['fits'] else 'no'} "
              f"| {r['max_depth']} | {_gb(m.get('peak_bytes'))} "
              f"| {m.get('ms', '-')} | {r['t_compute_s']:.2e} "
              f"| {r['t_memory_s']:.2e} | {r['dominant']} "
              f"| {r['roofline_frac']:.2f} |")
    return 0


if __name__ == "__main__":
    main()
