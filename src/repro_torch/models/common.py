"""Shared building blocks: norms (RMS and layer) and the bf16 linear, with
the reference's rounding points (``repro/models/common.py``)."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def set_matmul_precision() -> None:
    """Pin the CUDA matmul settings the reference's numerics assume.

    * bf16 GEMMs must reduce in fp32 all the way: cuBLAS may otherwise
      round split-K partial sums to bf16, which is coarser than the
      reference's ``preferred_element_type=float32`` accumulation and
      would move logits by more than the greedy tie band
      (``serving.sampler.TIE_EPS``).
    * fp32 products (the logits head, the biased projections) must not
      silently run in TF32, which keeps about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``; no op is issued when it already is (each op of
    the eager serve step costs host time)."""
    return t if t.dtype == dtype else t.to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """fp32 RMSNorm against fp32 weights, cast back to ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * _as(weight, torch.float32)).to(
        x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm as the reference computes it: mean and (biased) variance
    in fp32, times rsqrt(var + eps), fp32 weight and bias, cast back to
    ``x.dtype``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps)
    return (y * _as(weight, torch.float32) + _as(bias, torch.float32)).to(
        x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor = None) -> torch.Tensor:
    """x: (..., in), w: (in, out). bf16 operands, fp32 accumulation, one
    rounding of the output to ``x.dtype``. ``w`` is rounded to ``x.dtype``
    first (the reference's ``w.astype(x.dtype)``), so fp32 training masters
    and bf16 serving weights give the same product. With a bias the sum is
    formed in fp32 before that rounding, as the reference does; the bf16
    product is exact in fp32, so the fp32 matmul there computes the same
    sum."""
    w = _as(w, x.dtype)
    if b is None:
        return torch.matmul(x, w)
    y = torch.matmul(x.float(), w.float()) + _as(b, torch.float32)
    return y.to(x.dtype)


def gqa_tp_layout(num_heads: int, num_kv_heads: int, tp: int
                  ) -> Tuple[int, int, int, int]:
    """Head layout for tensor parallelism over ``tp`` shards (a copy of
    the reference's). Returns (q_pad, q_local, kv_tp, kv_local): the K/V
    heads are really split ``kv_tp = gcd(kv_heads, tp)`` ways, each shard
    stores ``kv_local`` of them (replicated ``tp // kv_tp`` times), and
    the q heads are padded to ``q_pad`` (each K/V group to a multiple of
    the replicas), ``q_local`` a shard."""
    kv_tp = math.gcd(num_kv_heads, tp)
    kv_local = num_kv_heads // kv_tp
    repl = tp // kv_tp
    group = num_heads // num_kv_heads
    group_pad = -(-group // repl) * repl
    q_pad = num_kv_heads * group_pad
    q_local = q_pad // tp
    if q_pad % tp:
        raise ValueError(f"{num_heads} / {num_kv_heads} heads do not split "
                         f"over tp {tp}")
    return q_pad, q_local, kv_tp, kv_local
