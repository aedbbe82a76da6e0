"""Roofline-driven token-budget autotuning (a copy of
``repro/serving/autotune.py`` against the H100's roofline constants).

Seeding: the serving sweet spot for ``max_num_batched_tokens`` is the
compute/memory balance point of one step. A step reads every (total)
weight byte once from HBM and spends ~2 * n_active FLOPs per token, so
the step flips from bandwidth-bound to compute-bound around

    T* = PEAK_FLOPS * (2 bytes * n_total) / (HBM_BW * 2 FLOPs * n_active)
       = (PEAK_FLOPS / HBM_BW) * n_total / n_active

tokens (288 for a dense model on the H100, whose constants
``launch/roofline.py`` holds; higher for MoE, whose total/active ratio
exceeds 1). Below T* extra tokens in a step are
nearly free — the budget should at least reach it. A fraction of the
budget is reserved for decodes (``max_prefill_tokens_per_step``), the
scheduler's latency knob.

Online refinement (``observe``): live ``StepMetrics`` correct the static
model. When the host build dominates device wait, the step is
host-bound: bigger steps amortize host work — grow the budget. When the
modeled attention arithmetic intensity of recent steps falls under the
machine balance, attention has gone memory-bound (long contexts): shrink
the prefill cap so decode latency is not paying for bandwidth-bound
prefill work. One adjustment per observation window avoids oscillation.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional

from ..launch.roofline import HBM_BW, PEAK_FLOPS, count_params

QUANTUM = 16          # packed-stream token bucket quantum (_tok_bucket)
MIN_BUDGET = 32
MAX_BUDGET = 4096


def _round_q(n: float) -> int:
    return QUANTUM * max(1, round(n / QUANTUM))


def shard_pool_bytes(total_bytes: int, num_shards: int) -> int:
    """Even split of a fleet-wide KV pool across data-parallel shards.
    Each shard's manager builds its own LCM geometry from its slice; the
    floor just keeps a degenerate split from rounding to zero."""
    return max(1, total_bytes // max(1, num_shards))


def roofline_token_budget(model_cfg) -> int:
    """Compute/memory balance point T* of one serving step for this model
    config, rounded to the packed-stream bucket quantum."""
    n = count_params(model_cfg)
    t_star = (PEAK_FLOPS / HBM_BW) * n["total"] / max(1, n["active"])
    return max(MIN_BUDGET, min(MAX_BUDGET, _round_q(t_star)))


@dataclasses.dataclass
class BudgetAutotuner:
    """Seeds scheduler budgets from the roofline model and refines them
    online from live StepMetrics. The engine applies ``budget`` /
    ``prefill_cap`` whenever ``observe`` returns True."""

    model_cfg: object
    decode_reserve: float = 0.25     # budget fraction kept for decodes
    window: int = 16                 # steps per observation window
    # Data-parallel shard budgets: the roofline balance point T* is PER
    # DEVICE — a shard serving 1/N of the fleet's traffic still flips from
    # bandwidth- to compute-bound at the same step size, so the seed budget
    # does NOT shrink with the fleet. What does scale is the observation
    # window: a shard sees ~1/N of the arrivals, so it needs ~N× the steps
    # for an equally confident host-vs-device / bytes-growth trend before
    # it moves its budgets.
    num_shards: int = 1
    budget: int = dataclasses.field(init=False)
    prefill_cap: int = dataclasses.field(init=False)

    def __post_init__(self):
        self.budget = roofline_token_budget(self.model_cfg)
        self.prefill_cap = max(
            QUANTUM, _round_q(self.budget * (1.0 - self.decode_reserve)))
        self.window = int(self.window * max(1, self.num_shards))
        self._hist: Deque = deque(maxlen=self.window)
        self.adjustments = 0

    def observe(self, m) -> bool:
        """Feed one StepMetrics; returns True when budgets changed."""
        self._hist.append(m)
        if len(self._hist) < self.window:
            return False
        n = len(self._hist)
        # host side includes sampling (0 under device sampling); the device
        # side prefers the pipeline timing split's compute estimate when
        # the engine runs deep enough to report it (depth > 1), falling
        # back to the blocked-fetch wait (sync loop / metrics without the
        # split). Comparing host-vs-fetch alone would under-read device
        # time exactly when pipelining hides it best.
        host = sum(x.host_build_ms + getattr(x, "host_sample_ms", 0.0)
                   for x in self._hist) / n
        disp = sum(x.dispatch_compute_ms
                   if getattr(x, "dispatch_compute_ms", 0.0) > 0
                   else x.dispatch_ms for x in self._hist) / n
        half = n // 2
        byts_early = sum(x.attn_bytes_modeled
                         for x in list(self._hist)[:half])
        byts_late = sum(x.attn_bytes_modeled
                        for x in list(self._hist)[half:])
        floor = max(QUANTUM, _round_q(self.budget / 2))
        changed = False
        if host > disp and self.budget < MAX_BUDGET:
            # host-bound: bigger steps amortize schedule + batch build
            self.budget = min(MAX_BUDGET, _round_q(self.budget * 1.5))
            self.prefill_cap = max(
                self.prefill_cap,
                _round_q(self.budget * (1.0 - self.decode_reserve)))
            changed = True
        elif byts_late > 1.5 * byts_early and self.prefill_cap > floor:
            # attention HBM traffic is growing fast (contexts outrunning
            # the block-sparse skip): reserve more of the step for decodes
            # instead of bandwidth-bound prefill work. Floor at half the
            # budget so prefill throughput never collapses.
            self.prefill_cap = max(floor, _round_q(self.prefill_cap / 2))
            changed = True
        if changed:
            self.adjustments += 1
            self._hist.clear()
        return changed
