"""Cache-aware request router for data-parallel multi-engine serving.

Jenga's evaluation (and vLLM's production deployments) put the allocator
inside a FLEET of engine replicas: N independent engines, each with its
own ``JengaKVCacheManager`` / scheduler / in-flight ring, behind a
front-end router that decides which shard serves each request. The router
here implements the placement policy; the fleet orchestration (stepping,
health polling, failover) lives in ``serving.dp_engine``.

Placement (``Router.place``) is CACHE-AWARE: the request's prompt
boundary-hash chains (``Request.prompt_boundary_hashes`` /
``prompt_state_hashes`` — the exact keys each shard's pools register
pages under) are probed against every accepting shard's prefix cache, and
the shard holding the longest chain match wins: prefix-cache hits are the
single biggest per-request cost lever (hit tokens are never recomputed),
and only the shard that computed a prefix has it cached. Ties — and the
no-hit case — fall back to LEAST-LOADED by outstanding token count, then
to the lowest shard id, so placement is a deterministic function of
(config, arrival order, shard state): replaying the same workload
reproduces the same placements bit for bit.

Health feeds back as a routing COST in token units: every poll the router
reads each shard's cumulative defer/preempt counters (``ShardHealth``);
a positive delta bumps the shard's cost, quiet polls decay it. The cost
subtracts from the shard's hit score — a shard thrashing at its memory
ceiling stops attracting traffic even where its cache matches, which is
the backpressure half of the paper's fleet story: more traffic to a
defer-then-preempt-ing shard shrinks its batches further.

``policy="round-robin"`` keeps a placement-blind baseline for A/Bs
(``bench_throughput.run_router_ab`` measures the prefix-hit-rate gap).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .engine import ShardHealth
from .request import Request

ROUTE_CACHE_AWARE = "cache-aware"
ROUTE_ROUND_ROBIN = "round-robin"
ROUTE_LEAST_LOADED = "least-loaded"
POLICIES = (ROUTE_CACHE_AWARE, ROUTE_ROUND_ROBIN, ROUTE_LEAST_LOADED)


@dataclasses.dataclass
class RouterConfig:
    num_shards: int = 2
    policy: str = ROUTE_CACHE_AWARE
    # health costing, in TOKEN units so it compares against prefix-hit
    # lengths: each defer/preempt event observed in a health poll bumps the
    # shard's routing cost by ``cost_per_event``; a poll with no new events
    # decays it by ``cost_decay``. With 16-token pages, one event outweighs
    # a one-page hit — repeated thrashing outweighs any realistic hit.
    cost_per_event: float = 16.0
    cost_decay: float = 0.5
    # recorded for reproducibility bookkeeping (placement itself is a
    # deterministic function of arrival order + shard state; the seed is
    # part of the workload identity tests replay under)
    seed: int = 0


@dataclasses.dataclass
class Placement:
    """One routing decision, recorded for determinism tests and benches."""
    rid: str
    shard: int
    hit_tokens: int            # boundary-hash chain match on the winner
    load_tokens: int           # winner's outstanding tokens at placement
    cost: float                # winner's health cost at placement
    readmitted: bool = False   # re-placed after a shard drain/failover


def prefix_match_tokens(req: Request, mgr) -> int:
    """Longest prompt prefix (in tokens) whose boundary-hash chain is held
    by ``mgr``'s prefix cache, across this model's cache types.

    Token-storage types (full_attn/swa) match their per-page chain hashes
    in order and stop at the first miss (a broken chain cannot be
    extended); state types (mamba/rwkv) match checkpoint-boundary hashes
    (any boundary hit restores to that position, so the LAST hit wins).
    The joint estimate is the MIN across types — a prefix only restores if
    every type can serve it (the router-side approximation of the §5.2
    intersection the shard's ``lookup_prefix`` computes exactly at
    admission). mm/cross-attn streams are content-addressed per item and
    carry no prefix ordering, so they do not vote."""
    if not mgr.enable_prefix_caching:
        return 0
    best: Optional[int] = None
    for spec in mgr.specs:
        pool = mgr.pools[spec.name]
        salt = mgr.salts[spec.name]
        if spec.kind in ("full_attn", "swa"):
            n_pages = 0
            for h in req.prompt_boundary_hashes(spec.tokens_per_page, salt):
                if pool.lookup(h) is None:
                    break
                n_pages += 1
            tokens = n_pages * spec.tokens_per_page
        elif spec.kind in ("mamba", "rwkv"):
            tokens = 0
            for pos, h in req.prompt_state_hashes(
                    spec.state_checkpoint_interval, salt):
                if pool.lookup(h) is not None:
                    tokens = pos
        else:
            continue
        best = tokens if best is None else min(best, tokens)
    if best is None:
        return 0
    # at least one prompt token must be computed (mirrors lookup_prefix)
    return min(best, max(0, len(req.prompt) - 1))


class Router:
    """Placement policy + health costing over a fleet of engine shards.

    The router never touches the shards itself — ``place`` reads their
    caches/loads and returns a shard id; ``observe`` digests health
    snapshots the fleet driver polls. ``shards`` is any sequence of
    objects with ``.accepting`` (bool) and ``.engine`` (an ``Engine``)."""

    def __init__(self, cfg: RouterConfig):
        assert cfg.policy in POLICIES, cfg.policy
        assert cfg.num_shards >= 1, cfg.num_shards
        self.cfg = cfg
        self.costs: List[float] = [0.0] * cfg.num_shards
        self.placements: List[Placement] = []
        self._rr = 0
        self._events_seen: Dict[int, int] = {}

    # ------------------------------------------------------------- health
    def observe(self, shard_id: int, health: ShardHealth) -> None:
        """Fold one shard health snapshot into its routing cost: new
        defer/preempt events bump it, quiet polls decay it toward zero."""
        now = health.defer_count + health.preemption_count
        delta = now - self._events_seen.get(shard_id, 0)
        self._events_seen[shard_id] = now
        if delta > 0:
            self.costs[shard_id] += self.cfg.cost_per_event * delta
        else:
            self.costs[shard_id] *= self.cfg.cost_decay
            if self.costs[shard_id] < 1e-9:
                self.costs[shard_id] = 0.0

    # ---------------------------------------------------------- placement
    def place(self, req: Request, shards: Sequence, *,
              readmitted: bool = False,
              want: Optional[str] = None) -> int:
        """Pick the shard for ``req``. Deterministic: cache-aware score
        (hit tokens minus health cost) first, least-loaded second, lowest
        shard id third. Raises if no shard is accepting.

        ``want`` restricts candidates by disaggregation role:
        ``"prefill"`` (fresh arrivals — prefill-capable shards) or
        ``"decode"`` (handoff targets — decode-capable shards); colocated
        ``"both"`` shards qualify for either. If no accepting shard has a
        qualifying role the filter is DROPPED rather than failing — a
        degraded fleet (all decode shards dead) keeps serving colocated."""
        cands = [i for i, sh in enumerate(shards) if sh.accepting]
        if want is not None:
            roled = [i for i in cands
                     if getattr(shards[i].engine, "role", "both")
                     in ("both", want)]
            if roled:
                cands = roled
        if not cands:
            raise RuntimeError("router: no accepting shard")
        policy = self.cfg.policy
        if policy == ROUTE_ROUND_ROBIN:
            best = cands[self._rr % len(cands)]
            self._rr += 1
            hit = 0
        else:
            hits = {
                i: (prefix_match_tokens(req, shards[i].engine.mgr)
                    if policy == ROUTE_CACHE_AWARE else 0)
                for i in cands
            }
            loads = {i: shards[i].engine.outstanding_tokens() for i in cands}
            best = max(cands, key=lambda i: (hits[i] - self.costs[i],
                                             -loads[i], -i))
            hit = hits[best]
        req.shard_history.append(best)
        self.placements.append(Placement(
            rid=req.rid, shard=best, hit_tokens=hit,
            load_tokens=shards[best].engine.outstanding_tokens(),
            cost=self.costs[best], readmitted=readmitted))
        return best
