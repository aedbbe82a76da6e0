"""Multi-engine data-parallel serving: N engine shards behind a router
(a copy of ``repro/serving/dp_engine.py``; every shard's ``Engine`` runs
on the fleet's ``device``, so on one card the shards share its memory,
each with its own pool, and all of them one parameter tree).

``DPEngine`` owns ``num_shards`` fully independent ``Engine`` instances —
each with its own ``JengaKVCacheManager``, scheduler, in-flight ring and
(optionally) budget autotuner — and drives them round-robin, one engine
step per shard per fleet tick. Requests enter through the front-end
``submit``, which places them with the cache-aware ``Router``
(``serving.router``); results, metrics and health aggregate back up.
The model object (and its parameter tree) is shared — shards
differ only in cache/scheduler state, which is what data parallelism
means here. ``run_plan`` being a pure function of (plan, mirrors) is what
makes this an orchestration problem rather than a model one: nothing
below the engine knows the fleet exists, and the per-shard
``prepare``/``dispatch``/``fetch`` phases are the natural RPC boundary
when the shards move out of process.

Fault handling (exercised by the multi-engine fuzz harness):

  * ``inject_stall(i, resume_after=k)`` — the shard stops stepping and
    accepting; its queued-but-unstarted requests (never part of a
    dispatched plan) are drained and re-admitted elsewhere, while started
    work stays put and resumes with the shard after ``k`` ticks. An
    indefinite stall (``resume_after=None``) escalates to a crash after
    ``stall_escalate_ticks`` so started work is not stranded forever.
  * ``inject_crash(i)`` — the shard is dead: its in-flight ring is
    dropped, EVERY unfinished request is reset (partial outputs
    discarded, pages freed uncached) and re-admitted elsewhere. Greedy
    and the seeded temperature draws are deterministic in (rid,
    position), so the recompute reproduces the same tokens — failover is
    exactly-once with bit-identical outputs.

When every accepting shard is down, re-admissions park at the front end
and are re-placed as soon as a shard accepts again.

Determinism: shards are stepped in id order, placement is a deterministic
function of (config, arrival order, shard state), and each shard is a
plain ``Engine`` — so a fleet run is reproducible tick for tick, and any
single shard's execution can be replayed on a standalone engine by
re-submitting the same requests at the same shard-local steps
(``tests/test_router.py`` asserts both; ``tests/test_torch_router.py``
holds the port to the reference).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

from .. import resolve_device
from ..core.request import SequenceState
from .autotune import BudgetAutotuner, shard_pool_bytes
from .engine import Engine, EngineConfig, ShardHealth, StepMetrics
from .request import Request, Status
from .router import Router, RouterConfig


def _default_shards() -> int:
    return int(os.environ.get("REPRO_ROUTER_SHARDS", "2") or 2)


class EngineShard:
    """One engine replica plus its fleet-side liveness bookkeeping."""

    def __init__(self, sid: int, engine: Engine):
        self.sid = sid
        self.engine = engine
        self.alive = True           # False: crashed, permanently out
        self.accepting = True       # False: not a placement candidate
        # not-None: stalled. Fleet tick to resume at, or None-sentinel -1
        # for an indefinite stall (candidate for crash escalation).
        self.stalled_until: Optional[int] = None
        self.stalled_since: Optional[int] = None
        self.finished_seen = 0      # finish-tick stamping cursor

    @property
    def stalled(self) -> bool:
        return self.stalled_until is not None

    def has_work(self) -> bool:
        return self.engine.scheduler.has_work() or self.engine.has_inflight


class DPEngine:
    """Front end of a data-parallel engine fleet (see module docstring).

    ``cfg.kv_pool_bytes`` is the FLEET-wide pool by default, split evenly
    across shards (``split_pool=False`` makes it per-shard — tests use
    that to force tiny shard pools). With ``cfg.autotune_budgets``, each
    shard gets its own shard-aware ``BudgetAutotuner`` (per-device
    roofline seed, observation window scaled by the fleet size)."""

    def __init__(self, model, cfg: EngineConfig,
                 router_cfg: Optional[RouterConfig] = None, *,
                 num_shards: Optional[int] = None,
                 policy: Optional[str] = None,
                 roles: Optional[Sequence[str]] = None,
                 params=None, split_pool: bool = True,
                 stall_escalate_ticks: int = 0, seed: int = 0,
                 device="cuda"):
        if router_cfg is None:
            router_cfg = RouterConfig(
                num_shards=num_shards or _default_shards())
        if num_shards is not None:
            router_cfg = dataclasses.replace(router_cfg,
                                             num_shards=num_shards)
        if policy is not None:
            router_cfg = dataclasses.replace(router_cfg, policy=policy)
        n = router_cfg.num_shards
        self.router = Router(router_cfg)
        self.stall_escalate_ticks = stall_escalate_ticks
        shard_cfg = cfg
        if split_pool and n > 1:
            shard_cfg = dataclasses.replace(
                cfg, kv_pool_bytes=shard_pool_bytes(cfg.kv_pool_bytes, n))
        dev = resolve_device(device)
        params = params if params is not None else model.init(seed, dev)
        if roles is not None:
            assert len(roles) == n, (len(roles), n)
            assert all(r in ("both", "prefill", "decode") for r in roles), \
                roles
        self.shards: List[EngineShard] = []
        for sid in range(n):
            cfg_i = shard_cfg
            if roles is not None:
                cfg_i = dataclasses.replace(shard_cfg, role=roles[sid])
            eng = Engine(model, cfg_i, params=params, seed=seed, device=dev)
            if shard_cfg.autotune_budgets:
                eng.autotuner = BudgetAutotuner(model.cfg, num_shards=n)
                eng.scheduler.set_budgets(eng.autotuner.budget,
                                          eng.autotuner.prefill_cap)
            self.shards.append(EngineShard(sid, eng))
        self.tick = 0
        self.submit_tick: Dict[str, int] = {}
        self.finish_tick: Dict[str, int] = {}
        self._parked: List[Request] = []    # re-admissions with no shard up
        # prefill->decode handoff log (one dict per completed handoff) and
        # the count of colocated failovers (prefill shards flipped to
        # "both" because no decode-capable shard was left)
        self.handoffs: List[dict] = []
        self.role_failovers = 0

    # -------------------------------------------------------------- submit
    def submit(self, req: Request, readmitted: bool = False) -> int:
        """Route and enqueue one request; returns the shard id (-1 when
        parked because no shard is accepting)."""
        if not any(sh.accepting for sh in self.shards):
            self._parked.append(req)
            self.submit_tick.setdefault(req.rid, self.tick)
            return -1
        # fresh arrivals need a prefill-capable shard; decode-only shards
        # receive work through the handoff path only
        sid = self.router.place(req, self.shards, readmitted=readmitted,
                                want="prefill")
        self.shards[sid].engine.submit(req)
        self.submit_tick.setdefault(req.rid, self.tick)
        return sid

    def _readmit(self, reqs: List[Request]) -> None:
        for req in reqs:
            self.submit(req, readmitted=True)

    # ------------------------------------------------------ fault injection
    def inject_stall(self, sid: int, resume_after: Optional[int] = None
                     ) -> List[Request]:
        """Stall shard ``sid``: it stops stepping and accepting; its
        never-started requests move elsewhere. Transient stalls resume
        after ``resume_after`` ticks; indefinite ones escalate to a crash
        after ``stall_escalate_ticks`` (if configured) so started work is
        not stranded. Returns the drained (now re-admitted) requests."""
        sh = self.shards[sid]
        assert sh.alive, f"shard {sid} already crashed"
        sh.accepting = False
        sh.stalled_until = (-1 if resume_after is None
                            else self.tick + resume_after)
        sh.stalled_since = self.tick
        drained = sh.engine.drain_requests(unstarted_only=True, cache=True)
        self._readmit(drained)
        return drained

    def inject_crash(self, sid: int) -> List[Request]:
        """Kill shard ``sid``: drop its in-flight ring, free every page
        uncached, reset and re-admit every unfinished request. Returns the
        failed-over requests."""
        sh = self.shards[sid]
        sh.alive = False
        sh.accepting = False
        sh.stalled_until = None
        drained = sh.engine.drain_requests(unstarted_only=False)
        self._readmit(drained)
        return drained

    # ---------------------------------------------------------------- step
    def step(self) -> List[StepMetrics]:
        """One fleet tick: step every live, unstalled shard once (in shard
        id order — determinism), poll health into the router, handle stall
        resume/escalation, re-place parked requests, stamp finishes."""
        self.tick += 1
        out: List[StepMetrics] = []
        for sh in self.shards:
            if not sh.alive:
                continue
            if sh.stalled:
                if 0 <= sh.stalled_until <= self.tick:
                    sh.stalled_until = None     # stall over: resume
                    sh.stalled_since = None
                    sh.accepting = True
                elif (sh.stalled_until < 0 and self.stall_escalate_ticks
                        and self.tick - sh.stalled_since
                        >= self.stall_escalate_ticks):
                    self.inject_crash(sh.sid)   # stranded started work
                    continue
                else:
                    continue
            m = sh.engine.step()
            if m is not None:
                out.append(m)
            self.router.observe(sh.sid, sh.engine.health_snapshot())
        self._do_handoffs()
        if self._parked and any(sh.accepting for sh in self.shards):
            parked, self._parked = self._parked, []
            self._readmit(parked)
        for sh in self.shards:
            fin = sh.engine.finished
            for req in fin[sh.finished_seen:]:
                self.finish_tick.setdefault(req.rid, self.tick)
            sh.finished_seen = len(fin)
        return out

    # ------------------------------------------ prefill->decode handoffs
    def _do_handoffs(self) -> None:
        """Move every handoff-ready request (prompt complete + first token
        sampled on a prefill shard, nothing in flight) to a decode-capable
        shard: export the typed page set, place with the router
        (``want="decode"``), adopt into the destination's pools + prefix
        cache, device-copy the pages across runners, and re-admit the
        request as a whole-prompt prefix hit — ``num_computed`` set to the
        prompt length, ``started`` reset, ZERO prefill tokens recomputed.

        Failure handling: adoption failure (destination pool pressure)
        cancels the export and retries next tick; a fleet with no live
        decode-capable shard flips its prefill shards to colocated "both"
        so requests finish where they are (degraded, but serving)."""
        srcs = [sh for sh in self.shards
                if sh.alive and not sh.stalled and sh.engine.role == "prefill"
                and sh.engine.handoff_ready()]
        if not srcs:
            return
        can_decode = any(
            sh.alive and sh.accepting and sh.engine.role in ("both", "decode")
            for sh in self.shards)
        if not can_decode:
            # colocated failover: no decode-capable shard left — prefill
            # shards take their parked requests through decode themselves
            for sh in self.shards:
                if sh.alive and sh.engine.role == "prefill":
                    sh.engine.set_role("both")
            self.role_failovers += 1
            return
        for sh in srcs:
            for req in sh.engine.handoff_ready():
                export = sh.engine.begin_handoff(req)
                dst_sid = self.router.place(req, self.shards, want="decode")
                dst = self.shards[dst_sid]
                if dst is sh:       # filter fell back to the source itself
                    sh.engine.cancel_handoff(req, export)
                    continue
                src_seq = req.seq
                dst_seq = SequenceState(
                    rid=req.rid, tokens=list(src_seq.tokens),
                    mm_items=src_seq.mm_items,
                    encoder_items=src_seq.encoder_items)
                ok, pairs = dst.engine.mgr.adopt_request(dst_seq, export)
                if not ok:
                    sh.engine.cancel_handoff(req, export)
                    continue
                # copy stream: exported pages -> the destination's buffer
                dst.engine.runner.adopt_pages(sh.engine.runner, pairs)
                rows = sh.engine.sample_log.pop(req.rid, None)
                sh.engine.complete_handoff(req, export)
                req.seq = dst_seq
                req.status = Status.WAITING
                req.started = False
                dst.engine.submit(req)      # admits as a whole-prompt hit
                if rows is not None:        # keep recorded rows aligned
                    dst.engine.sample_log[req.rid] = rows
                self.handoffs.append(dict(
                    rid=req.rid, src=sh.sid, dst=dst_sid,
                    tokens=export.num_tokens, pages=len(pairs),
                    tick=self.tick))

    @property
    def has_work(self) -> bool:
        """Unfinished work the fleet can still make progress on. An
        indefinitely stalled shard with no escalation configured does NOT
        count — its started requests are genuinely stranded (a hung device
        holding work forever), which callers observe as missing finishes."""
        if self._parked:
            return True
        for sh in self.shards:
            if not sh.alive or not sh.has_work():
                continue
            if not sh.stalled:
                return True
            if sh.stalled_until >= 0 or self.stall_escalate_ticks:
                return True     # will resume, or will escalate to failover
        return False

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        while self.has_work and self.tick < max_ticks:
            self.step()
        return self.finished

    # ---------------------------------------------------------- aggregation
    @property
    def finished(self) -> List[Request]:
        """Every finished request fleet-wide (crashed shards' pre-crash
        finishes included — those responses already left the building)."""
        return [r for sh in self.shards for r in sh.engine.finished]

    @property
    def sample_log(self):
        """Per-request recorded sample rows, taken from the shard that
        FINISHED each request (a failed-over request has a partial, stale
        log on the shard it was drained from)."""
        out = {}
        for sh in self.shards:
            log = sh.engine.sample_log
            for r in sh.engine.finished:
                if r.rid in log:
                    out[r.rid] = log[r.rid]
        return out

    def health(self) -> List[ShardHealth]:
        return [sh.engine.health_snapshot() for sh in self.shards]

    def check_invariants(self) -> None:
        for sh in self.shards:
            sh.engine.mgr.check_invariants()

    def fleet_stats(self) -> dict:
        """Aggregate counters for benches/tests: per-shard steps and
        placement mix, fleet-wide prefix hit rate, failover counts."""
        hit = sum(sh.engine.mgr.prefix_hit_tokens_total
                  for sh in self.shards)
        query = sum(sh.engine.mgr.prefix_query_tokens_total
                    for sh in self.shards)
        placed: Dict[int, int] = {}
        readmitted = 0
        for p in self.router.placements:
            placed[p.shard] = placed.get(p.shard, 0) + 1
            readmitted += int(p.readmitted)
        return dict(
            ticks=self.tick,
            finished=len(self.finished),
            steps_per_shard=[sh.engine.step_count for sh in self.shards],
            requests_per_shard=[placed.get(sh.sid, 0)
                                for sh in self.shards],
            readmissions=readmitted,
            prefix_hit_tokens=hit,
            prefix_query_tokens=query,
            prefix_hit_rate=hit / max(1, query),
            preemptions=[sh.engine.scheduler.preemption_count
                         for sh in self.shards],
            defers=[sh.engine.scheduler.defer_count for sh in self.shards],
            routing_costs=list(self.router.costs),
            handoffs=len(self.handoffs),
            handoff_pages=sum(h["pages"] for h in self.handoffs),
            role_failovers=self.role_failovers,
        )
