"""Token-budget continuous-batching scheduler (vLLM-style, Kwon et al.
2023) on top of the Jenga manager.

``schedule()`` packs ONE mixed plan per engine step: every decode-phase
request contributes one token and as many concurrent prefill chunks as fit
the remaining per-step token budget (``max_num_batched_tokens``) ride along
in the same plan. The engine executes the whole plan as a single device
dispatch, which is how the batch capacity the Jenga allocator frees is
converted into tokens/step (paper §7, Fig. 13-15).

Allocation for the plan is batch-transactional: the manager's
``allocate_for_batch`` commits page capacity for every scheduled request or
rolls the step back as one unit (the §5.4 property lifted to the plan
level). On failure the scheduler preempts the latest-arrival running
request (vLLM recompute preemption) — preferring victims outside the plan,
then shrinking the plan itself — and retries.

ASYNC SCHEDULING (``Engine`` pipelining): ``schedule(inflight=...)``
plans the NEXT step while up to ``pipeline_depth - 1`` earlier steps are
still executing on the device. ``inflight`` maps request id ->
``(tokens, samples)`` the in-flight ring is computing (a bare int is
accepted as ``(tokens, tokens-will-sample)`` for direct callers); packing
uses the EFFECTIVE position ``num_computed + inflight_tokens``
(vLLM async-scheduling style):

  * an in-flight prefill chunk continues from its effective end;
  * a request whose prompt completes in flight is speculatively scheduled
    as a decode of the token the in-flight step is about to sample — its
    token id is patched into the prepared batch when the logits land, and
    its +1 page commitment is rolled back (``mgr.rollback_tokens``) if the
    sample turns out to be EOS;
  * a request whose in-flight SAMPLES deterministically exhaust
    ``max_new_tokens`` is not schedulable — it WILL finish (with several
    steps queued, each in-flight decode row past the prompt counts as one
    sample).

Preempting a request with tokens in flight releases its pages WITHOUT
caching (``preempt_request(cache=False)``): the device is still mutating
its live recurrent state past the position the boundary hash describes,
so caching would poison later prefix hits.

``serial=True`` reproduces the legacy one-prefill-chunk-per-step schedule
(no token budget, decodes unbudgeted); the engine then issues prefill and
decode as separate dispatches. It exists for A/B step-count comparisons and
for the mixed-vs-serial determinism tests. Serial mode is never driven
with ``inflight`` (the engine falls back to the synchronous loop).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..core.manager import JengaKVCacheManager, StateCopyOp
from .request import Request, Status


@dataclasses.dataclass
class SchedulerConfig:
    """Packing knobs for one engine step.

    Interactions with ``EngineConfig``: ``serial`` mirrors
    ``batching_mode="serial"`` (legacy one-prefill-per-step schedule) and
    is incompatible with async double-buffering — the engine silently runs
    the synchronous loop for it; ``"packed"``/``"padded"`` layouts both
    support ``async_scheduling`` (the layout only changes how the runner
    flattens the plan, not how it is scheduled)."""
    max_running: int = 16
    chunk_size: int = 64            # serial-mode prefill chunk size
    max_num_batched_tokens: int = 256   # per-step mixed-batch token budget
    # Latency-aware packing: cap on PREFILL tokens per step (None = the
    # whole budget). Depth-first packing optimizes throughput, but a huge
    # prompt would otherwise monopolize the step budget for many steps in a
    # row and starve decode latency; the cap reserves the remainder of the
    # budget for decodes every step.
    max_prefill_tokens_per_step: Optional[int] = None
    max_preemptions: int = 100
    serial: bool = False            # legacy one-prefill-per-step schedule
    # Disaggregated serving: a prefill-only shard never schedules decode
    # rows. A request whose prompt completes (its first token sampled by
    # the prefill chunk's own dispatch) simply goes quiet and waits for the
    # DPEngine handoff to move it to a decode shard.
    prefill_only: bool = False


@dataclasses.dataclass
class ScheduledSeq:
    """One request's share of a step: compute ``num_tokens`` tokens starting
    at position ``start`` (1 for decodes, a chunk for prefills).
    ``is_prefill`` is snapshotted at schedule time (advancing the sequence
    flips ``req.in_prefill`` before step metrics are read). ``start``
    equals ``seq.num_computed`` for synchronous plans and runs ahead of it
    by the in-flight token count under async scheduling."""
    req: Request
    num_tokens: int
    is_prefill: bool = False
    start: int = -1


@dataclasses.dataclass
class StepPlan:
    """Flattened mixed batch for one engine step: decodes first, then
    prefill chunks, all dispatched together (or in two groups under the
    serial compat schedule).

    ``total_tokens`` / ``prefill_tokens`` are computed ONCE at construction
    (the plan is immutable after ``schedule()`` returns) — consumers in the
    engine/runner read the cached fields instead of re-walking the
    scheduled list on every access."""
    scheduled: List[ScheduledSeq]
    copy_ops: List[StepCopy] = dataclasses.field(default_factory=list)
    total_tokens: int = dataclasses.field(init=False, default=0)
    prefill_tokens: int = dataclasses.field(init=False, default=0)

    def __post_init__(self):
        self.total_tokens = sum(s.num_tokens for s in self.scheduled)
        self.prefill_tokens = sum(s.num_tokens for s in self.scheduled
                                  if s.is_prefill)

    @property
    def decodes(self) -> List[Request]:
        return [s.req for s in self.scheduled if not s.is_prefill]

    @property
    def prefills(self) -> List[ScheduledSeq]:
        return [s for s in self.scheduled if s.is_prefill]


StepCopy = StateCopyOp


class Scheduler:
    def __init__(self, manager: JengaKVCacheManager, cfg: SchedulerConfig):
        self.mgr = manager
        self.cfg = cfg
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.preemption_count = 0
        # backpressure signal: prefill chunks dropped from a plan because
        # the batch allocation would not commit (defer-then-preempt's first,
        # cheaper resort). Together with ``preemption_count`` this is what a
        # data-parallel router reads to cost a thrashing shard (a shard
        # repeatedly deferring/preempting is out of memory headroom — more
        # traffic makes it worse, not faster).
        self.defer_count = 0
        self._inflight_rids: frozenset = frozenset()

    def add(self, req: Request) -> None:
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # --------------------------------------------------------- load signals
    def outstanding_tokens(self) -> int:
        """Tokens of admitted-or-queued work still to compute: remaining
        prompt plus remaining decode budget over every waiting and running
        request. This is the router's least-loaded placement key — unlike
        queue DEPTH it weighs a queue of huge prompts correctly against a
        queue of one-token decodes."""
        total = 0
        for req in list(self.waiting) + self.running:
            done = req.seq.num_computed if req.seq is not None else 0
            total += max(0, len(req.prompt) - done)
            total += max(0, req.sampling.max_new_tokens - req.num_generated)
        return total

    def queue_depth(self) -> int:
        """Requests admitted to nothing yet (waiting only)."""
        return len(self.waiting)

    def set_budgets(self, max_num_batched_tokens: int,
                    max_prefill_tokens_per_step: Optional[int]) -> None:
        """Retarget the step packing budgets between steps (autotuning —
        see serving.autotune). ``schedule()`` reads the config fresh each
        call, so the next plan picks the new budgets up immediately."""
        self.cfg.max_num_batched_tokens = max_num_batched_tokens
        self.cfg.max_prefill_tokens_per_step = max_prefill_tokens_per_step

    # ------------------------------------------------------------ schedule
    def schedule(self, inflight: Optional[Dict[str, object]] = None
                 ) -> StepPlan:
        # normalize values to (tokens_in_flight, samples_in_flight)
        inflight = {rid: v if isinstance(v, tuple) else (v, 1)
                    for rid, v in (inflight or {}).items()}
        self._inflight_rids = frozenset(inflight)

        # 1) admit new requests while capacity allows; begin_request acquires
        #    prefix-cache hits and may emit state-restore copy ops.
        admit_ops: List[Tuple[Request, StateCopyOp]] = []
        while self.waiting and len(self.running) < self.cfg.max_running:
            req = self.waiting[0]
            if req.seq is None or req.seq.num_computed == 0:
                seq = req.make_seq() if req.seq is None else req.seq
                ok, ops = self.mgr.begin_request(seq)
                if not ok:
                    break
                admit_ops.extend((req, op) for op in ops)
            self.waiting.popleft()
            req.status = Status.RUNNING
            self.running.append(req)

        def c_eff(req: Request) -> int:
            """Effective computed position: what the request will have once
            the in-flight step lands."""
            return req.seq.num_computed + inflight.get(req.rid, (0, 0))[0]

        def will_finish(req: Request) -> bool:
            """The in-flight ring deterministically samples this request's
            last allowed token (max_new_tokens) — it cannot take more work.
            EOS finishes are NOT predictable; those are speculatively
            scheduled and reconciled by the engine (segment kill + page
            rollback)."""
            samples = inflight.get(req.rid, (0, 0))[1]
            return (req.rid in inflight and c_eff(req) >= len(req.prompt)
                    and req.num_generated + samples
                    >= req.sampling.max_new_tokens)

        schedulable = [r for r in self.running if not will_finish(r)]
        if self.cfg.prefill_only:
            # prefill shard: requests past their prompt await handoff
            schedulable = [r for r in schedulable
                           if c_eff(r) < len(r.prompt)]

        # 2) pack candidates under the token budget: decodes first (they are
        #    latency-critical and cheap), then prefill chunks FIFO.
        budget = self.cfg.max_num_batched_tokens
        cands: List[ScheduledSeq] = []
        for req in schedulable:
            if c_eff(req) < len(req.prompt):
                continue                # still prefilling (effectively)
            if not self.cfg.serial and budget <= 0:
                break               # budget exhausted; rest run next step
            cands.append(ScheduledSeq(req, 1, is_prefill=False,
                                      start=c_eff(req)))
            budget -= 1
        # Prefill packing is DEPTH-first: the oldest prefill takes as much
        # of the remaining budget as its prompt needs, then the next, ...
        # (one request reaches decode quickly and frees its slack instead
        # of every request holding a memory-hungry partial prefill). The
        # per-request ``chunk_size`` cap only applies to the serial compat
        # schedule; in mixed mode the budget IS the chunking control —
        # bounded by ``max_prefill_tokens_per_step`` so a huge prompt
        # cannot monopolize every step's budget and starve decode latency.
        n_prefills = 0
        p_budget = budget
        if self.cfg.max_prefill_tokens_per_step is not None:
            p_budget = min(p_budget, self.cfg.max_prefill_tokens_per_step)
        for req in schedulable:
            ce = c_eff(req)
            if ce >= len(req.prompt):
                continue
            if self.cfg.serial and n_prefills >= 1:
                break
            cap = self.cfg.chunk_size if self.cfg.serial else p_budget
            chunk = min(cap, len(req.prompt) - ce)
            if chunk <= 0:
                break               # out of budget; later prefills wait
            cands.append(ScheduledSeq(req, chunk, is_prefill=True, start=ce))
            budget -= chunk
            p_budget -= chunk
            n_prefills += 1

        # 3) batch-transactional allocation: retry until the WHOLE plan
        #    commits as one unit. On failure, first DEFER prefill chunks
        #    (drop from this step's plan, keep their pages — no progress is
        #    lost), then fall back to recompute preemption of the
        #    latest-arrival running request so the oldest request always
        #    makes progress (no livelock under memory pressure).
        while cands:
            seqs = [c.req.seq for c in cands]
            targets = [c.start + c.num_tokens for c in cands]
            if self.mgr.allocate_for_batch(seqs, targets):
                break
            prefills = [c for c in cands if c.is_prefill]
            if prefills:
                cands.remove(self._latest(prefills, key=lambda c: c.req))
                self.defer_count += 1
                continue
            keep = min(cands, key=lambda c: c.req.arrival).req
            victims = [r for r in self.running if r is not keep]
            if not victims:
                self._preempt(keep)     # a single request cannot fit at all
                cands = []
                break
            self._preempt(self._latest(victims))
            cands = [c for c in cands if c.req.status == Status.RUNNING]

        # 4) progress guarantee: if every candidate was deferred (all
        #    running requests hold pages but none can grow), the oldest
        #    SCHEDULABLE request gets its tokens by recompute-preempting
        #    latest-arrival victims — otherwise mid-prefill requests
        #    deadlock the pool. (Requests that merely await their in-flight
        #    completion are not starved — they need no allocation.)
        schedulable = [r for r in schedulable if r.status == Status.RUNNING]
        if not cands and schedulable:
            head = min(schedulable, key=lambda r: r.arrival)
            ce = c_eff(head)
            cap = (self.cfg.chunk_size if self.cfg.serial
                   else self.cfg.max_num_batched_tokens)
            if not self.cfg.serial and \
                    self.cfg.max_prefill_tokens_per_step is not None:
                cap = min(cap, self.cfg.max_prefill_tokens_per_step)
            nt = (min(cap, len(head.prompt) - ce)
                  if ce < len(head.prompt) else 1)
            while not self.mgr.allocate_for_tokens(head.seq, ce + nt):
                victims = [r for r in self.running if r is not head]
                if not victims:
                    self._preempt(head)   # a lone request that cannot fit
                    break
                self._preempt(self._latest(victims))
            else:
                cands = [ScheduledSeq(head, nt,
                                      is_prefill=ce < len(head.prompt),
                                      start=ce)]

        # restore ops of admissions that got preempted again in step 3 must
        # not run (their destination pages are already freed)
        copy_ops = [op for req, op in admit_ops
                    if req.status == Status.RUNNING]
        return StepPlan(scheduled=cands, copy_ops=copy_ops)

    # ------------------------------------------------------------ preempt
    def _latest(self, items, key=lambda x: x):
        """Latest-ARRIVAL element; ties break toward the latest-ADMITTED
        (highest index in ``running``). Bare ``max`` would return the first
        maximal element — the oldest, most-progressed request — inverting
        the recompute-preemption policy whenever arrivals tie (every batch
        submitted before stepping shares one arrival stamp)."""
        # keyed by rid (unique per request), not id(): object identity is
        # allocation-order dependent and would break bit-for-bit replay
        order = {r.rid: i for i, r in enumerate(self.running)}
        return max(items, key=lambda it: (key(it).arrival,
                                          order.get(key(it).rid, -1)))

    def _preempt(self, req: Request) -> None:
        # an in-flight victim's device state runs ahead of its hash chains —
        # releasing its pages to the prefix cache would poison later hits
        self.mgr.preempt_request(req.seq,
                                 cache=req.rid not in self._inflight_rids)
        req.preemptions += 1
        self.preemption_count += 1
        req.status = Status.WAITING
        self.running.remove(req)
        self.waiting.appendleft(req)

    # ------------------------------------------------------------- finish
    def finish(self, req: Request, cache: bool = True,
               cache_state: bool = True) -> None:
        self.mgr.free_request(req.seq, cache=cache, cache_state=cache_state)
        req.status = Status.FINISHED
        if req in self.running:
            self.running.remove(req)
