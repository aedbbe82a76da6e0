"""Inference engine: token-budget continuous batching over the Jenga
manager (a copy of ``repro/serving/engine.py`` driving the torch
``ModelRunner`` on a torch device).

The port's engine serves the three batching modes ("packed", "padded",
"serial") with greedy and seeded temperature/top-k sampling, and seeds
its budgets from the H100's roofline under ``autotune_budgets``. Packed
self-attention always runs through the varlen flash kernel (the
reference's ``attention_impl="kernel"`` route), so the port has no
``attention_impl`` option; padded T == 1 dispatches (every decode group
of "serial") read their pages in place through the paged decode kernel.

Each ``step()`` is build-batch -> ONE ``serve_step`` dispatch -> advance /
sample / retire:

  1. ``Scheduler.schedule()`` packs a per-step token budget across ALL
     running requests — any number of concurrent prefill chunks plus every
     decode — and commits the step's page allocation transactionally;
  2. the step's state-restore copies run as one batched dispatch;
  3. ``ModelRunner.prepare``/``dispatch`` executes the whole mixed plan in
     a single ``serve_step`` — token-packed into one (total_tokens,)
     stream with per-token segment ids by default ("packed"), or as
     (B, T)-padded rows under the PR-1 layout ("padded");
  4. every scheduled request advances; the engine samples PER SEGMENT
     (logits come back one row per scheduled item, in plan order);
     checkpoint copies emitted by ``advance`` run as one batched dispatch
     at the end of the step.

ASYNC SCHEDULING (``EngineConfig.async_scheduling``, pipelined): while
step N's dispatch is in flight on the device, the host plans step N+1 and
builds its packed batch — sampling and advancing step N happen one step
later, when its results are fetched. Decode rows in plan N+1 are
scheduled SPECULATIVELY (each running decode assumed to produce +1 token,
vLLM async-scheduling style) with their pages pre-committed through the
manager's transactional ``allocate_for_batch``; when a completed step
reveals a request actually finished (EOS / token budget), its segments in
EVERY still-queued plan are neutralized to pad semantics and its
speculative page commitments rolled back in one trailing pop
(``mgr.rollback_tokens``). Greedy outputs are bit-identical to the
synchronous loop: segments are isolated by the packed segment mask, so a
dead slot changes nothing for its neighbours, and recompute preemption is
semantically transparent. ``async_scheduling`` composes with
``batching_mode`` "packed" and "padded"; "serial" (two dispatch groups per
step) falls back to the synchronous loop.

PIPELINE DEPTH (``EngineConfig.pipeline_depth``): the in-flight slot is a
ring of up to ``pipeline_depth - 1`` dispatched steps. Depth 2 (default)
is the PR-3 double buffer. Deeper rings require DEVICE SAMPLING
(``EngineConfig.device_sampling``; forced on beyond depth 2): the fused
sampling tail in ``ModelRunner.dispatch`` picks each segment's token on
device (shared ``greedy_token`` tie-band semantics, bit-identical to the
host path, plus seeded temperature/top-k — see ``serving.sampler``) and
scatters it into a device-resident token board that later dispatches read
back (``inject_tokens``), so the host plans step N+k from effective
positions without ever seeing a logit: completion blocks on a
``(segments,)`` int32 vector — 4 bytes per segment instead of
``vocab * 4`` — and logits rows are only fetched under
``record_sample_logits``.

``batching_mode="serial"`` reproduces the legacy one-prefill-chunk-per-step
engine (prefill and decode as separate dispatches) for step-count A/Bs and
determinism tests.

Collects the per-step metrics the paper's figures are built from (decode
batch size Fig.15, memory breakdown Fig.16, hit rates Fig.17, encoder runs
Fig.18) plus the mixed-batch packing stats (tokens/step, prefills/step),
dispatch-waste counters (tokens vs slots paid), and the host-build /
device-wait timings the async overlap is measured by."""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.manager import JengaKVCacheManager, StateCopyOp
from .request import Request, SamplingParams, Status
from .runner import ModelRunner, refuse_mesh
from .sampler import TIE_EPS, greedy_token, host_sample, rid_hash
from .scheduler import ScheduledSeq, Scheduler, SchedulerConfig, StepPlan


# Greedy-sampling tie band (re-exported from serving.sampler, the single
# source of truth for token selection): candidates within TIE_EPS of the
# max logit count as tied and the LOWEST token id wins, a deterministic
# rule on the fp32 logits (raw argmax breaks ties by array order, which
# bf16 noise reorders). What this CAN and CANNOT buy: the unembed emits
# fp32 logits, but the bf16 hidden state feeding it differs across
# layouts/impls (packed vs padded vs serial streams, ref vs kernel
# attention, MoE expert tiling, mamba2 packed vs chunked scans) by
# reduction order — per-candidate gaps to the max move by ~1e-4 on dense
# archetypes up to ~4e-3 on MoE decode chains. The band absorbs near-ties
# well inside it, but NO constant is layout-independent in general: a
# candidate whose gap lands within noise of the band edge itself still
# flips (measured: 1e-3 flipped a dbrx 0.9e-3 near-tie, 3e-2 flipped on
# danube's #3 candidate at gap ~3e-2), and the flip points move with the
# band because earlier picks change the trajectory. Cross-layout greedy
# comparisons therefore use the fork-aware checker in tests/conftest.py:
# exact token equality until a divergence, which must itself be a
# genuinely ambiguous decision (both candidates within TIE_FORK_TOL of
# the max in BOTH modes' recorded fp32 rows — see
# EngineConfig.record_sample_logits) — a real bug (leak, wrong mask)
# diverges with a large gap and still fails loudly. The device sampler
# implements the same rule as a boolean argmax over the band
# (see serving.sampler._band_pick) and is bit-identical to the host form.
TIE_EPS = TIE_EPS                  # re-exported; canonical home: sampler.py
greedy_token = greedy_token


def stub_modality_embed(mm_hash: int, offset: int, dim: int) -> np.ndarray:
    """Deterministic stand-in for the vision/audio frontend (assignment:
    frontends are stubs; embeddings are 'precomputed')."""
    rng = np.random.default_rng((mm_hash & 0xFFFFFFFF, offset))
    return (0.05 * rng.standard_normal(dim)).astype(np.float32)


@dataclasses.dataclass
class EngineConfig:
    kv_pool_bytes: int = 64 << 20
    max_running: int = 16
    chunk_size: int = 64               # per-request prefill chunk cap
    max_num_batched_tokens: int = 256  # per-step mixed-batch token budget
    max_prefill_tokens_per_step: Optional[int] = None  # long-prefill cap
    # "packed"  — one (total_tokens,) token stream with per-token segment
    #             ids (vLLM-style varlen dispatch; per-step FLOPs follow
    #             the token budget);
    # "padded"  — the PR-1 mixed layout, one (B, T)-padded row/sequence
    #             ("mixed" is accepted as a legacy alias);
    # "serial"  — legacy one-prefill-chunk-per-step, two dispatch groups.
    batching_mode: str = "packed"
    # Double-buffered step: plan + host-build step N+1 while step N's
    # dispatch is in flight; sample/advance one step delayed. Greedy
    # outputs are bit-identical to the synchronous loop. Composes with
    # "packed"/"padded"; "serial" falls back to the synchronous loop
    # (its two dispatch groups per step defeat single-slot buffering).
    async_scheduling: bool = False
    # In-flight pipeline depth: up to (pipeline_depth - 1) dispatched
    # steps stay queued on device. None resolves from $REPRO_PIPELINE_DEPTH
    # (default 2 — the PR-3 double buffer); 1 forces the synchronous loop.
    # Depths > 2 require device_sampling (the host never sees step N's
    # tokens before planning N+2).
    pipeline_depth: Optional[int] = None
    # Sample tokens ON DEVICE in the dispatch (fused greedy/temperature
    # tail + token board, see serving.sampler); completion then fetches 4
    # bytes per segment instead of the vocab*4 logits row. None: enabled
    # exactly when pipeline_depth > 2. Only meaningful with
    # async_scheduling; greedy results are bit-identical either way.
    device_sampling: Optional[bool] = None
    enable_prefix_caching: bool = True
    memory_mode: str = "jenga"       # "jenga" | "paged-baseline"
    geometry_mode: str = "lcm"        # "lcm" | "max"
    # Seed max_num_batched_tokens / max_prefill_tokens_per_step from the
    # roofline model and refine them online from StepMetrics (see
    # serving.autotune) instead of using the constants above.
    autotune_budgets: bool = False
    # Record each greedy sample's fp32 logits row (vocab-sliced) in
    # Engine.sample_log[rid], aligned with Request.output. Test-only
    # support for the fork-aware cross-layout greedy comparison (see the
    # TIE_EPS note); off by default — rows are vocab_size floats per token.
    record_sample_logits: bool = False
    # Disaggregation role (serving.dp_engine): "both" serves prefill and
    # decode (colocated, the default); "prefill" only runs prompt chunks —
    # a prompt-complete request goes quiet and awaits the DPEngine handoff;
    # "decode" only receives handed-off requests (the router never places
    # fresh arrivals here).
    role: str = "both"
    seed: int = 0


@dataclasses.dataclass
class StepMetrics:
    step: int
    decode_batch: int          # decode sequences in this step's plan
    prefill_tokens: int        # prefill tokens across ALL chunks this step
    used_units: int
    evictable_units: int
    empty_units: int
    free_units: int
    waste_units: int = 0
    num_prefills: int = 0      # concurrent prefill chunks this step
    batched_tokens: int = 0    # total tokens in the mixed batch
    dispatched_slots: int = 0  # stream/row slots the dispatch actually paid
    pad_slots: int = 0         # slots paid beyond real tokens (waste)
    host_build_ms: float = 0.0  # host-side schedule + batch-build time
    # Device-wait time: sync = dispatch+fetch of THIS step's logits; async
    # = time blocked fetching the PREVIOUS step's results after this step's
    # host build already ran (the overlap win is host_build_ms no longer
    # serializing with it).
    dispatch_ms: float = 0.0
    # Pipeline timing split (async; host-observed estimates). issue: time
    # spent in runner.dispatch() handing work to the device. For each step
    # COMPLETED during this call: queue = time it sat behind the previous
    # step's completion, compute = completion minus max(issue, previous
    # completion). dispatch_ms above stays the blocked-fetch wait.
    dispatch_issue_ms: float = 0.0
    dispatch_queue_ms: float = 0.0
    dispatch_compute_ms: float = 0.0
    # Host-side sampling time (greedy argmax / seeded draw in _sample);
    # 0 under device sampling — that is the point.
    host_sample_ms: float = 0.0
    # Device->host bytes fetched this step (logits rows and/or sampled
    # token vectors): vocab*4 per segment host-sampled vs 4 per segment
    # device-sampled.
    sampled_bytes_fetched: int = 0
    # Attention-work counters (packed layout): (q block, KV block) tiles
    # of the old-page self-attention streams this step scanned vs skipped
    # by the segment-block-sparse schedule, and the modeled FLOPs / HBM
    # bytes of the scanned tiles (host cost model — see
    # ModelRunner._attn_block_stats).
    kv_blocks_scanned: int = 0
    kv_blocks_skipped: int = 0
    attn_flops_modeled: float = 0.0
    attn_bytes_modeled: float = 0.0


@dataclasses.dataclass
class ShardHealth:
    """One engine's health/backpressure snapshot, read by the data-parallel
    router (serving.router) every fleet tick. ``defer_count`` and
    ``preemption_count`` are CUMULATIVE — the router costs shards on their
    deltas; ``outstanding_tokens`` is the least-loaded placement key."""
    step: int                   # engine step count (progress indicator)
    finished: int               # requests retired so far
    waiting: int                # queued, unadmitted requests
    running: int                # admitted requests
    outstanding_tokens: int     # remaining prompt + decode tokens
    inflight_steps: int         # dispatched-but-uncompleted ring depth
    defer_count: int            # scheduler defer events (cumulative)
    preemption_count: int       # recompute preemptions (cumulative)
    used_units: int             # referenced pool units
    free_units: int             # unowned pool units
    role: str = "both"          # disaggregation role (prefill/decode/both)


@dataclasses.dataclass
class _InflightStep:
    """A dispatched-but-not-completed step (one ring slot of the async
    pipeline). The PreparedStep itself is NOT retained — after dispatch
    only the plan and per-segment liveness matter."""
    plan: StepPlan
    handle: object             # runner.StepHandle (device tensors)
    epochs: List[int]          # per-segment seq.epoch at dispatch time
    live: List[bool]           # False: segment killed at reconciliation
    step: int                  # engine step index this dispatch was logged as
    dispatched_at: float = 0.0  # perf_counter at issue (timing split)


class Engine:
    def __init__(self, model, cfg: EngineConfig,
                 params=None, seed: int = 0, device="cuda"):
        refuse_mesh(model)      # one device's buffer, as the reference's
        self.model = model
        if cfg.batching_mode == "mixed":        # legacy alias for PR-1 mode
            cfg = dataclasses.replace(cfg, batching_mode="padded")
        self.cfg = cfg
        assert cfg.batching_mode in ("packed", "padded", "serial"), \
            cfg.batching_mode
        # serial mode issues two dispatch groups per step — double buffering
        # would interleave their completions; fall back to the sync loop.
        # pipeline_depth 1 means "nothing in flight": also the sync loop.
        depth = cfg.pipeline_depth
        if depth is None:
            depth = int(os.environ.get("REPRO_PIPELINE_DEPTH", "2") or 2)
        depth = max(1, int(depth))
        self.async_scheduling = bool(cfg.async_scheduling) and \
            cfg.batching_mode != "serial" and depth > 1
        self.pipeline_depth = depth if self.async_scheduling else 1
        dev = cfg.device_sampling
        if dev is None:
            dev = self.pipeline_depth > 2
        self.device_sampling = bool(dev) and self.async_scheduling
        assert self.pipeline_depth <= 2 or self.device_sampling, (
            "pipeline_depth > 2 requires device_sampling: with host "
            "sampling every queued step's decode tokens would need a host "
            "patch, capping the ring at one slot")
        baseline = cfg.memory_mode == "paged-baseline"
        self.mgr = JengaKVCacheManager(
            model.kv_specs(),
            total_memory_bytes=cfg.kv_pool_bytes,
            mode=cfg.geometry_mode,
            enable_prefix_caching=cfg.enable_prefix_caching,
            enable_inflight_retirement=not baseline,
            seed=cfg.seed,
        )
        if baseline:
            self._apply_baseline_semantics()
        assert cfg.role in ("both", "prefill", "decode"), cfg.role
        self.role = cfg.role
        self.scheduler = Scheduler(
            self.mgr, SchedulerConfig(
                max_running=cfg.max_running,
                chunk_size=cfg.chunk_size,
                max_num_batched_tokens=cfg.max_num_batched_tokens,
                max_prefill_tokens_per_step=cfg.max_prefill_tokens_per_step,
                serial=cfg.batching_mode == "serial",
                prefill_only=cfg.role == "prefill"))
        self.autotuner = None
        if cfg.autotune_budgets:
            from .autotune import BudgetAutotuner
            self.autotuner = BudgetAutotuner(model.cfg)
            self.scheduler.set_budgets(self.autotuner.budget,
                                       self.autotuner.prefill_cap)
        self.runner = ModelRunner(model, self.mgr,
                                  stub_embed_fn=stub_modality_embed,
                                  device=device)
        self.params = params if params is not None else \
            model.init(seed, self.runner.device)
        self.step_count = 0
        self.metrics: List[StepMetrics] = []
        self.sample_log: Dict[str, List[np.ndarray]] = {}
        self.encoder_runs = 0
        self.mm_seen: set = set()
        self.finished: List[Request] = []
        # ring of dispatched-but-not-completed steps, oldest first. With
        # host sampling the capacity is pinned to 1 (every queued plan's
        # decode tokens need the previous step's host sample); device
        # sampling raises it to pipeline_depth - 1.
        self._inflight: Deque[_InflightStep] = deque()
        self._ring_capacity = (self.pipeline_depth - 1) \
            if self.device_sampling else 1
        # async-scheduling reconciliation counters: segments killed because
        # their request finished while speculatively planned, and pages
        # rolled back from those speculative commitments
        self.spec_kills = 0
        self.spec_rollback_pages = 0
        # runner attention-work totals already folded into StepMetrics
        # (the runner accumulates across dispatches; steps record deltas)
        self._attn_seen = (0, 0, 0.0, 0.0)
        self._bytes_seen = 0
        self._sample_ms = 0.0           # host sampling time this step
        self._last_complete_t = 0.0     # timing split (queue vs compute)

    # ------------------------------------------------- baseline semantics
    def _apply_baseline_semantics(self):
        """PagedAttention-style baseline (paper §3.2): all layer types are
        treated as full-prefix self-attention — mm/cross caches allocate
        pages for EVERY token, sliding windows never retire, eviction is a
        single uncustomized LRU."""
        from ..core.policies import FullAttentionPolicy
        mgr = self.mgr
        for name, spec in ((s.name, s) for s in mgr.specs):
            if spec.kind in ("swa", "vision_embed", "cross_attn"):
                pol = FullAttentionPolicy(spec)
                mgr.policies[name] = pol
        orig = mgr._mm_storage_upto

        def all_tokens(req, spec, main_pos):
            if spec.kind in ("vision_embed", "cross_attn") and not \
                    req.encoder_items:
                return main_pos            # every token, image or not
            return orig(req, spec, main_pos)

        mgr._mm_storage_upto = all_tokens

    # -------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        req.arrival = self.step_count
        # a failed-over request may have logged sample rows on another
        # shard's engine — or on THIS engine before a drain; recorded rows
        # must stay aligned with the output the rerun produces
        self.sample_log.pop(req.rid, None)
        self.scheduler.add(req)

    # ---------------------------------------------------------------- step
    def step(self) -> Optional[StepMetrics]:
        if self.async_scheduling:
            return self._step_async()
        if not self.scheduler.has_work():
            return None
        t0 = time.perf_counter()
        plan = self.scheduler.schedule()
        # state restores of this step's admissions: one batched dispatch
        self.runner.apply_copies(plan.copy_ops)
        # scheduling counts as host build time (async hides it too)
        build_ms = (time.perf_counter() - t0) * 1e3
        disp_ms = 0.0

        slots_before = self.runner.slots_dispatched
        if plan.scheduled:
            self._count_encoder_runs(plan.scheduled)
            if self.cfg.batching_mode == "serial":
                # legacy two-dispatch step: prefill chunk, then decode batch
                groups = [g for g in (plan.prefills,
                                      [s for s in plan.scheduled
                                       if not s.is_prefill]) if g]
            else:
                groups = [plan.scheduled]
            packed = self.cfg.batching_mode == "packed"
            post_ops: List[StateCopyOp] = []
            for group in groups:
                tb = time.perf_counter()
                prep = self.runner.prepare(
                    [(s.req, s.num_tokens, s.start) for s in group],
                    packed=packed)
                td = time.perf_counter()
                build_ms += (td - tb) * 1e3
                for s in group:     # device work now exists for these
                    s.req.started = True
                logits = self.runner.fetch(
                    self.runner.dispatch(self.params, prep), len(group))
                disp_ms += (time.perf_counter() - td) * 1e3
                # sampling/advance below is neither build nor dispatch wait
                for i, s in enumerate(group):
                    post_ops.extend(self._advance(s, logits[i]))
            # checkpoint copies emitted while advancing: one batched dispatch
            self.runner.apply_copies(post_ops)

        return self._record_metrics(plan, slots_before, build_ms, disp_ms)

    # ---------------------------------------------------------- async step
    def _step_async(self) -> Optional[StepMetrics]:
        """One pipelined step: plan + host-build the next step (the part
        the in-flight dispatches hide), THEN complete the oldest in-flight
        step(s) until a ring slot is free, reconcile the new plan AND every
        still-queued plan against what actually happened (kill segments of
        requests that finished, roll back their speculative pages, patch
        or board-feed the decode token ids), and dispatch the new step
        without waiting for it."""
        if not self.scheduler.has_work() and not self._inflight:
            return None

        # --- phase 1: plan the next step while the ring executes on device.
        # Effective positions count every VALID queued row (stale-epoch
        # rows — preempted or restarted while queued — are dead weight the
        # completion will skip, so they must not advance c_eff); samples
        # in flight are counted so will_finish fires at the same position
        # the sync loop would stop scheduling at.
        t0 = time.perf_counter()
        inflight_info: Dict[str, Tuple[int, int]] = {}
        for qinf in self._inflight:
            for i, s in enumerate(qinf.plan.scheduled):
                req, seq = s.req, s.req.seq
                if not qinf.live[i] or req.status != Status.RUNNING \
                        or seq.epoch != qinf.epochs[i]:
                    continue
                t, sm = inflight_info.get(req.rid, (0, 0))
                samples = 1 if s.start + s.num_tokens >= len(req.prompt) \
                    else 0
                inflight_info[req.rid] = (t + s.num_tokens, sm + samples)
        san = self.mgr.sanitizer
        if san is not None:
            san.set_inflight(inflight_info)
        plan = self.scheduler.schedule(inflight=inflight_info)
        self.runner.apply_copies(plan.copy_ops)
        prepared = None
        if plan.scheduled:
            self._count_encoder_runs(plan.scheduled)
            prepared = self.runner.prepare(
                [(s.req, s.num_tokens, s.start) for s in plan.scheduled],
                packed=self.cfg.batching_mode == "packed",
                sample=self.device_sampling,
                board_feed=self.device_sampling)
        build_ms = (time.perf_counter() - t0) * 1e3

        # --- phase 2: complete the oldest step(s). Completing down to
        # (capacity - 1) before a new dispatch keeps at most
        # ``pipeline_depth - 1`` steps queued; a planless call (drain, or
        # nothing schedulable under pressure) completes the WHOLE ring —
        # the host has nothing to overlap anyway, and every completed
        # result (finishes, freed pages) can only improve the next
        # schedule. This also keeps step counts depth-independent: deeper
        # rings don't pay extra one-completion-per-call shutdown steps.
        done: List[Request] = []
        wait_ms = queue_ms = compute_ms = 0.0
        target = self._ring_capacity - 1 if prepared is not None else 0
        while len(self._inflight) > target:
            inf = self._inflight.popleft()
            # rids that STILL have dispatched steps deeper in the ring:
            # their live state pages keep advancing on device after this
            # completion's copy ops would run, so checkpoint snapshots and
            # state caching must be suppressed for them (depth >= 3 only;
            # at depth 2 the ring is fully drained before a new dispatch)
            deeper = self._live_inflight_rids()
            if san is not None:
                san.set_inflight(deeper)
            d, w, q, c = self._complete(inf, deeper)
            done.extend(d)
            wait_ms += w
            queue_ms += q
            compute_ms += c

        # --- phase 3: reconcile the new plan AND every queued plan
        # against the completed steps' actual outcomes
        live = [True] * len(plan.scheduled)
        seg_of = {s.req.rid: i for i, s in enumerate(plan.scheduled)}
        for req in done:
            # finished while speculative decodes were already planned (in
            # the new plan and/or deeper ring slots): neutralize every such
            # segment, then pop ALL pages committed for never-computed
            # tokens in one trailing rollback.
            killed = False
            dispatched_kill = False
            si = seg_of.get(req.rid)
            if si is not None:
                prepared.kill_segment(si)
                live[si] = False
                self.spec_kills += 1
                killed = True
            for qinf in self._inflight:
                for i, s in enumerate(qinf.plan.scheduled):
                    if s.req.rid == req.rid and qinf.live[i]:
                        qinf.live[i] = False
                        self.spec_kills += 1
                        killed = True
                        # already ON the device: it keeps mutating the
                        # live state page after this finish
                        dispatched_kill = True
            if killed:
                self.spec_rollback_pages += self.mgr.rollback_tokens(
                    req.seq, req.seq.num_computed)
            # Killed-but-dispatched deeper steps advance the live state
            # page past the boundary hash — caching it would poison later
            # prefix hits. Token KV pages stay cacheable: killed tokens
            # only ever touched the popped/partial tail pages.
            self._finish(req, cache_state=not dispatched_kill)
        if prepared is not None:
            # host sampling: decode tokens sampled at completion above are
            # known now — patch them in. (Device sampling board-fed them
            # at prepare; pending is already empty.)
            for si in list(prepared.pending):
                s = plan.scheduled[si]
                prepared.patch_token(si, s.req.seq.tokens[s.start])

        # --- phase 4: dispatch the new step (async; completes in a later
        # call, once it reaches the head of the ring)
        slots_before = self.runner.slots_dispatched
        tokens_before = self.runner.tokens_dispatched
        issue_ms = 0.0
        if prepared is not None and any(live):
            epochs = [s.req.seq.epoch for s in plan.scheduled]
            for s in plan.scheduled:    # device work now exists for these
                s.req.started = True
            ti = time.perf_counter()
            handle = self.runner.dispatch(self.params, prepared)
            issue_ms = (time.perf_counter() - ti) * 1e3
            self._inflight.append(_InflightStep(
                plan, handle, epochs, live, step=self.step_count,
                dispatched_at=ti))
        if san is not None:
            san.set_inflight(self._live_inflight_rids())
        return self._record_metrics(
            plan, slots_before, build_ms, wait_ms,
            tokens=self.runner.tokens_dispatched - tokens_before,
            issue_ms=issue_ms, queue_ms=queue_ms, compute_ms=compute_ms)

    def _live_inflight_rids(self) -> Set[str]:
        """Rids with live, epoch-valid segments still queued in the ring —
        i.e. dispatched device work that has not completed yet."""
        rids: Set[str] = set()
        for qinf in self._inflight:
            for i, s in enumerate(qinf.plan.scheduled):
                if qinf.live[i] and s.req.status == Status.RUNNING \
                        and s.req.seq.epoch == qinf.epochs[i]:
                    rids.add(s.req.rid)
        return rids

    def _complete(self, inf: _InflightStep,
                  deeper_rids: frozenset = frozenset()):
        """Fetch an in-flight step's results and run its delayed
        sample/advance. Device sampling blocks on the (segments,) int32
        token vector (4 bytes/segment) and only fetches logits rows under
        ``record_sample_logits``; host sampling blocks on the full logits.
        Segments whose request was preempted while in flight (stale epoch)
        or killed at reconciliation are skipped — recompute preemption
        regenerates their tokens deterministically. Returns (finished
        requests, fetch-block ms, queue ms, compute ms) — finish itself is
        deferred to the caller so it can reconcile the queued plans first,
        and only the device wait is timed (host bookkeeping after the
        fetch is not dispatch latency)."""
        t0 = time.perf_counter()
        n = len(inf.plan.scheduled)
        tokens = logits = None
        if self.device_sampling:
            tokens = self.runner.fetch_tokens(inf.handle, n)
            if self.cfg.record_sample_logits:
                logits = self.runner.fetch(inf.handle, n)
        else:
            logits = self.runner.fetch(inf.handle, n)
        now = time.perf_counter()
        wait_ms = (now - t0) * 1e3
        # host-observed pipeline split: time queued behind the previous
        # completion vs time actually computing (estimates — the device
        # executes dispatches in order, so the previous completion bounds
        # this step's start from below)
        prev = self._last_complete_t or inf.dispatched_at
        queue_ms = max(0.0, (prev - inf.dispatched_at) * 1e3)
        compute_ms = max(0.0, (now - max(inf.dispatched_at, prev)) * 1e3)
        self._last_complete_t = now
        done: List[Request] = []
        post_ops: List[StateCopyOp] = []
        for i, s in enumerate(inf.plan.scheduled):
            req, seq = s.req, s.req.seq
            if not inf.live[i] or req.status != Status.RUNNING \
                    or seq.epoch != inf.epochs[i] \
                    or seq.num_computed != s.start:
                continue
            # stamp with the COMPLETED step's index, not the current call's
            # (sync records the sampling step; async samples k calls later)
            post_ops.extend(self._advance(
                s, None if logits is None else logits[i],
                done=done, step=inf.step,
                token=None if tokens is None else int(tokens[i]),
                allow_checkpoints=req.rid not in deeper_rids))
        self.runner.apply_copies(post_ops)
        return done, wait_ms, queue_ms, compute_ms

    def _record_metrics(self, plan: StepPlan, slots_before: int,
                        build_ms: float, disp_ms: float,
                        tokens: Optional[int] = None,
                        issue_ms: float = 0.0, queue_ms: float = 0.0,
                        compute_ms: float = 0.0) -> StepMetrics:
        """``batched_tokens``/``dispatched_slots``/``pad_slots`` describe
        what was actually DISPATCHED (async: killed speculative segments'
        tokens drop out and their slots count as padding waste; a fully
        killed plan dispatches nothing); ``decode_batch``/``num_prefills``/
        ``prefill_tokens`` describe the PLAN as scheduled."""
        stats = self.mgr.memory_stats()
        slots = self.runner.slots_dispatched - slots_before
        tokens = plan.total_tokens if tokens is None else tokens
        r = self.runner
        attn_now = (r.kv_blocks_scanned, r.kv_blocks_skipped,
                    r.attn_flops_modeled, r.attn_bytes_modeled)
        attn_delta = tuple(a - b for a, b in zip(attn_now, self._attn_seen))
        self._attn_seen = attn_now
        m = StepMetrics(
            step=self.step_count,
            decode_batch=len(plan.decodes),
            prefill_tokens=plan.prefill_tokens,
            used_units=stats.used_units,
            evictable_units=stats.evictable_units,
            empty_units=stats.empty_units,
            free_units=stats.free_units,
            num_prefills=len(plan.prefills),
            batched_tokens=tokens,
            dispatched_slots=slots,
            pad_slots=max(0, slots - tokens),
            host_build_ms=build_ms,
            dispatch_ms=disp_ms,
            dispatch_issue_ms=issue_ms,
            dispatch_queue_ms=queue_ms,
            dispatch_compute_ms=compute_ms,
            host_sample_ms=self._sample_ms,
            sampled_bytes_fetched=r.bytes_fetched - self._bytes_seen,
            kv_blocks_scanned=attn_delta[0],
            kv_blocks_skipped=attn_delta[1],
            attn_flops_modeled=attn_delta[2],
            attn_bytes_modeled=attn_delta[3],
        )
        self.metrics.append(m)
        self._sample_ms = 0.0
        self._bytes_seen = r.bytes_fetched
        self.step_count += 1
        if self.autotuner is not None and self.autotuner.observe(m):
            self.scheduler.set_budgets(self.autotuner.budget,
                                       self.autotuner.prefill_cap)
        return m

    def _count_encoder_runs(self, scheduled: Sequence[ScheduledSeq]) -> None:
        if self.model.cfg.family not in ("vlm", "encdec"):
            return
        for s in scheduled:
            seq = s.req.seq
            if not s.is_prefill or s.start != 0:
                continue
            for it in (seq.mm_items or seq.encoder_items):
                if it.mm_hash not in self.mm_seen or not \
                        self.cfg.enable_prefix_caching:
                    self.encoder_runs += 1
                    self.mm_seen.add(it.mm_hash)

    def _advance(self, s: ScheduledSeq, logits: Optional[np.ndarray],
                 done: Optional[List[Request]] = None,
                 step: Optional[int] = None,
                 token: Optional[int] = None,
                 allow_checkpoints: bool = True) -> List[StateCopyOp]:
        """Post-dispatch bookkeeping for one scheduled sequence: record the
        computed tokens with the manager, sample once past the prompt, and
        return any state-checkpoint copy ops for batched execution. With
        ``done`` given (async), finish detection is deferred to the caller
        instead of retiring the request immediately; ``step`` overrides the
        step index stamped on first tokens/finishes (async completes step N
        k calls later — stamps must match the synchronous loop's). With
        ``token`` given (device sampling), the pick already happened in the
        dispatch's fused tail; ``logits`` may then be None unless rows are
        being recorded."""
        req, seq = s.req, s.req.seq
        step = self.step_count if step is None else step
        ops = self.mgr.advance(seq, s.num_tokens,
                               allow_checkpoints=allow_checkpoints)
        if s.is_prefill:    # vision free-on-consume only fires during prefill
            self.mgr.consume_mm(seq, seq.num_computed)
        self.mgr.touch(seq)
        if not req.in_prefill:          # decode, or prompt just completed
            if token is not None:
                if self.cfg.record_sample_logits:
                    v = self.model.cfg.vocab_size
                    self.sample_log.setdefault(req.rid, []).append(
                        np.asarray(logits[:v], np.float32).copy())
                tok = token
            else:
                tok = self._sample(req, logits)
            req.output.append(tok)
            seq.append_token(tok)
            if req.first_token_step is None:
                req.first_token_step = step
            if req.is_done():
                if done is None:
                    self._finish(req)
                else:
                    req.finished_step = step
                    done.append(req)
        return ops

    def _sample(self, req: Request, logits: np.ndarray) -> int:
        """Host-side token pick over one FULL-WIDTH (v_pad) logits row.
        Same semantics as the device sampler (serving.sampler is the
        single source of truth): tie-banded greedy, or the seeded
        temperature/top-k draw keyed on (seed, rid_hash, position) — the
        temperature path runs the device computation itself (host_sample)
        so host- and device-sampled outputs are identical."""
        v = self.model.cfg.vocab_size
        if self.cfg.record_sample_logits:
            self.sample_log.setdefault(req.rid, []).append(
                np.asarray(logits[:v], np.float32).copy())
        t0 = time.perf_counter()
        sp = req.sampling
        if sp.temperature <= 0:
            # greedy with a deterministic tie-break on the fp32 logits
            # (lowest token id within TIE_EPS of the max — see TIE_EPS)
            tok = greedy_token(logits[:v])
        else:
            # position of the token being sampled == len(prompt + output);
            # layout- and batch-independent, so any scheduling mode
            # reproduces the same draw. The full padded row goes in: the
            # heads emit pad columns at -1e30 and the Gumbel noise shape
            # depends on the row width.
            tok = host_sample(logits, sp.temperature, sp.top_k,
                              rid_hash(req.rid), len(req.seq.tokens),
                              sp.seed, self.runner.device)
        self._sample_ms += (time.perf_counter() - t0) * 1e3
        return tok

    def _finish(self, req: Request, cache_state: bool = True) -> None:
        if req.finished_step is None:   # async stamps at completion time
            req.finished_step = self.step_count
        self.scheduler.finish(req, cache=True, cache_state=cache_state)
        self.runner.forget(req.rid)
        self.finished.append(req)

    # ------------------------------------------------------ shard-mode hooks
    # A data-parallel fleet (serving.dp_engine) runs N engines behind a
    # router. The router needs three things from each engine: a health /
    # load snapshot to place and cost by, and two drain paths — graceful
    # (pull never-dispatched requests off a stalled shard) and crash
    # (reset EVERYTHING for failover, pages freed uncached).

    def health_snapshot(self) -> ShardHealth:
        """Cheap point-in-time health/backpressure view for the router."""
        stats = self.mgr.memory_stats()
        return ShardHealth(
            step=self.step_count,
            finished=len(self.finished),
            waiting=self.scheduler.queue_depth(),
            running=len(self.scheduler.running),
            outstanding_tokens=self.scheduler.outstanding_tokens(),
            inflight_steps=len(self._inflight),
            defer_count=self.scheduler.defer_count,
            preemption_count=self.scheduler.preemption_count,
            used_units=stats.used_units,
            free_units=stats.free_units,
            role=self.role,
        )

    def outstanding_tokens(self) -> int:
        """Router load key: tokens of work still to compute here."""
        return self.scheduler.outstanding_tokens()

    def drain_requests(self, unstarted_only: bool = True,
                       cache: bool = True) -> List[Request]:
        """Remove requests from this engine and return them reset for
        re-admission elsewhere (``Request.reset_for_routing``).

        ``unstarted_only=True`` (graceful drain of a stalled/backpressured
        shard) takes only requests that were never part of a dispatched
        plan (``req.started`` False — note ``seq.num_computed`` alone
        cannot distinguish them: a prefix-cache hit at admission sets it
        without any device work). Such requests have no device state and
        no sampled output, so moving them cannot lose or duplicate
        anything; admitted ones release their prefix-hit pages back to the
        cache unchanged (``cache=True`` is safe — nothing was advanced, so
        every page still holds exactly the content its hash describes).

        ``unstarted_only=False`` (crash failover) drops the in-flight ring
        unfetched and resets EVERY unfinished request; pages are then
        released UNCACHED regardless of ``cache`` — dispatched work may
        have mutated state pages past their boundary hashes (the PR-3
        poisoning rule), and a dead device's pages are untrusted anyway."""
        if not unstarted_only:
            self._inflight.clear()      # crash: in-flight results are lost
            cache = False
        out: List[Request] = []
        sched = self.scheduler
        for req in list(sched.waiting):
            if unstarted_only and req.started:
                continue
            sched.waiting.remove(req)
            out.append(req)
        for req in list(sched.running):
            if unstarted_only and req.started:
                continue
            sched.running.remove(req)
            out.append(req)
        for req in out:
            if req.seq is not None:
                # waiting-but-preempted requests hold no pages; admitted
                # ones do — preempt_request handles both uniformly
                self.mgr.preempt_request(req.seq, cache=cache)
                self.runner.forget(req.rid)
            self.sample_log.pop(req.rid, None)
            req.reset_for_routing()
        return out

    # --------------------------------------------- prefill->decode handoff
    # The second shard-mode drain path: a prefill-only shard hands a
    # prompt-complete request off to a decode shard at the prompt boundary.
    # Unlike drain_requests (which resets progress for re-admission), the
    # handoff preserves ALL progress: the typed page set is exported,
    # device-copied into the destination's pools, and the request resumes
    # there as a whole-prompt prefix hit with zero recomputed tokens.

    def handoff_ready(self) -> List[Request]:
        """Requests this prefill shard is done with: prompt fully computed,
        first token sampled (the prefill chunk's own dispatch samples it),
        and QUIET — no step still in the in-flight ring, so the device has
        stopped mutating their pages and the catch-up checkpoints of any
        suppressed boundaries have already been emitted."""
        if self.role != "prefill":
            return []
        live = self._live_inflight_rids()
        return [r for r in self.scheduler.running
                if r.seq is not None and not r.in_prefill
                and r.rid not in live]

    def begin_handoff(self, req: Request):
        """Detach a handoff-ready request and export its typed page set.
        The request leaves the scheduler (nothing more is dispatched for
        it); its pages stay resident here — IN_TRANSIT — while the copy
        stream reads them. Returns the ``PageSetExport``."""
        assert req in self.scheduler.running, req.rid
        self.scheduler.running.remove(req)
        return self.mgr.export_request(req.seq)

    def complete_handoff(self, req: Request, export) -> None:
        """Destination adopted the page set: release the export — the
        source copies retire into THIS shard's prefix cache exactly like a
        normal completion (future shared-prompt arrivals still hit here) —
        and drop the runner mirrors. The request itself lives on at the
        destination; it is not counted finished here."""
        self.mgr.release_export(req.seq, export)
        self.runner.forget(req.rid)

    def cancel_handoff(self, req: Request, export) -> None:
        """Adoption failed (destination pool pressure / death): lift the
        transit marks and requeue the request here untouched — it shows up
        in ``handoff_ready`` again next tick."""
        self.mgr.cancel_export(export)
        self.scheduler.running.append(req)

    def set_role(self, role: str) -> None:
        """Reassign the disaggregation role (colocated failover: prefill
        shards flip to "both" when no decode-capable shard is alive).
        Takes effect at the next ``schedule()`` call."""
        assert role in ("both", "prefill", "decode"), role
        self.role = role
        self.scheduler.cfg.prefill_only = role == "prefill"

    # ----------------------------------------------------------------- run
    @property
    def has_inflight(self) -> bool:
        """Whether any dispatched step is still awaiting completion."""
        return bool(self._inflight)

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        """Drive steps until every request finished (draining the in-flight
        ring on shutdown) or ``max_steps`` is hit."""
        while (self.scheduler.has_work() or self.has_inflight) \
                and self.step_count < max_steps:
            self.step()
        return self.finished
