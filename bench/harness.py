"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, and the check that decides ``correct``.

Set-up (``setup_s``) is everything from the process start to the window's
opening: imports, CUDA and the kernel libraries, the weights, the pool,
and a warm-up that runs the cell's own traffic until the closed loop has
turned over once (as many requests finished as the cell has clients).

The window runs the same loop for ``seconds``. With ``trace`` its last
``TRACE_SECONDS`` run under ``torch.profiler`` (device activity only; a
synchronise at each end of that part; the window runs on until that
part is whole, since the profiler's first start takes seconds) with the
engine's phases timed, and the per-layer metrics are read
(``bench/metrics/<name>.py``): the host's from the untraced part, the
device's from the traced one.

Once the window has closed and the peak memory is read, the engine is
freed and the plain reference (``bench/reference/<family>.py``) is run
over a sample of the requests that finished in the window, the longest
among them: the widest gap by which a served token's reference logit lies
below the reference's best is the number compared with the cell's limit
(``bench/limits/<cell>.json``)."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import loadgen, manifest, weights
from . import window as W

TRACE_SECONDS = 5.0      # the traced end of a --trace 1 window
PROGRESS_S = 10.0        # seconds between progress lines on stderr
WARMUP_LIMIT_S = 200.0   # set-up past this is a failed run, not a slow one
SAMPLE_TOKENS = 256      # served tokens the check compares, at least...
SAMPLE_MIN, SAMPLE_MAX = 3, 8   # ...over this many requests
FOREIGN = frozenset({"jax", "jaxlib", "flax", "repro"})


@dataclasses.dataclass
class StepRecord:
    t: float
    running: int
    used_units: int
    build_issue_ms: float


@dataclasses.dataclass
class Dispatch:
    items: List[Tuple[int, int, int]]   # (prompt_len, num_tokens, start)
    traced: bool


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads: the steps and dispatches of
    the window's untraced part (``window_s`` long), every dispatch with
    its ``traced`` flag, and the traced part's device activity."""
    model: Dict
    window_s: float
    pool_units: int
    steps: List[StepRecord]
    dispatches: List[Dispatch]
    all_dispatches: List[Dispatch] = dataclasses.field(default_factory=list)
    trace: object = None      # bench.trace.TraceData of the traced part


def model_config(cfg_file: Dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    kw = dict(cfg_file["model"])
    if "attn_pattern" in kw:
        kw["attn_pattern"] = tuple(kw["attn_pattern"])
    return ModelConfig(**kw)


def build_model_only(cfg_file: Dict):
    """The port's model of a configuration file (no weights)."""
    from repro_torch.models import build_model
    return build_model(model_config(cfg_file))


def build(cfg_file: Dict, seed: int, device):
    """The model, the benchmark's weights from ``seed`` and one engine with
    the configuration's settings."""
    from repro_torch.models.params import MATRICES
    from repro_torch.serving import Engine, EngineConfig
    model = build_model_only(cfg_file)
    params = weights.make(model.param_shapes(), MATRICES, cfg_file["init"],
                          seed, device)
    eng = Engine(model, EngineConfig(**cfg_file["engine"]), params=params,
                 device=device)
    return model, params, eng


class ClosedLoop:
    """``clients`` workers over one engine: each submits its next request
    when its last one finishes, at the time the host saw it finish."""

    def __init__(self, eng, traffic: loadgen.Traffic, log=lambda s: None):
        from repro_torch.serving import Request, SamplingParams
        from repro_torch.serving.request import Status
        self._request, self._sampling = Request, SamplingParams
        self._finished_status = Status.FINISHED
        self.eng = eng
        self.traffic = traffic
        self.next_i = 0
        self.active: Dict[str, list] = {}      # rid -> [req, times, seen]
        self.finished: List[Tuple[object, W.RequestTimes]] = []
        self.all_times: List[W.RequestTimes] = []
        self.token_events: List[Tuple[float, int]] = []
        self.log = log
        self._last_log = time.perf_counter()
        self._acc = [0, 0]

    def submit(self, t: float) -> None:
        prompt, olen = self.traffic.request(self.next_i)
        req = self._request(rid=f"q{self.next_i}", prompt=prompt,
                            sampling=self._sampling(max_new_tokens=olen))
        self.next_i += 1
        times = W.RequestTimes(submit=t)
        self.all_times.append(times)
        self.active[req.rid] = [req, times, 0]
        self.eng.submit(req)

    def _progress(self, t: float, m) -> None:
        """A line on standard error every ``PROGRESS_S`` seconds: what the
        engine holds and how fast it steps (diagnostics, not metrics)."""
        self._acc[0] += 1
        self._acc[1] += 0 if m is None else m.batched_tokens
        if t - self._last_log < PROGRESS_S:
            return
        h = self.eng.health_snapshot()
        n, tok = self._acc
        self.log(f"[bench] steps {h.step} finished {len(self.finished)} "
                 f"running {h.running} waiting {h.waiting} preemptions "
                 f"{h.preemption_count} defers {h.defer_count}; last "
                 f"{n} steps {1e3 * (t - self._last_log) / n:.1f} ms and "
                 f"{tok / n:.0f} tokens each")
        self._last_log, self._acc = t, [0, 0]

    def start(self) -> None:
        t = time.perf_counter()
        for _ in range(self.traffic.clients):
            self.submit(t)

    def step(self):
        """One engine step; returns (host time at its return, its
        StepMetrics)."""
        m = self.eng.step()
        t = time.perf_counter()
        self._progress(t, m)
        new = 0
        done = []
        for rid, ent in self.active.items():
            req, times, seen = ent
            n = len(req.output)
            if n != seen:
                if seen == 0:
                    times.first = t
                new += n - seen
                ent[2] = n
            if req.status is self._finished_status:
                times.finish, times.n_out = t, n
                done.append(rid)
        if new:
            self.token_events.append((t, new))
        for rid in done:
            req, times, _ = self.active.pop(rid)
            self.finished.append((req, times))
            self.submit(t)
        return t, m


def _wrap(obj, name: str, span: str, spans: list, state: dict,
          on_call=None):
    """Time ``obj.name`` on this instance into ``spans`` while the window
    is traced, on the profiler's clock (as the port's chip smoke wraps
    ``apply_copies``); no program file is edited."""
    inner = getattr(obj, name)

    def wrapped(*a, **k):
        if on_call is not None:
            on_call(*a, **k)
        if not state["traced"]:
            return inner(*a, **k)
        t0 = time.time_ns()
        try:
            return inner(*a, **k)
        finally:
            spans.append((span, t0 * 1e-9, time.time_ns() * 1e-9))

    setattr(obj, name, wrapped)


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FOREIGN)


def pick_sample(finished, seed: int) -> list:
    """The requests the check compares: the longest that finished in the
    window, then others in an order drawn from the seed, until
    ``SAMPLE_TOKENS`` served tokens (at least ``SAMPLE_MIN`` requests, at
    most ``SAMPLE_MAX``)."""
    if not finished:
        return []
    key = [len(r.prompt) + len(r.output) for r in finished]
    first = int(np.argmax(key))
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7])
    order = [first] + [int(i) for i in rng.permutation(len(finished))
                       if i != first]
    out, tokens = [], 0
    for i in order:
        if len(out) >= SAMPLE_MAX or (tokens >= SAMPLE_TOKENS and
                                      len(out) >= SAMPLE_MIN):
            break
        out.append(finished[i])
        tokens += len(finished[i].output)
    return out


def logit_gaps(ref, params, model: Dict, req, quant=None):
    """The reference's fp32 logits at every position that served a token
    of ``req``; returns (gap of each served token below the reference's
    best, and with ``quant`` the same gap of the tokens ``quant``'s logits
    put first at those positions, or None)."""
    import torch
    p = len(req.prompt)
    toks = list(req.prompt) + list(req.output[:-1])
    rows = range(p - 1, p - 1 + len(req.output))
    exact = ref.logits(params, model, toks, rows)
    best = exact.max(-1).values
    ar = torch.arange(len(rows), device=exact.device)
    served = torch.as_tensor(req.output, device=exact.device)
    gap = (best - exact[ar, served]).max().item()
    ctrl = None
    if quant is not None:
        low = ref.logits(params, model, toks, rows, quant=quant)
        ctrl = (best - exact[ar, low.argmax(-1)]).max().item()
    return gap, ctrl


def verdict(gaps: Sequence[float], wrong_outputs: int,
            limit: float) -> Dict:
    """``correct``, ``failed`` and ``checks`` from the compared requests'
    widest logit gaps and the count of wrong outputs: the one comparison
    that judges the program, and its control in the program's place."""
    failed = sum(g > limit for g in gaps) + wrong_outputs
    return {"correct": bool(gaps) and failed == 0, "failed": failed,
            "checks": {"max_logit_gap": {"value": max(gaps, default=None),
                                         "limit": limit},
                       "wrong_outputs": {"value": wrong_outputs,
                                         "limit": 0}}}


def run_cell(cfg_file: Dict, traffic_spec: Dict, limit: float, seed: int,
             seconds: float, trace: bool, per_layer: Sequence,
             t_start: float, device="cuda", control: Optional[str] = None,
             log: Callable[[str], None] = lambda s: None) -> Dict:
    """One run; returns the result line's fields (and, with ``control``,
    the control's verdict under ``"control"``: the reference at that
    precision put in the program's place over the same requests)."""
    import torch
    dev = torch.device(device)
    model_dims = cfg_file["model"]
    traffic = loadgen.Traffic(traffic_spec, model_dims["vocab_size"], seed)
    model, params, eng = build(cfg_file, seed, dev)
    loop = ClosedLoop(eng, traffic, log)

    state = {"record": False, "traced": False}
    dispatches: List[Dispatch] = []

    def on_dispatch(params_, prep):
        if state["record"]:
            dispatches.append(Dispatch(
                [(len(r.prompt), nt, st) for si, (r, nt, st)
                 in enumerate(prep.items) if si not in prep.dead],
                state["traced"]))

    spans: List[Tuple[str, float, float]] = []
    if trace:
        if dev.type != "cuda":
            raise ValueError("a traced run needs the card")
        _wrap(eng.scheduler, "schedule", "scheduler.schedule", spans, state)
        _wrap(eng.runner, "prepare", "runner.prepare", spans, state)
        _wrap(eng.runner, "dispatch", "runner.dispatch", spans, state,
              on_dispatch)
        _wrap(eng, "_complete", "engine.complete", spans, state)

    # --- warm-up: the cell's own traffic until the loop has turned over
    loop.start()
    t = time.perf_counter()
    while len(loop.finished) < traffic.clients:
        t, _ = loop.step()
        if t - t_start > WARMUP_LIMIT_S:
            raise RuntimeError(
                f"warm-up did not turn the loop over in {WARMUP_LIMIT_S} s: "
                f"{len(loop.finished)} of {traffic.clients} finished")
    t_open = t
    setup_s = t_open - t_start
    log(f"[bench] window opens after {setup_s:.1f} s of set-up "
        f"({len(loop.finished)} requests finished in warm-up)")

    # --- the window; a traced run traces its last TRACE_SECONDS and reads
    # the host's per-layer metrics over the untraced part before them
    steps: List[StepRecord] = []
    prof = None
    trace_from = t_open + max(0.0, seconds - TRACE_SECONDS)
    state["record"] = True
    total_units = cfg_file["engine"]["kv_pool_bytes"] // 2
    window = []
    untraced = None     # (seconds, steps) before the trace started

    def edge():
        # the device idle at each end of the traced part, and the time on
        # the profiler's clock
        torch.cuda.synchronize(dev)
        window.append(time.time_ns() * 1e-9)

    t_end = t_open + seconds
    while True:
        if trace and prof is None and t >= trace_from:
            untraced = (t - t_open, len(steps))
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()        # its first start in a process takes seconds
            edge()
            state["traced"] = True
            t_end = max(t_end, time.perf_counter() + TRACE_SECONDS)
        t, m = loop.step()
        steps.append(StepRecord(
            t, len(eng.scheduler.running), m.used_units,
            m.host_build_ms + m.dispatch_issue_ms))
        if t >= t_end:
            break
    if prof is not None:
        state["traced"] = False
        edge()
        prof.stop()
    t_close = t
    state["record"] = False
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    health = eng.health_snapshot()

    # --- end-to-end metrics
    window_s = t_close - t_open
    e2e = {
        "out_tok_s": W.out_tok_s(loop.token_events, t_open, t_close),
        "ttft_p95_ms": W.p95(W.ttft_ms(loop.all_times, t_open, t_close)),
        "tpot_p95_ms": W.p95(W.tpot_ms(loop.all_times, t_open, t_close)),
        "setup_s": setup_s,
    }
    in_window = [req for req, tm in loop.finished
                 if t_open < tm.finish <= t_close]
    log(f"[bench] window {window_s:.2f} s: {len(steps)} steps, "
        f"{len(in_window)} requests finished, {health.preemption_count} "
        f"preemptions, {health.defer_count} defers in all; peak "
        f"{peak} bytes")

    # --- free the program's state before the reference runs
    del loop, eng, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result = {"e2e": e2e, "peak": peak, "kind": kind,
              "attempted": len(in_window)}
    if trace:
        from . import trace as T
        data = T.reduce(prof, spans, window)
        del prof
        host_s, n_host = untraced
        run = Run(model_dims, host_s, total_units, steps[:n_host],
                  [d for d in dispatches if not d.traced], dispatches, data)
        result["per_layer"] = {
            name: manifest.metric_reader(name).read(run) for name in per_layer}
        result["device_extra"] = {"busy_s": data.busy_s,
                                  "window_s": data.window_s}
        result["breakdown"] = T.breakdown(data)

    # --- correctness: the reference over a sample of the window's requests
    from .reference.common import exact_fp32
    exact_fp32()
    ref = manifest.reference(cfg_file["family"])
    wrong_len = sum(len(r.output) != r.sampling.max_new_tokens or
                    any(not 0 <= tk < model_dims["vocab_size"]
                        for tk in r.output) for r in in_window)
    sample = pick_sample(in_window, seed)
    gaps, ctrls = [], []
    t_ref = time.perf_counter()
    for req in sample:
        g, c = logit_gaps(ref, params, model_dims, req, control)
        gaps.append(g)
        ctrls.append(c)
    log(f"[bench] reference over {len(sample)} requests "
        f"({sum(len(r.output) for r in sample)} served tokens, longest "
        f"{max((len(r.prompt) + len(r.output) for r in sample), default=0)}"
        f") took {time.perf_counter() - t_ref:.1f} s")
    result.update(verdict(gaps, wrong_len, limit))
    if control is not None:
        # the control's tokens in the program's place, judged alike (its
        # outputs have the served lengths, so none is wrong by length)
        result["control"] = verdict(ctrls, 0, limit)
        result["gaps"] = gaps
        result["control_gaps"] = ctrls
    return result
