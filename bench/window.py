"""End-to-end metrics of one measured window, from what the host saw.

Token times are ``perf_counter`` at the ``Engine.step()`` return that grew
a request's output, which is what a streaming client sees. A request is
timed from the moment its client submitted it, so admission waits count.
Every statistic is taken over all the work of the window: no median of
chunks, no request left out."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class RequestTimes:
    submit: float
    first: Optional[float] = None
    finish: Optional[float] = None
    n_out: int = 0


def _inside(t: Optional[float], t0: float, t1: float) -> bool:
    return t is not None and t0 < t <= t1


def out_tok_s(token_events: Sequence[Tuple[float, int]], t0: float,
              t1: float) -> float:
    """Output tokens the host received in (t0, t1], over the window."""
    n = sum(k for t, k in token_events if t0 < t <= t1)
    return n / (t1 - t0)


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile (linear between order statistics); None for no
    values."""
    return float(np.percentile(np.asarray(values, np.float64), 95)) \
        if len(values) else None


def ttft_ms(reqs: Sequence[RequestTimes], t0: float, t1: float
            ) -> List[float]:
    """Time to first token of every request whose first token came in the
    window."""
    return [(r.first - r.submit) * 1e3 for r in reqs
            if _inside(r.first, t0, t1)]


def tpot_ms(reqs: Sequence[RequestTimes], t0: float, t1: float
            ) -> List[float]:
    """(finish - first token) / (outputs - 1) of every request that
    finished in the window."""
    return [(r.finish - r.first) * 1e3 / (r.n_out - 1) for r in reqs
            if _inside(r.finish, t0, t1) and r.n_out > 1]
