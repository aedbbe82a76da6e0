"""The window arithmetic on synthetic timelines: a stall inside the window
lowers the token rate and raises the tail of time to first token."""
from bench import window as W


def timeline(stall: float):
    """Requests submitted every 0.1 s, first token 0.2 s later, 5 tokens
    0.05 s apart; a stall at t = 4 s delays every token from then on."""
    reqs, events = [], []
    for i in range(100):
        sub = 0.1 * i
        times = [sub + 0.2 + 0.05 * k for k in range(5)]
        times = [t + stall if t >= 4.0 else t for t in times]
        reqs.append(W.RequestTimes(sub, times[0], times[-1], 5))
        events += [(t, 1) for t in times]
    return reqs, events


def test_stall_lowers_rate_and_raises_ttft():
    base_r, base_e = timeline(0.0)
    stal_r, stal_e = timeline(1.5)
    t0, t1 = 1.0, 8.0
    assert W.out_tok_s(stal_e, t0, t1) < W.out_tok_s(base_e, t0, t1)
    assert W.p95(W.ttft_ms(stal_r, t0, t1)) > \
        W.p95(W.ttft_ms(base_r, t0, t1)) + 500
    assert abs(W.p95(W.ttft_ms(base_r, t0, t1)) - 200) < 1e-6


def test_window_edges():
    reqs = [W.RequestTimes(0.0, 1.0, 2.0, 3), W.RequestTimes(0.0, 5.0, 9.0, 3)]
    assert W.ttft_ms(reqs, 0.5, 6.0) == [1000.0, 5000.0]
    assert W.tpot_ms(reqs, 0.5, 6.0) == [500.0]
    assert W.out_tok_s([(1.0, 4), (6.0, 2), (6.5, 8)], 1.0, 6.0) == 2 / 5
    assert W.p95([]) is None
