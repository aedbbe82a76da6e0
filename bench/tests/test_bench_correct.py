"""``correct`` on the CPU at a small size of each family: a run of the
harness (its look for a card skipped) agrees with the fp32 reference
through chunked prefill and decode, and comes out false with the timed
path broken underneath by each fault of ``bench/faults.py``: a step that
leaves its state unchanged, half of the batch replaced by the mean over
the rest, a token altered where it is produced. (The cells run on one
card: there is no exchange between cards to leave out.)"""
import time

import pytest
import torch

from bench import harness
from bench.faults import FAULTS
from bench.tests.small import small_config, small_traffic

# at this size the bf16 port's widest gap read 0 to 0.021 over windows of
# 1 to 4 s, the fp8 control's 0.31 to 0.66 over three seeds
# (test_bench_control.py) and the faults' 2.4 to 5.4; the limit lies
# between
LIMIT = 0.1
FAMILIES = {"dense": "h2o-danube-3-4b"}
SEED = 2**31 + 29


def run(config, fault=None, monkeypatch=None, seconds=2.0, control=None):
    """A run's window is wall-clock time: one thread keeps its steps
    short beside the other test workers, so that requests finish in it."""
    torch.manual_seed(0)
    cfg = small_config(config)
    if fault is not None:
        FAULTS[fault](monkeypatch.setattr, cfg["model"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(cfg, small_traffic("docqa10"), LIMIT, SEED,
                                seconds, False, [], time.perf_counter(),
                                device="cpu", control=control)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sound_run_is_correct(family):
    res = run(FAMILIES[family])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert res["checks"]["max_logit_gap"]["value"] < LIMIT


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_broken_path_is_not_correct(family, fault, monkeypatch):
    res = run(FAMILIES[family], fault, monkeypatch)
    assert res["attempted"] > 0
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_logit_gap"]["value"] > LIMIT
