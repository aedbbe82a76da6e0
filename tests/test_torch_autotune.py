"""The port's roofline-seeded budget autotuning against the JAX package.

* ``count_params`` (``repro_torch.launch.roofline``, a copy) equals the
  reference's for every architecture.
* The seed budget comes from the H100's constants (989 TFLOP/s bf16,
  3.35 TB/s): round16(989 / 3.35) = 288 tokens for a dense model, where
  total and active parameters are equal.
* ``observe`` takes the same decisions as the reference's on the same
  synthetic ``StepMetrics``, with the reference module's constants set to
  the H100's for the test (monkeypatch; no file changes).
* An autotuned engine (packed, pipeline depth 2) drains clean and is
  fork-aware equal to the same engine without autotuning; a fleet gives
  each shard its own autotuner with a window scaled by the fleet size.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

import repro.serving.autotune as jautotune  # noqa: E402
from conftest import assert_greedy_equiv, get_model  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch.roofline import count_params as jcount_params  # noqa: E402
from repro.serving.engine import StepMetrics as JStepMetrics  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.roofline import (HBM_BW, PEAK_FLOPS,  # noqa: E402
                                         count_params)
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving import (DPEngine, Engine, EngineConfig,  # noqa: E402
                                 Request, SamplingParams, StepMetrics)
from repro_torch.serving.autotune import (MAX_BUDGET, MIN_BUDGET,  # noqa: E402
                                          QUANTUM, BudgetAutotuner,
                                          roofline_token_budget,
                                          shard_pool_bytes)


def test_h100_constants():
    assert PEAK_FLOPS == 989e12 and HBM_BW == 3.35e12


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_params_matches_reference(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    for cfg, jcfg in ((ARCHS[arch], JARCHS[arch]),
                      (reduced(ARCHS[arch]), jreduced(JARCHS[arch]))):
        assert count_params(cfg) == jcount_params(jcfg)


def test_seed_budget_from_h100_roofline():
    """Dense: total == active, so T* = 989 / 3.35 = 295.2 tokens, rounded
    to the 16-token quantum: 288 (the reference's TPU constants give
    240). MoE: total / active > 1 pushes it right."""
    for arch in ("granite-3-2b", "internlm2-1.8b", "qwen2.5-32b"):
        for cfg in (ARCHS[arch], reduced(ARCHS[arch])):
            n = count_params(cfg)
            assert n["total"] == n["active"]
            assert roofline_token_budget(cfg) == 288
    tun = BudgetAutotuner(ARCHS["granite-3-2b"])
    assert (tun.budget, tun.prefill_cap) == (288, 224)
    for arch in ("dbrx-132b", "qwen3-moe-235b-a22b"):
        b = roofline_token_budget(ARCHS[arch])
        assert 288 < b <= MAX_BUDGET and b % QUANTUM == 0


def _metrics(cls, scenario, n=40, seed=0):
    """Synthetic step metrics: host-bound steps, attention bytes growing
    by half a step, flat traffic, or random mixtures of the three."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if scenario == "host-bound":
            kw = dict(host_build_ms=5.0, dispatch_ms=1.0)
        elif scenario == "bytes-trend":
            kw = dict(host_build_ms=0.1, dispatch_ms=1.0,
                      attn_bytes_modeled=1e6 * 1.5 ** i)
        elif scenario == "flat":
            kw = dict(host_build_ms=0.1, dispatch_ms=1.0,
                      attn_bytes_modeled=1e6)
        else:
            kw = dict(host_build_ms=rng.uniform(0, 4),
                      host_sample_ms=rng.uniform(0, 1),
                      dispatch_ms=rng.uniform(0, 4),
                      dispatch_compute_ms=rng.choice([0.0, rng.uniform(0, 4)]),
                      attn_bytes_modeled=rng.uniform(0, 1e7) * (1 + i))
        out.append(cls(step=i, decode_batch=1, prefill_tokens=0,
                       used_units=0, evictable_units=0, empty_units=0,
                       free_units=0, **kw))
    return out


@pytest.mark.parametrize("scenario", ["host-bound", "bytes-trend", "flat",
                                      "mixed"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "dbrx-132b"])
def test_observe_decides_as_the_reference(monkeypatch, scenario, arch):
    monkeypatch.setattr(jautotune, "PEAK_FLOPS", PEAK_FLOPS)
    monkeypatch.setattr(jautotune, "HBM_BW", HBM_BW)
    for window, shards in ((4, 1), (16, 2)):
        ours = BudgetAutotuner(ARCHS[arch], window=window, num_shards=shards)
        ref = jautotune.BudgetAutotuner(JARCHS[arch], window=window,
                                        num_shards=shards)
        assert (ours.budget, ours.prefill_cap, ours.window) == \
            (ref.budget, ref.prefill_cap, ref.window)
        decisions = []
        for m, jm in zip(_metrics(StepMetrics, scenario, n=80),
                         _metrics(JStepMetrics, scenario, n=80)):
            a, b = ours.observe(m), ref.observe(jm)
            assert a == b
            decisions.append(a)
            assert (ours.budget, ours.prefill_cap, ours.adjustments) == \
                (ref.budget, ref.prefill_cap, ref.adjustments)
        assert any(decisions) == (scenario != "flat")
        assert MIN_BUDGET <= ours.budget <= MAX_BUDGET


def test_shard_window_scaling():
    one = BudgetAutotuner(ARCHS["granite-3-2b"])
    four = BudgetAutotuner(ARCHS["granite-3-2b"], num_shards=4)
    assert (four.budget, four.prefill_cap) == (one.budget, one.prefill_cap)
    assert four.window == 4 * one.window
    assert shard_pool_bytes(100, 4) == 25
    assert shard_pool_bytes(3, 8) == 1


def _port(arch):
    _, _, jparams = get_model(arch)
    cfg = reduced(ARCHS[arch])
    return build_model(cfg), params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _drain(eng, n=6):
    for i in range(n):
        eng.submit(Request(rid=f"r{i}",
                           prompt=[(5 * i + j) % 50 for j in range(12 + 7 * i)],
                           sampling=SamplingParams(max_new_tokens=5)))
    return eng.run_until_done(max_steps=1000)


def test_autotuned_engine_drains_and_matches():
    """Packed at depth 2 with ``autotune_budgets``: the scheduler starts
    at the roofline seed, budgets stay quantized and bounded whatever the
    wall-clock metrics made ``observe`` do, the pool drains, and outputs
    are fork-aware equal to the engine without autotuning (budgets change
    the step composition, so not bitwise)."""
    model, params = _port("granite-3-2b")
    kw = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8,
              async_scheduling=True, pipeline_depth=2,
              record_sample_logits=True)
    tuned = Engine(model, EngineConfig(autotune_budgets=True, **kw),
                   params=params, device="cpu")
    assert tuned.autotuner is not None
    assert tuned.scheduler.cfg.max_num_batched_tokens == 288
    assert tuned.scheduler.cfg.max_prefill_tokens_per_step == \
        tuned.autotuner.prefill_cap == 224
    tuned.autotuner.window = 2          # let observe act within the run
    tuned.autotuner._hist = type(tuned.autotuner._hist)(maxlen=2)
    plain = Engine(model, EngineConfig(**kw), params=params, device="cpu")
    assert plain.autotuner is None
    assert len(_drain(tuned)) == len(_drain(plain)) == 6
    for eng in (tuned, plain):
        eng.mgr.check_invariants()
        assert eng.mgr.memory_stats().used_units == 0
    b = tuned.scheduler.cfg.max_num_batched_tokens
    assert b % QUANTUM == 0 and MIN_BUDGET <= b <= MAX_BUDGET
    assert_greedy_equiv(plain, tuned, label="autotune")


def test_fleet_autotuned_budgets_per_shard():
    model, params = _port("granite-3-2b")
    dp = DPEngine(model, EngineConfig(kv_pool_bytes=8 << 20, max_running=4,
                                      chunk_size=8, autotune_budgets=True),
                  params=params, num_shards=2, split_pool=False,
                  device="cpu")
    for sh in dp.shards:
        tun = sh.engine.autotuner
        assert tun is not None and tun.num_shards == 2
        assert tun.window == 32
        assert sh.engine.scheduler.cfg.max_num_batched_tokens == 288
    dp.submit(Request(rid="a", prompt=[1, 2, 3, 4],
                      sampling=SamplingParams(max_new_tokens=3)))
    dp.run_until_done()
    assert len(dp.finished) == 1
    dp.check_invariants()
