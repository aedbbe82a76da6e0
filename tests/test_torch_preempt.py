"""Recompute preemption: the port's ``Engine`` against the JAX ``Engine``
on pools too small for the workload, at pipeline depths 1 and 4, for the
dense (granite-3-2b), hybrid (zamba2-1.2b) and MoE (dbrx-132b) families,
reduced, with the JAX init's weights.

Both engines must preempt the same number of times, finish the same
requests, and give greedy outputs fork-aware equal (``assert_greedy_equiv``);
the port's pool drains with no page left. On a pool smaller still, where
neither finishes every request within 200 steps, both must have preempted
the same number of times and finished the same requests by then.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

from conftest import assert_greedy_equiv, make_engine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.serving import Request, SamplingParams  # noqa: E402

import test_torch_engine  # noqa: E402
import test_torch_hybrid  # noqa: E402
import test_torch_moe  # noqa: E402
from test_torch_engine import DEPTHS, assert_drained_clean  # noqa: E402

# arch -> (pool bytes at which both engines preempt and finish, the port
# engine factory); zamba2's large page is 0.8 MB
POOLS = {
    "granite-3-2b": (60_000, test_torch_engine.port_engine),
    "zamba2-1.2b": (1_700_000, lambda arch, **kw:
                    test_torch_hybrid.port_engine(**kw)),
    "dbrx-132b": (60_000, lambda arch, **kw:
                  test_torch_moe.port_engine("dbrx", **kw)),
}


def _submit(eng, request_cls, sampling_cls):
    for i in range(4):
        eng.submit(request_cls(
            rid=f"r{i}", prompt=[(3 * i + j) % 97 for j in range(24 + 8 * i)],
            sampling=sampling_cls(max_new_tokens=12)))


def _pair(arch, pool, depth, max_steps=10_000):
    kw = dict(dict(DEPTHS)[depth], kv_pool_bytes=pool,
              record_sample_logits=True)
    jeng, _ = make_engine(arch, **kw)
    _submit(jeng, JRequest, JSamplingParams)
    jeng.run_until_done(max_steps=max_steps)
    eng = POOLS[arch][1](arch, **kw)
    _submit(eng, Request, SamplingParams)
    eng.run_until_done(max_steps=max_steps)
    return jeng, eng


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("arch", list(POOLS))
def test_preemption_matches_jax(arch, depth):
    jeng, eng = _pair(arch, POOLS[arch][0], depth)
    jn = jeng.scheduler.preemption_count
    assert jn > 0, "the pool is large enough not to preempt"
    assert eng.scheduler.preemption_count == jn
    assert len(eng.finished) == len(jeng.finished) == 4
    assert_greedy_equiv(jeng, eng, label=f"{arch}/depth {depth}")
    assert_drained_clean(eng)


@pytest.mark.parametrize("depth", [1, 4])
def test_pool_too_small_preempts_alike(depth):
    """granite-3-2b on a 30 kB pool: requests keep evicting each other;
    after 200 steps both engines have preempted equally often and
    finished the same requests, with outputs fork-aware equal."""
    jeng, eng = _pair("granite-3-2b", 30_000, depth, max_steps=200)
    assert jeng.step_count == eng.step_count == 200
    assert eng.scheduler.preemption_count == \
        jeng.scheduler.preemption_count > 50
    assert_greedy_equiv(jeng, eng, label=f"too small/depth {depth}")
    assert np.isfinite(eng.runner.buffer.float().numpy()).all()
