"""The PagedAttention baseline (``EngineConfig(memory_mode="paged-baseline")``,
the paper's Figs. 13/14 comparison) in the port, on the CPU, against JAX.

Reduced h2o-danube-3-4b (sliding window 8), qwen2-vl-2b (image items) and
whisper-tiny (audio clips beside text-only rows) each drain one workload
through the JAX packed engine and the port's, in both memory modes, with
the JAX init's weights and PageSan on. The host side is a copy, so:

* greedy outputs are fork-aware equal (``assert_greedy_equiv``);
* the referenced pool units (``StepMetrics.used_units``) are EQUAL at
  every step, in both modes;
* danube's baseline peak is above Jenga's (its window pages never retire);
* whisper's text-only rows hold a cross page for every token under the
  baseline and none under Jenga (``_apply_baseline_semantics`` widens
  only rows without encoder items, so the clip rows and the peak may tie);
* the pool drains with no page referenced.

qwen2-vl-2b keeps image embeddings in no KV type (its one spec is
``full_attn``: the reference has no ``vision_embed`` pages), so the two
modes allocate the same pages and its peaks are equal in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

from conftest import assert_greedy_equiv, get_model, make_engine  # noqa: E402
from repro.serving import MMItem as JMMItem  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.request import SequenceState  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, MMItem,  # noqa: E402
                                 Request, SamplingParams)

from test_torch_engine import assert_drained_clean  # noqa: E402

MODES = ("jenga", "paged-baseline")
# (prompt lengths, each request's items and whether they are encoder items)
WORKLOADS = {
    "h2o-danube-3-4b": ([20, 25, 30], [()] * 3, False),
    "qwen2-vl-2b": ([14, 19, 24, 29],
                    [(MMItem(2, 6, mm_hash=42),), (),
                     (MMItem(1, 6, mm_hash=42),),
                     (MMItem(4, 9, mm_hash=9),)], False),
    "whisper-tiny": ([8, 13, 18],
                     [(MMItem(0, 16, mm_hash=42),), (),
                      (MMItem(0, 12, mm_hash=9),)], True),
}
_PORT = {}


def _port(arch):
    if arch not in _PORT:
        _, _, jparams = get_model(arch)
        cfg = reduced(ARCHS[arch])
        _PORT[arch] = (build_model(cfg), params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return _PORT[arch]


def _drain(eng, arch, request_cls, sampling_cls, item_cls):
    """Submit ``WORKLOADS[arch]``, drain it one step at a time and return
    the used units after every step and, per text-only request of an
    enc-dec model, (the most cross pages it held, the least of held pages
    x TPP - computed tokens) over the steps it ran."""
    lens, items, encoder = WORKLOADS[arch]
    for i, (n, its) in enumerate(zip(lens, items)):
        its = tuple(item_cls(it.start, it.length, mm_hash=it.mm_hash)
                    for it in its)
        eng.submit(request_cls(
            rid=f"r{i}", prompt=[(7 * i + j) % 50 for j in range(n)],
            sampling=sampling_cls(max_new_tokens=6),
            **{"encoder_items" if encoder else "mm_items": its}))
    cross = {f"r{i}": [] for i, its in enumerate(items)
             if encoder and not its}
    spec = next((s for s in eng.mgr.specs if s.kind == "cross_attn"), None)
    used = []
    while eng.scheduler.has_work():
        eng.step()
        used.append(eng.metrics[-1].used_units)
        for r in eng.scheduler.running:
            if r.rid in cross and r.seq.num_computed:
                held = sum(e != SequenceState.FREED
                           for e in r.seq.page_tables.get(spec.name, []))
                cross[r.rid].append(
                    (held, held * spec.tokens_per_page - r.seq.num_computed))
    return used, {rid: (max(h for h, _ in v), min(s for _, s in v))
                  for rid, v in cross.items()}


@pytest.mark.parametrize("arch", list(WORKLOADS))
def test_baseline_matches_jax_step_by_step(arch, monkeypatch):
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    model, params = _port(arch)
    kw = dict(async_scheduling=False, record_sample_logits=True)
    peaks, cross = {}, {}
    for mode in MODES:
        jeng, _ = make_engine(arch, memory_mode=mode, **kw)
        jused, _ = _drain(jeng, arch, JRequest, JSamplingParams, JMMItem)
        eng = Engine(model, EngineConfig(
            kv_pool_bytes=8 << 20, max_running=4, chunk_size=8,
            memory_mode=mode, **kw), params=params, device="cpu")
        used, cross[mode] = _drain(eng, arch, Request, SamplingParams,
                                   MMItem)
        assert used == jused, (arch, mode, used, jused)
        assert eng.encoder_runs == jeng.encoder_runs
        assert_greedy_equiv(jeng, eng, label=f"{arch}/{mode}")
        assert_drained_clean(eng)
        eng.mgr.sanitizer.assert_drained()
        peaks[mode] = max(used)
    if arch == "h2o-danube-3-4b":
        assert peaks["paged-baseline"] > peaks["jenga"], peaks
    elif arch == "qwen2-vl-2b":
        assert peaks["paged-baseline"] == peaks["jenga"], peaks
    else:
        assert peaks["paged-baseline"] >= peaks["jenga"], peaks
        # Jenga: no cross page for a row without a clip; the baseline:
        # enough for every computed token, at every step it ran
        assert cross["jenga"] == {"r1": (0, cross["jenga"]["r1"][1])}, cross
        held, slack = cross["paged-baseline"]["r1"]
        assert held > 0 and slack >= 0, cross
