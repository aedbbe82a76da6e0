"""Shared test helpers: one reduced model (+ params) per arch for the whole
session. Engines are recreated freely across tests and A/B legs; sharing
the model instance also shares its serve-step jit cache (see
ModelRunner), which is most of the suite's wall-clock.

REPRO_ATTENTION_IMPL=kernel flips the default attention implementation so
the same suite exercises the Pallas varlen kernel path (the tier-1 CI
kernel leg); tests that pass attention_impl explicitly are unaffected.

``assert_greedy_equiv`` is the shared fork-aware cross-layout greedy
comparison (see the TIE_EPS note in ``repro.serving.engine``)."""
import os

from repro.configs import ARCHS, reduced
from repro.models.registry import build_model
from repro.models.tp import single_device_dist
from repro.serving import Engine, EngineConfig

_MODELS = {}    # arch -> (model, cfg, params)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


def get_model(arch):
    if arch not in _MODELS:
        cfg = reduced(ARCHS[arch])
        model = build_model(cfg, single_device_dist())
        _MODELS[arch] = (model, cfg, model.init(0))
    return _MODELS[arch]


def make_engine(arch="granite-3-2b", **cfg_kw):
    model, cfg, params = get_model(arch)
    kw = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8,
              attention_impl=os.environ.get("REPRO_ATTENTION_IMPL", "ref"))
    kw.update(cfg_kw)
    return Engine(model, EngineConfig(**kw), params=params), cfg


# Fork tolerance for cross-layout greedy comparisons: at a token
# divergence, BOTH modes' recorded fp32 logit rows must place BOTH chosen
# tokens within this gap of the row max — i.e. the decision was genuinely
# ambiguous under bf16 reduction-order noise (measured <= ~4e-3; real
# masking/leak bugs shift logits by >> 1e-1). Wider than TIE_EPS on
# purpose: the band makes near-ties deterministic per mode, the fork
# check bounds what may differ across modes.
TIE_FORK_TOL = 2.5e-2


def assert_greedy_equiv(ref_eng, other_eng, label=""):
    """Greedy outputs of two drained engines must be token-identical up
    to genuinely ambiguous forks. Exact equality is asserted until the
    first differing token of each request; that decision must be a
    near-tie in BOTH engines' recorded logit rows (TIE_FORK_TOL), after
    which the trajectories have legitimately forked and later tokens are
    incomparable. Requires ``record_sample_logits=True`` on both engines.
    Returns the set of forked request ids (empty == bitwise-exact)."""
    ref = {r.rid: list(r.output) for r in ref_eng.finished}
    other = {r.rid: list(r.output) for r in other_eng.finished}
    assert set(ref) == set(other), (label, set(ref) ^ set(other))
    forked = set()
    for rid in ref:
        a, b = ref[rid], other[rid]
        n = min(len(a), len(b))
        i = next((j for j in range(n) if a[j] != b[j]), None)
        if i is None:
            # identical prefix implies identical EOS decisions
            assert len(a) == len(b), (label, rid, a, b)
            continue
        la = ref_eng.sample_log[rid][i]
        lb = other_eng.sample_log[rid][i]
        ga = float(la.max() - la[b[i]])   # other's pick, scored by ref
        gb = float(lb.max() - lb[a[i]])   # ref's pick, scored by other
        assert ga <= TIE_FORK_TOL and gb <= TIE_FORK_TOL, (
            label, rid, i, a[i], b[i], ga, gb,
            "divergence beyond tie tolerance — not reduction-order noise")
        forked.add(rid)
    return forked
