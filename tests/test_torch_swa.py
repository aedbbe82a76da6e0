"""h2o-danube-3-4b (alternating full / sliding-window layers) in the port,
on the CPU, against JAX.

* Engines: reduced danube (window 8, 4 layers: two "full_attn" and two
  "swa") drains four prompts of 10-37 tokens, which cross the window, at
  a 24-token budget, through the port's packed engine at depths 1 and 4,
  padded and serial, under PageSan. Every leg is fork-aware equal to the
  JAX packed engine (``assert_greedy_equiv``, TIE_FORK_TOL), the packed
  depths bitwise equal, the pool drained with no page referenced (the
  prefix cache may keep unreferenced pages), and the
  SWA type must have dropped pages below its window mid-request while no
  full-attention page was dropped. The same again at ``head_dim=120``,
  danube's full-width head dim.
* Kernels at head dim 120: the port's plain varlen, paged decode and dense
  versions against the Pallas kernels in interpret mode and their oracles
  (fp32 inputs: 3e-5 as the JAX tests' own bound for varlen and dense, 2e-5
  for paged; dense gradients 1e-4 against ``jax.grad`` of the oracle), and
  the three CUDA wrappers' checks accepting D 120 and refusing D 96.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_greedy_equiv  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_tpu, flash_attention_varlen_tpu)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref, flash_attention_varlen_ref)
from repro.kernels.paged_attention.kernel import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.tp import single_device_dist  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.request import SequenceState  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, flash_attention_varlen_plain)
from repro_torch.kernels.flash_attention import dense  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as varlen  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_plain)
from repro_torch.kernels.paged_attention import kernel as paged  # noqa: E402
from repro_torch.models import DecoderLM, params_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, Request,  # noqa: E402
                                 SamplingParams)

from test_kernel_paged import make_case  # noqa: E402
from test_kernels_flash_mamba import _packed_layout  # noqa: E402
from test_torch_engine import assert_drained_clean, drain  # noqa: E402

ARCH = "h2o-danube-3-4b"
ENGINE_KW = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8,
                 max_num_batched_tokens=24, record_sample_logits=True)
_MODELS = {}


def _models(head_dim):
    """(JAX model, its params, port model, port params) of reduced danube
    at ``head_dim`` (16: the reduced default)."""
    if head_dim not in _MODELS:
        jcfg = jreduced(JARCHS[ARCH], head_dim=head_dim)
        jmodel = jbuild_model(jcfg, single_device_dist())
        jparams = jmodel.init(0)
        cfg = reduced(ARCHS[ARCH], head_dim=head_dim)
        assert cfg.attn_pattern == ("full", "swa") and \
            cfg.sliding_window == 8
        _MODELS[head_dim] = (jmodel, jparams, DecoderLM(cfg),
                             params_from_numpy(jax.tree.map(np.asarray,
                                                            jparams),
                                               cfg, "cpu"))
    return _MODELS[head_dim]


def _workload():
    return [dict(rid=f"q{i}", prompt=[(11 * i + 5 * j) % 97
                                      for j in range(10 + 9 * i)],
                 max_new_tokens=6, eos_token=None) for i in range(4)]


def _watch_tables(eng):
    """Wrap ``eng.step`` to record, per KV type, whether a running
    request's table ever held a FREED (dropped) entry."""
    dropped = {s.name: False for s in eng.mgr.specs}
    step = eng.step

    def watching():
        out = step()
        for r in eng.scheduler.running:
            for name, table in r.seq.page_tables.items():
                if SequenceState.FREED in table:
                    dropped[name] = True
        return out

    eng.step = watching
    return dropped


LEGS = [("packed", 1, dict(async_scheduling=False)),
        ("packed", 4, dict(async_scheduling=True, pipeline_depth=4)),
        ("padded", 1, dict(async_scheduling=False)),
        ("serial", 1, dict())]


@pytest.mark.parametrize("head_dim", [16, 120])
def test_swa_engines_match_jax_and_drain(monkeypatch, head_dim):
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    jmodel, jparams, model, params = _models(head_dim)
    jeng = JEngine(jmodel, JEngineConfig(attention_impl="ref", **ENGINE_KW),
                   params=jparams)
    drain(jeng, _workload(), JRequest, JSamplingParams)
    outs = {}
    for mode, depth, kw in LEGS:
        eng = Engine(model, EngineConfig(batching_mode=mode, **ENGINE_KW,
                                         **kw), params=params, device="cpu")
        assert eng.mgr.sanitizer is not None
        dropped = _watch_tables(eng)
        outs[mode, depth] = drain(eng, _workload(), Request, SamplingParams)
        assert dropped == {"full_attn": False, "swa": True}, (mode, dropped)
        assert_drained_clean(eng)
        eng.mgr.sanitizer.assert_drained()
        assert_greedy_equiv(jeng, eng, label=f"danube D{head_dim} {mode} "
                                              f"depth {depth}")
    assert outs["packed", 1] == outs["packed", 4], outs


# ---------------------------------------------------------- kernels, D 120
D = 120


@pytest.mark.parametrize("window", [0, 8])
def test_varlen_plain_d120_matches_pallas_and_ref(window):
    rng = np.random.default_rng(3)
    bh, kvh, t_, s = 4, 2, 64, 96
    q = rng.standard_normal((bh, t_, D)).astype(np.float32)
    k = rng.standard_normal((kvh, s, D)).astype(np.float32)
    v = rng.standard_normal((kvh, s, D)).astype(np.float32)
    q_seg, q_pos, kv_seg, kv_pos = _packed_layout(rng, t_, s, 3)
    meta = (q_seg, kv_seg, q_pos, kv_pos)
    ours = flash_attention_varlen_plain(
        *(torch.from_numpy(a) for a in (q, k, v) + meta), window=window)
    jq = jnp.asarray(q)
    jk, jv = (jnp.repeat(jnp.asarray(a), bh // kvh, 0) for a in (k, v))
    jm = tuple(map(jnp.asarray, meta))
    kern = flash_attention_varlen_tpu(jq, jk, jv, *jm, window=window,
                                      blk_q=32, blk_k=32, interpret=True)
    ref = flash_attention_varlen_ref(jq, jk, jv, *jm, window=window)
    valid = q_seg >= 0
    for other in (kern, ref):
        np.testing.assert_allclose(ours.numpy()[:, valid],
                                   np.asarray(other)[:, valid],
                                   atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("window", [0, 12])
def test_paged_plain_d120_matches_pallas_and_ref(window):
    case = make_case(3, 2, 4, D, 8, 5, vp=18, seed=4, window=window)
    ours = paged_decode_attention_plain(
        *(torch.from_numpy(np.array(a)) for a in case), window=window)
    for other in (jax_paged(*case, window=window, interpret=True),
                  jax_paged_ref(*case, window=window)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(other),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_dense_plain_d120_matches_pallas_ref_and_grads(causal, window):
    rng = np.random.default_rng(5)
    bh, kvh, t_ = 4, 2, 64
    q = rng.standard_normal((bh, t_, D)).astype(np.float32)
    k = rng.standard_normal((kvh, t_, D)).astype(np.float32)
    v = rng.standard_normal((kvh, t_, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    ours = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    jq = jnp.asarray(q)
    jk, jv = (jnp.repeat(jnp.asarray(a), bh // kvh, 0) for a in (k, v))
    kern = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                               blk_q=32, blk_k=32, interpret=True)
    ref = flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    for other in (kern, ref):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(other),
                                   atol=3e-5, rtol=3e-5)
    dout = rng.standard_normal((bh, t_, D)).astype(np.float32)
    grads = torch.autograd.grad(ours, (tq, tk, tv), torch.from_numpy(dout))

    def loss(a, b, c):
        return jnp.sum(flash_attention_ref(
            a, jnp.repeat(b, bh // kvh, 0), jnp.repeat(c, bh // kvh, 0),
            causal=causal, window=window) * dout)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jq, jnp.asarray(k),
                                           jnp.asarray(v))
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("d,ok", [(120, True), (96, False)])
def test_wrappers_accept_d120_and_refuse_d96(d, ok):
    i32 = dict(dtype=torch.int32)
    t_, s = 16, 24
    checks = [
        lambda: varlen.check_inputs(
            _bf16(8, t_, d), _bf16(2, s, d), _bf16(2, s, d),
            torch.zeros(t_, **i32), torch.zeros(s, **i32),
            torch.zeros(t_, **i32), torch.zeros(s, **i32), 128, 128),
        lambda: paged.check_inputs(
            _bf16(2, 2, 4, d), _bf16(5, 2, 16, 2, d),
            torch.zeros((2, 3), **i32), torch.zeros((2, 3), **i32),
            torch.zeros(2, **i32)),
        lambda: dense.check_inputs(_bf16(8, t_, d), _bf16(2, s, d),
                                   _bf16(2, s, d)),
    ]
    for check in checks:
        if ok:
            assert check()[3] == d
        else:
            with pytest.raises(ValueError, match="head dim"):
                check()


@pytest.mark.cuda
def test_cuda_kernels_d120_match_plain():
    """On the card: the three kernels at D 120 against their plain
    versions (bf16, 2e-2 as ``chip_smoke.py``'s TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    t_ = 96
    seg = torch.zeros(t_, dtype=torch.int32, device=dev)
    pos = torch.arange(t_, dtype=torch.int32, device=dev)
    q, k, v = rnd(8, t_, D), rnd(2, t_, D), rnd(2, t_, D)
    a = varlen.flash_attention_varlen(q, k, v, seg, seg, pos, pos, window=8)
    b = flash_attention_varlen_plain(q, k, v, seg, seg, pos, pos, window=8)
    assert (a.float() - b.float()).abs().max().item() <= 2e-2
    out, _ = dense.dense_flash_fwd(q, k, v, window=8)
    ref = flash_attention_plain(q, k, v, window=8)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    qd, kv = rnd(2, 2, 4, D), rnd(6, 2, 16, 2, D)
    tables = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32,
                          device=dev)
    page_pos = torch.tensor([[0, 16, 32]] * 2, dtype=torch.int32,
                            device=dev)
    positions = torch.tensor([40, 20], dtype=torch.int32, device=dev)
    a = paged.paged_decode_attention(qd, kv, tables, page_pos, positions)
    b = paged_decode_attention_plain(qd, kv, tables, page_pos, positions)
    assert (a.float() - b.float()).abs().max().item() <= 2e-2
