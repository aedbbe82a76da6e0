"""The port's ``Engine`` on the CPU against the JAX ``Engine``.

Same weights (the JAX init through the bridge), the scenarios of
``conftest.make_engine``. Greedy outputs must be fork-aware equal to JAX
(``assert_greedy_equiv``: exact until a divergence, which must be a genuine
near-tie, TIE_FORK_TOL, in both packages' fp32 rows); the port's own
pipeline depths 1, 2 and 4 must be bitwise equal; the pool must drain with
``check_invariants`` passing and no referenced page left.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

from conftest import assert_greedy_equiv, get_model, make_engine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_varlen, flash_attention_varlen_plain)
from repro_torch.kernels.flash_attention.kernel import check_inputs  # noqa: E402
from repro_torch.models import blocks_attn  # noqa: E402
from repro_torch.models import (DecoderLM, build_model,  # noqa: E402
                                params_from_numpy)
from repro_torch.serving import (Engine, EngineConfig, Request,  # noqa: E402
                                 SamplingParams)

_PORT = {}
DEPTHS = [(1, dict(async_scheduling=False)),
          (2, dict(async_scheduling=True, pipeline_depth=2)),
          (4, dict(async_scheduling=True, pipeline_depth=4))]


def port_engine(arch="granite-3-2b", **cfg_kw):
    """The port's twin of ``conftest.make_engine`` on the CPU, with the
    JAX init's weights."""
    if arch not in _PORT:
        _, _, jparams = get_model(arch)
        cfg = reduced(ARCHS[arch])
        _PORT[arch] = (DecoderLM(cfg), params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    model, params = _PORT[arch]
    kw = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8)
    kw.update(cfg_kw)
    return Engine(model, EngineConfig(**kw), params=params, device="cpu")


def workload(n=3, max_new=6, eos=None):
    return [dict(rid=f"r{i}", prompt=[(7 * i + j) % 50
                                      for j in range(6 + 3 * i)],
                 max_new_tokens=max_new,
                 eos_token=(eos or {}).get(f"r{i}")) for i in range(n)]


def drain(eng, reqs, request_cls, sampling_cls):
    for r in reqs:
        eng.submit(request_cls(rid=r["rid"], prompt=r["prompt"],
                               sampling=sampling_cls(
                                   max_new_tokens=r["max_new_tokens"],
                                   eos_token=r["eos_token"])))
    eng.run_until_done()
    return {r.rid: list(r.output) for r in eng.finished}


def assert_drained_clean(eng):
    eng.mgr.check_invariants()
    stats = eng.mgr.memory_stats()
    assert stats.used_units == 0, f"leaked referenced pages: {stats}"


@pytest.mark.parametrize("arch", ["granite-3-2b", "internlm2-1.8b",
                                  "qwen2.5-32b"])
def test_engine_matches_jax_and_depths_bitwise(arch):
    reqs = workload()
    jeng, _ = make_engine(arch, record_sample_logits=True)
    drain(jeng, reqs, JRequest, JSamplingParams)
    outs, engs = {}, {}
    for depth, kw in DEPTHS:
        eng = port_engine(arch, record_sample_logits=True, **kw)
        launches = flash_attention_varlen.launches
        outs[depth] = drain(eng, reqs, Request, SamplingParams)
        assert flash_attention_varlen.launches == launches   # CPU: plain
        assert_drained_clean(eng)
        engs[depth] = eng
    assert outs[1] == outs[2] == outs[4], outs
    assert engs[4].device_sampling and not engs[2].device_sampling
    assert_greedy_equiv(jeng, engs[1], label=arch)


def test_engine_mixed_budget_long_prompts_match_jax():
    """Longer prompts under a token budget that packs prefill chunks with
    decodes: several chunks per request, old pages on every step."""
    reqs = [dict(rid=f"q{i}", prompt=[(11 * i + 5 * j) % 97
                                      for j in range(20 + 9 * i)],
                 max_new_tokens=5, eos_token=None) for i in range(4)]
    kw = dict(max_num_batched_tokens=24, record_sample_logits=True)
    jeng, _ = make_engine("granite-3-2b", **kw)
    drain(jeng, reqs, JRequest, JSamplingParams)
    eng = port_engine("granite-3-2b", async_scheduling=True,
                      pipeline_depth=4, **kw)
    drain(eng, reqs, Request, SamplingParams)
    assert_drained_clean(eng)
    assert_greedy_equiv(jeng, eng, label="mixed-budget")


def test_eos_in_deep_ring_rolls_back_and_drains_clean(monkeypatch):
    """EOS found while up to 3 speculative steps are queued (depth 4):
    every such segment is killed, its pages rolled back, and the pool
    drains fully — with PageSan checking every dispatch."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    probe = port_engine(enable_prefix_caching=False)
    ref = drain(probe, workload(n=4, max_new=10), Request, SamplingParams)
    eos = {rid: out[len(out) // 2] for rid, out in ref.items()
           if len(out) > 2}
    assert eos
    eng = port_engine(async_scheduling=True, pipeline_depth=4,
                      enable_prefix_caching=False)
    assert eng.mgr.sanitizer is not None
    outs = drain(eng, workload(n=4, max_new=10, eos=eos), Request,
                 SamplingParams)
    for rid, out in outs.items():
        if rid in eos:
            cut = ref[rid].index(eos[rid]) + 1
            assert out == ref[rid][:cut], (rid, out, ref[rid])
    assert eng.spec_kills >= 1
    assert_drained_clean(eng)
    eng.mgr.sanitizer.assert_drained()
    stats = eng.mgr.memory_stats()
    assert stats.free_units == stats.total_units, stats


def test_main_path_feeds_the_kernel_valid_inputs(monkeypatch):
    """Every attention call of the served main path passes the CUDA
    wrapper's input checks (dtype, shape, contiguity, alignment) — the
    checks a CUDA tensor meets before its launch — once per layer of every
    dispatch, at every pipeline depth."""
    calls = []

    def spy(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, window=0, blk_q=128,
            blk_k=128, kv_tiles=None):
        assert kv_tiles is not None        # the step's skip metadata
        check_inputs(q, k, v, q_seg, kv_seg, q_pos, kv_pos, blk_q, blk_k,
                     kv_tiles)
        calls.append(q.shape)
        return flash_attention_varlen_plain(q, k, v, q_seg, kv_seg, q_pos,
                                            kv_pos, window=window)

    monkeypatch.setattr(blocks_attn, "flash_attention_varlen", spy)
    for depth, kw in DEPTHS:
        calls.clear()
        eng = port_engine(max_num_batched_tokens=24, **kw)
        drain(eng, workload(n=4), Request, SamplingParams)
        assert len(calls) == eng.runner.dispatch_count * \
            eng.model.cfg.num_layers, depth


def test_later_slices_raise():
    for mode in ("padded", "serial"):        # ported: they construct
        assert port_engine(batching_mode=mode).cfg.batching_mode == mode
    # budget autotuning is ported: it constructs; training is ported for
    # every family (fp32 masters, a scalar loss)
    assert port_engine(autotune_budgets=True).autotuner is not None
    hybrid = build_model(reduced(ARCHS["zamba2-1.2b"]))
    masters = hybrid.init(0, "cpu", master=True)
    assert masters["mamba_main"]["w_z"].dtype == torch.float32
    tok = torch.zeros((1, 8), dtype=torch.int32)
    for arch, leaf in (("rwkv6-3b", ("layers", "w_r")),
                       ("whisper-tiny", ("enc", "mlp", "w1"))):
        later = build_model(reduced(ARCHS[arch]))
        masters = later.init(0, "cpu", master=True)
        w = masters
        for key in leaf:
            w = w[key]
        assert w.dtype == torch.float32
        kw = {} if arch == "rwkv6-3b" else dict(enc_embeds=torch.zeros(
            (1, later.cfg.encoder_seq, later.cfg.d_model)))
        loss = later.train_loss(masters, tok, tok, **kw)
        assert loss.shape == () and bool(torch.isfinite(loss))
    eng = port_engine()
    # seeded temperature/top-k sampling is ported: it serves
    eng.submit(Request(rid="t", prompt=[1, 2, 3],
                       sampling=SamplingParams(temperature=0.7,
                                               max_new_tokens=2)))
    assert [len(r.output) for r in eng.run_until_done()] == [2]
    with pytest.raises(NotImplementedError):
        DecoderLM(reduced(ARCHS["rwkv6-3b"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Engine(eng.model, EngineConfig(), params=eng.params)
