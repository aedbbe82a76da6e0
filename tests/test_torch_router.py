"""The port's router and data-parallel fleet on the CPU against the JAX
package (the scenarios of ``tests/test_router.py``).

Both packages get the same weights (the JAX init of each reduced model,
bridged by ``params_from_numpy``) and the same arrivals. Placement and
the fleet's bookkeeping are host logic over the same manager state, so
the port must place every request on the same shard with the same hit,
load and cost as JAX, and count the same ``fleet_stats``. Greedy outputs
are compared fork-aware (``assert_greedy_equiv``, TIE_FORK_TOL): a shard's
batch mix differs from the solo engine's. The port's own contracts are
bitwise: a 1-shard fleet is the solo engine, and a shard's run replays
on a standalone engine. Every fleet drains with ``check_invariants``
passing and 0 used units on every shard.
"""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

from conftest import assert_greedy_equiv, get_model  # noqa: E402
from repro.core.request import MMItem as JMMItem  # noqa: E402
from repro.serving import DPEngine as JDPEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import (BYTES_PER_UNIT, JengaKVCacheManager,  # noqa: E402
                              SequenceState, attention_spec, make_geometry,
                              mamba_spec)
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving import (ROUTE_CACHE_AWARE,  # noqa: E402
                                 ROUTE_LEAST_LOADED, ROUTE_ROUND_ROBIN,
                                 DPEngine, Engine, EngineConfig, MMItem,
                                 ModelRunner, Request, Router, RouterConfig,
                                 SamplingParams, prefix_match_tokens)

ARCHS7 = ["granite-3-2b", "h2o-danube-3-4b", "qwen2-vl-2b", "zamba2-1.2b",
          "rwkv6-3b", "whisper-tiny", "dbrx-132b"]
ECFG = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8,
            max_num_batched_tokens=64, record_sample_logits=True)
STATS = ("ticks", "finished", "steps_per_shard", "requests_per_shard",
         "readmissions", "prefix_hit_tokens", "prefix_query_tokens",
         "preemptions", "defers", "routing_costs", "handoffs",
         "handoff_pages", "role_failovers")
_PORT = {}


def port_model(arch):
    """The port's model of reduced ``arch`` with the JAX init's weights."""
    if arch not in _PORT:
        _, _, jparams = get_model(arch)
        cfg = reduced(ARCHS[arch])
        _PORT[arch] = (build_model(cfg), params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return _PORT[arch]


def fleets(arch="granite-3-2b", n=2, **kw):
    """A JAX and a port ``DPEngine`` of ``arch``, built alike (``kw``: the
    fleet's own arguments)."""
    jmodel, _, jparams = get_model(arch)
    model, params = port_model(arch)
    fkw = dict(num_shards=n, split_pool=False, **kw)
    return (JDPEngine(jmodel, JEngineConfig(**ECFG), params=jparams, **fkw),
            DPEngine(model, EngineConfig(**ECFG), params=params,
                     device="cpu", **fkw))


def port_fleet(arch="granite-3-2b", n=2, **cfg_kw):
    model, params = port_model(arch)
    kw = dict(ECFG, **cfg_kw)
    roles = kw.pop("roles", None)
    policy = kw.pop("policy", None)
    return DPEngine(model, EngineConfig(**kw), params=params, num_shards=n,
                    policy=policy, split_pool=False, roles=roles,
                    device="cpu")


def solo(arch="granite-3-2b", **cfg_kw):
    model, params = port_model(arch)
    return Engine(model, EngineConfig(**dict(ECFG, **cfg_kw)),
                  params=params, device="cpu")


def req(rid, prompt, out=4, cls=Request, sp=SamplingParams, **kw):
    return cls(rid=rid, prompt=list(prompt),
               sampling=sp(max_new_tokens=out), **kw)


def jreq(rid, prompt, out=4, **kw):
    return req(rid, prompt, out, JRequest, JSamplingParams, **kw)


def placements(dp):
    return [(p.rid, p.shard, p.hit_tokens, p.load_tokens, p.cost,
             p.readmitted) for p in dp.router.placements]


def drained_clean(dp):
    dp.check_invariants()
    for sh in dp.shards:
        stats = sh.engine.mgr.memory_stats()
        assert stats.used_units == 0, (sh.sid, stats)


def same_fleet(jdp, dp, label):
    """Port fleet == JAX fleet: placements, counters, outputs (fork-aware)."""
    assert placements(dp) == placements(jdp), label
    js, ps = jdp.fleet_stats(), dp.fleet_stats()
    assert {k: ps[k] for k in STATS} == {k: js[k] for k in STATS}, label
    assert_greedy_equiv(jdp, dp, label=label)


# ------------------------------------------------------------- placement
def _arrivals(seed=11, n=10):
    """Prompts of which some extend earlier ones (prefix hits), with a
    fleet tick after about half the arrivals."""
    rng = random.Random(seed)
    out, prompts = [], []
    for i in range(n):
        if prompts and rng.random() < 0.5:
            base = prompts[rng.randrange(len(prompts))]
            p = base + [rng.randint(0, 40) for _ in range(rng.randint(1, 6))]
        else:
            p = [rng.randint(0, 40) for _ in range(rng.randint(3, 20))]
        prompts.append(p)
        out.append((f"r{i}", p, rng.random() < 0.5))
    return out


@pytest.mark.parametrize("policy", [ROUTE_CACHE_AWARE, ROUTE_ROUND_ROBIN,
                                    ROUTE_LEAST_LOADED])
def test_place_matches_jax(policy):
    """The same arrivals, interleaved with fleet ticks, over 3 shards: the
    port places each request where JAX does (shard, hit, load, cost)."""
    jdp, dp = fleets(n=3, policy=policy)
    for fleet, mk in ((jdp, jreq), (dp, req)):
        for rid, prompt, tick in _arrivals():
            fleet.submit(mk(rid, prompt, out=3))
            if tick:
                fleet.step()
        fleet.run_until_done()
    drained_clean(dp)
    same_fleet(jdp, dp, policy)
    if policy == ROUTE_CACHE_AWARE:
        assert any(p.hit_tokens for p in dp.router.placements)


def test_place_longest_prefix_match_and_health_cost():
    """Warm shard 1's cache, then shard 2's with a longer prefix: each
    probe follows its longest match; a defer delta's cost (2 x 16 tokens)
    outweighs a tie, and quiet polls decay it."""
    dp = port_fleet(n=3)
    warm = [(3 * j + 1) % 50 for j in range(24)]
    dp.shards[1].engine.submit(req("warm", warm, out=2))
    dp.shards[1].engine.run_until_done()
    probe = req("probe", warm + [7, 8, 9])
    hits = [prefix_match_tokens(probe, sh.engine.mgr) for sh in dp.shards]
    assert hits[1] > 0 and hits[0] == 0 and hits[2] == 0, hits
    assert dp.submit(probe) == 1
    dp.shards[2].engine.submit(req("warm2", warm + [7, 8, 9, 10], out=2))
    dp.shards[2].engine.run_until_done()
    probe2 = req("probe2", warm + [7, 8, 9, 10, 11])
    assert dp.submit(probe2) == 2
    dp.run_until_done()
    drained_clean(dp)

    dp = port_fleet(n=2)
    base = dp.shards[0].engine.health_snapshot()
    dp.router.observe(0, dataclasses.replace(base, defer_count=2))
    assert dp.router.costs[0] == pytest.approx(32.0)
    assert dp.submit(req("a", [1, 2, 3])) == 1
    dp.run_until_done()
    for _ in range(40):
        dp.router.observe(0, dataclasses.replace(base, defer_count=2))
    assert dp.router.costs[0] == 0.0
    assert dp.submit(req("b", [4, 5, 6])) == 0
    with pytest.raises(AssertionError):
        Router(RouterConfig(policy="nope"))
    for sh in dp.shards:
        sh.accepting = False
    with pytest.raises(RuntimeError):
        dp.router.place(req("x", [1]), dp.shards)


# ------------------------------------------------------ fleet equivalence
def test_router1_bitwise_equals_solo():
    """A 1-shard fleet is the solo engine plus a pass-through router."""
    rng = random.Random(3)
    eng, dp = solo(), port_fleet(n=1)
    for i in range(6):
        prompt = [rng.randint(0, 49) for _ in range(rng.randint(3, 18))]
        eng.submit(req(f"r{i}", prompt))
        dp.submit(req(f"r{i}", prompt))
        eng.step()
        dp.step()
    eng.run_until_done()
    dp.run_until_done()
    drained_clean(dp)
    assert {r.rid: list(r.output) for r in eng.finished} \
        == {r.rid: list(r.output) for r in dp.finished}


def test_shard_replay_bitwise():
    """Each shard's run replays bit for bit on a standalone engine given
    the same requests at the same shard-local arrival steps."""
    rng = random.Random(17)
    dp = port_fleet(n=3)
    for i in range(9):
        dp.submit(req(f"r{i}", [rng.randint(0, 49)
                                for _ in range(rng.randint(3, 15))], out=3))
        if rng.random() < 0.6:
            dp.step()
    dp.run_until_done()
    drained_clean(dp)
    replayed = 0
    for sh in dp.shards:
        fin = sh.engine.finished
        if not fin:
            continue
        replay = solo()
        pending = sorted(fin, key=lambda r: (r.arrival, r.rid))
        guard = 0
        while pending or replay.scheduler.has_work() or replay.has_inflight:
            while pending and pending[0].arrival <= replay.step_count:
                src = pending.pop(0)
                replay.submit(req(src.rid, src.prompt,
                                  out=src.sampling.max_new_tokens))
            if not replay.scheduler.has_work() and not replay.has_inflight:
                src = pending.pop(0)
                replay.submit(req(src.rid, src.prompt,
                                  out=src.sampling.max_new_tokens))
            replay.step()
            guard += 1
            assert guard < 500
        assert {r.rid: list(r.output) for r in replay.finished} \
            == {r.rid: list(r.output) for r in fin}, sh.sid
        replayed += 1
    assert replayed >= 2


def _family_requests(arch, cfg, cls, mm_cls):
    rng = random.Random(sum(map(ord, arch)))
    out = []
    for i in range(5):
        kw = {}
        prompt = [rng.randint(0, 49) for _ in range(rng.randint(4, 16))]
        if cfg.family == "vlm" and i % 2 == 0:
            kw["mm_items"] = (mm_cls(0, min(3, len(prompt)), mm_hash=i),)
        if cfg.family == "encdec":
            kw["encoder_items"] = (mm_cls(0, cfg.encoder_seq, mm_hash=i),)
        n = rng.randint(2, 5)
        out.append(cls(rid=f"r{i}", prompt=prompt,
                       sampling=(SamplingParams if cls is Request
                                 else JSamplingParams)(max_new_tokens=n),
                       **kw))
    return out


@pytest.mark.parametrize("arch", ARCHS7)
def test_fleet_matches_solo_and_jax(arch):
    """Every family: a 3-shard fleet finishes the solo engine's requests
    with its greedy tokens (fork-aware), placing and counting as JAX's
    3-shard fleet does."""
    cfg = reduced(ARCHS[arch])
    eng = solo(arch)
    for r in _family_requests(arch, cfg, Request, MMItem):
        eng.submit(r)
    eng.run_until_done()
    jdp, dp = fleets(arch, n=3)
    for r in _family_requests(arch, cfg, JRequest, JMMItem):
        jdp.submit(r)
    for r in _family_requests(arch, cfg, Request, MMItem):
        dp.submit(r)
    jdp.run_until_done()
    dp.run_until_done()
    drained_clean(dp)
    assert len(dp.finished) == 5
    assert_greedy_equiv(eng, dp, label=f"fleet-{arch}")
    same_fleet(jdp, dp, arch)


# --------------------------------------- prefill/decode disaggregation
def _disagg_requests(seed=7, n=5):
    rng = random.Random(seed)
    return [(f"r{i}", [rng.randint(0, 49) for _ in range(rng.randint(4, 20))],
             rng.randint(2, 5)) for i in range(n)]


def _adopt_checked(dp, seen):
    """Wrap every shard runner's ``adopt_pages`` to hold each adopted page
    byte for byte against its source page right after the copy, before
    the source releases it."""
    for sh in dp.shards:
        runner = sh.engine.runner
        adopt = runner.adopt_pages

        def checked(src_runner, pairs, runner=runner, adopt=adopt):
            adopt(src_runner, pairs)
            for name, s, d in pairs:
                size = runner.mgr.spec(name).page_units
                a = src_runner.buffer[s * size:(s + 1) * size]
                b = runner.buffer[d * size:(d + 1) * size]
                assert torch.equal(a.view(torch.int16),
                                   b.view(torch.int16)), (name, s, d)
                seen.append((name, s, d))

        runner.adopt_pages = checked


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b"])
def test_disagg_matches_solo_and_jax(arch):
    """Roles prefill/decode: the decode shard computes zero prefill
    tokens, every request is handed off at its prompt boundary with the
    same handoff log as JAX's (rid, shards, tokens, pages, tick), the
    adopted pages equal their source pages byte for byte, and outputs are
    fork-aware equal to the solo engine (zamba2: attention and Mamba
    state pages both move)."""
    reqs = _disagg_requests()
    eng = solo(arch)
    for rid, prompt, out in reqs:
        eng.submit(req(rid, prompt, out))
    eng.run_until_done()
    jdp, dp = fleets(arch, n=2, roles=["prefill", "decode"])
    seen = []
    _adopt_checked(dp, seen)
    for rid, prompt, out in reqs:
        jdp.submit(jreq(rid, prompt, out))
        dp.submit(req(rid, prompt, out))
    jdp.run_until_done()
    dp.run_until_done()
    drained_clean(dp)
    assert len(dp.finished) == len(reqs)
    assert dp.handoffs == jdp.handoffs and len(dp.handoffs) == len(reqs)
    assert len(seen) == dp.fleet_stats()["handoff_pages"] > 0
    if arch == "zamba2-1.2b":
        assert {name for name, _, _ in seen} == {"full_attn", "mamba"}
    assert sum(m.prefill_tokens for m in dp.shards[1].engine.metrics) == 0
    for h in dp.handoffs:
        assert h["tokens"] == len(next(p for r, p, _ in reqs
                                       if r == h["rid"]))
    for sh in dp.shards:
        assert not sh.engine.runner._mirrors
    assert_greedy_equiv(eng, dp, label=f"disagg-{arch}")
    same_fleet(jdp, dp, f"disagg-{arch}")


def test_adopt_failure_rolls_back_and_retries():
    """The decode shard's pool refuses the first two adoptions: each
    handoff is cancelled back to its source (no page leaked on either
    side, no copy issued) and retried on a later tick; every request still
    finishes with the solo engine's tokens."""
    reqs = _disagg_requests(seed=5, n=3)
    eng = solo()
    for rid, prompt, out in reqs:
        eng.submit(req(rid, prompt, out))
    eng.run_until_done()
    dp = port_fleet(n=2, roles=["prefill", "decode"])
    seen = []
    _adopt_checked(dp, seen)
    mgr = dp.shards[1].engine.mgr
    adopt_request = mgr.adopt_request
    refused = []

    def refusing(seq, export):
        if len(refused) < 2:
            used = mgr.memory_stats().used_units
            refused.append(seq.rid)
            assert mgr.memory_stats().used_units == used
            return False, []
        return adopt_request(seq, export)

    mgr.adopt_request = refusing
    for rid, prompt, out in reqs:
        dp.submit(req(rid, prompt, out))
    dp.run_until_done()
    drained_clean(dp)
    assert len(refused) == 2
    assert len(dp.handoffs) == len(reqs)
    assert len(seen) == dp.fleet_stats()["handoff_pages"]
    assert_greedy_equiv(eng, dp, label="adopt-retry")

    # the manager-level transaction: a destination too small to hold the
    # request undoes every allocation and the source cancels its export
    specs = [attention_spec("full_attn", num_layers=2, kv_heads=1,
                            head_dim=64, tokens_per_page=4),
             mamba_spec("ssm", num_layers=2, conv_units=64, ssm_units=64,
                        checkpoint_interval=4)]
    g = make_geometry(specs, total_memory_bytes=10 ** 9)
    src, dst = (JengaKVCacheManager(specs, total_memory_bytes=n *
                                    g.large_page_units * BYTES_PER_UNIT)
                for n in (16, 1))
    r = SequenceState(rid="h1", tokens=list(range(100, 124)))
    assert src.begin_request(r)[0] and src.allocate_for_tokens(r, 24)
    src.advance(r, 24)
    export = src.export_request(r)
    r2 = SequenceState(rid="h1", tokens=list(r.tokens))
    assert dst.adopt_request(r2, export) == (False, [])
    assert dst.memory_stats().used_units == 0 and r2.num_computed == 0
    src.cancel_export(export)
    src.free_request(r, cache=False)
    assert src.memory_stats().used_units == 0
    src.check_invariants()
    dst.check_invariants()


def test_disagg_all_decode_dead_falls_back_colocated():
    """The only decode shard dies while requests await handoff: the
    prefill shard turns colocated and finishes everything exactly once."""
    rng = random.Random(23)
    reqs = [(f"r{i}", [rng.randint(0, 49) for _ in range(rng.randint(6, 16))],
             4) for i in range(4)]
    eng = solo()
    for rid, prompt, out in reqs:
        eng.submit(req(rid, prompt, out))
    eng.run_until_done()
    jdp, dp = fleets(n=2, roles=["prefill", "decode"])
    for fleet, mk in ((jdp, jreq), (dp, req)):
        for rid, prompt, out in reqs:
            fleet.submit(mk(rid, prompt, out))
        fleet.step()
        fleet.inject_crash(1)
        fleet.run_until_done()
    assert dp.fleet_stats()["role_failovers"] >= 1
    assert dp.shards[0].engine.role == "both"
    rids = [r.rid for r in dp.finished]
    assert sorted(rids) == sorted(r[0] for r in reqs)
    assert len(rids) == len(set(rids))
    drained_clean(dp)
    assert_greedy_equiv(eng, dp, label="disagg-failover")
    same_fleet(jdp, dp, "disagg-failover")


# --------------------------------------------------------------- failover
def test_crash_and_stall_failover_exactly_once():
    """A transient stall of shard 0 and a crash of shard 2 mid-run over 3
    shards: every request finishes exactly once with the solo engine's
    tokens, re-admissions are counted as JAX counts them, and every
    shard (the crashed one too) drains to 0 used units."""
    rng = random.Random(31)
    reqs = [(f"r{i}", [rng.randint(0, 49) for _ in range(rng.randint(4, 18))],
             rng.randint(3, 6)) for i in range(8)]
    eng = solo()
    for rid, prompt, out in reqs:
        eng.submit(req(rid, prompt, out))
    eng.run_until_done()
    jdp, dp = fleets(n=3, stall_escalate_ticks=4)
    for fleet, mk in ((jdp, jreq), (dp, req)):
        for rid, prompt, out in reqs[:5]:
            fleet.submit(mk(rid, prompt, out))
        fleet.step()
        fleet.inject_stall(0, resume_after=2)
        for rid, prompt, out in reqs[5:]:
            fleet.submit(mk(rid, prompt, out))
        fleet.step()
        fleet.step()
        fleet.inject_crash(2)
        fleet.run_until_done()
    rids = [r.rid for r in dp.finished]
    assert sorted(rids) == sorted(r[0] for r in reqs)
    assert len(rids) == len(set(rids))
    assert dp.fleet_stats()["readmissions"] > 0
    assert not dp.shards[2].alive
    drained_clean(dp)
    assert_greedy_equiv(eng, dp, label="failover")
    same_fleet(jdp, dp, "failover")


def test_drain_unstarted_zero_leak_and_unpoisoned():
    """A stalled shard's admitted-but-unstarted request (a prefix hit)
    moves to another shard; its pages go back to the cache unchanged, so
    the cache still serves the prefix and the moved request's output
    equals a cold solo run's."""
    dp = port_fleet(n=2, enable_prefix_caching=True)
    warm = [(3 * j + 4) % 50 for j in range(20)]
    dp.shards[0].engine.submit(req("warm", warm, out=2))
    dp.shards[0].engine.run_until_done()
    hot = req("hot", warm + [5, 6], out=4)
    assert dp.submit(hot) == 0
    dp.shards[0].engine.scheduler.schedule()
    assert hot.seq is not None and not hot.started
    moved = dp.inject_stall(0, resume_after=2)
    assert moved == [hot] and hot.shard_history == [0, 1]
    assert dp.shards[0].engine.mgr.memory_stats().used_units == 0
    dp.check_invariants()
    dp.run_until_done()
    drained_clean(dp)
    cold = solo(enable_prefix_caching=True)
    cold.submit(req("hot", warm + [5, 6], out=4))
    cold.run_until_done()
    out = {r.rid: list(r.output) for r in dp.finished}
    assert out["hot"] == list(cold.finished[0].output)
    assert prefix_match_tokens(req("p", warm + [9]),
                               dp.shards[0].engine.mgr) > 0


# ---------------------------------------------------------- handoff copy
def test_adopt_pages_copies_exact_bytes():
    """``adopt_pages`` moves whole pages of each type between two runners'
    buffers (one gather and one scatter a type), touching no other byte,
    and refuses runners on different devices."""
    model, _ = port_model("zamba2-1.2b")
    mgrs = [JengaKVCacheManager(model.kv_specs(),
                                total_memory_bytes=8 << 20)
            for _ in range(2)]
    src, dst = (ModelRunner(model, m, device="cpu") for m in mgrs)
    gen = torch.Generator().manual_seed(0)
    src.buffer.copy_(torch.randn(src.buffer.shape, generator=gen))
    before = dst.buffer.clone()
    sizes = {s.name: s.page_units for s in model.kv_specs()}
    pairs = [("full_attn", 3, 7), ("full_attn", 0, 1), ("mamba", 2, 5),
             ("mamba", 4, 0)]
    dst.adopt_pages(src, pairs)
    want = before.clone()
    for name, s, d in pairs:
        n = sizes[name]
        want[d * n:(d + 1) * n] = src.buffer[s * n:(s + 1) * n]
    assert torch.equal(dst.buffer.view(torch.int16), want.view(torch.int16))
    meta = ModelRunner(model, mgrs[0], device="meta")
    with pytest.raises(AssertionError):
        dst.adopt_pages(meta, pairs)
