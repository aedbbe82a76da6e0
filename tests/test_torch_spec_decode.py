"""The port's speculative decoding on the CPU against the JAX package.

Both packages run ``SpecDecodeEngine`` (draft and target types in one
manager, one shared buffer and token board, pipelined rounds) on the same
weights: the JAX init of each reduced model, bridged by
``params_from_numpy``. Cases:

* the reference test's pair (``tests/test_spec_decode.py``): reduced
  granite-3-2b target, reduced internlm2-1.8b draft of 2 layers with
  granite's vocab, at k 2 and 3 — the draft mostly rejects, so rounds
  roll their speculative pages back;
* the target as its own draft (granite, k 3): every proposal is accepted,
  so the next round's pre-issued chain is reused (``overlapped_rounds``);
* a reduced dbrx-132b (MoE) target;
* a 6-layer internlm2 draft, whose page (1536 units) is larger than the
  target's (1024), with an 11-token prompt in chunks of 8: the 3-token
  chunk goes into bucket 4, so one pad slot writes to the scratch page.

Tokens, ``accept_lengths``, ``overlapped_rounds`` and
``spec_rollback_pages`` must be identical, and so must every dispatch's
type, position and write page. Each dispatch's sampled token must equal
JAX's unless its input token already differed, or both packages' logits
rows place both picks within ``TIE_FORK_TOL`` of the row maximum (a
genuine near-tie). Such a fork can only happen where it cannot reach the
output: in the draft chain pre-issued for the next round, which a
rejection discards (seen in ``pair-k2``: the draft at position 15, fed
the bonus token, picks 11 in JAX and 205 in the port). The shared buffer
outside the scratch region: the same units non-zero, and every unit within
1 bf16 ulp of the buffer's largest magnitude (the written K/V bound of
``test_torch_serve_step``: deeper layers read a residual stream that
differs by roundings), except the slots written by a dispatch whose input
token forked. A pad write landing on a live page, which JAX drops, breaks
both. The pool must drain to 0 used units.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import JengaKVCacheManager as JManager  # noqa: E402
from repro.core.request import SequenceState as JSequenceState  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.tp import single_device_dist  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.runner import ModelRunner as JModelRunner  # noqa: E402
from repro.serving.spec_decode import \
    SpecDecodeConfig as JSpecDecodeConfig  # noqa: E402
from repro.serving.spec_decode import \
    SpecDecodeEngine as JSpecDecodeEngine  # noqa: E402
from conftest import TIE_FORK_TOL  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import JengaKVCacheManager  # noqa: E402
from repro_torch.core.request import SequenceState  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving import (DPEngine, Engine,  # noqa: E402
                                 EngineConfig, ModelRunner, Request,
                                 SamplingParams, SpecDecodeConfig,
                                 SpecDecodeEngine)
from test_torch_serve_step import bf16_ulp  # noqa: E402

TARGET = "granite-3-2b"
DRAFT = "internlm2-1.8b"
# name -> (target arch, draft arch or None for the target itself, draft
# layers, k, prompt length, new tokens)
CASES = {
    "pair-k2": (TARGET, DRAFT, 2, 2, 10, 12),
    "pair-k3": (TARGET, DRAFT, 2, 3, 12, 8),
    "self-draft-k3": (TARGET, None, None, 3, 13, 12),
    "moe-target-k2": ("dbrx-132b", DRAFT, 2, 2, 12, 8),
    "larger-draft-page": (TARGET, DRAFT, 6, 2, 11, 8),
}
_RUNS = {}
_JMODELS = {}      # one JAX model per config: its jitted steps are reused


def _prompt(n):
    return [(5 * j + 3) % 97 for j in range(n)]


def _configs(case):
    tarch, darch, layers, *_ = CASES[case]
    jt = jreduced(JARCHS[tarch])
    pt = reduced(ARCHS[tarch])
    if darch is None:
        return jt, jt, pt, pt
    kw = dict(num_layers=layers, vocab_size=jt.vocab_size)
    return jt, jreduced(JARCHS[darch], **kw), pt, reduced(ARCHS[darch], **kw)


def _jax_sized_like_the_port(sd):
    """Give the JAX engine's shared buffer the port's scratch page (one
    page of every type the manager holds). The reference sizes it from
    the target model alone; with a draft page that does not divide it,
    the draft's views refuse the buffer and the target runner's
    page-by-page zeroing looks up a draft type it does not own, so JAX
    cannot run that pair as it is. Only the scratch tail changes: every
    live unit sits below ``total_units`` in both."""
    total = sd.mgr.geometry.total_units
    big = math.lcm(*[s.page_units for s in sd.mgr.specs])
    sd.t_runner.buffer = jnp.zeros((1, 1, total + big), jnp.bfloat16)
    sd.d_runner.buffer = sd.t_runner.buffer
    sd._shared_state()


def _jmodel(cfg, seed, role):
    """A JAX model of ``cfg`` (one object per config and role, so that
    cases sharing it reuse its compiled steps) and its init from
    ``seed``."""
    key = (cfg, role)
    if key not in _JMODELS:
        model = jbuild_model(cfg, single_device_dist())
        _JMODELS[key] = (model, model.init(seed))
    return _JMODELS[key]


def _logged(runner, log, board):
    """Wrap ``runner.dispatch`` to log, per dispatch: the KV type, the
    first token's position and write page, its input token (host-known
    or read from the token board), and its sampled token and logits row
    (None without a sampling tail). ``board(runner)`` reads the board as
    numpy. Reading waits for the device; it changes nothing it reads."""
    dispatch = runner.dispatch

    def logging(params, prep):
        a = prep.arrs
        (name, we), = a["write_eids"].items()
        tok = int(np.asarray(a["tokens"]).reshape(-1)[0])
        if prep.tok_src is not None and prep.tok_src.reshape(-1)[0] >= 0:
            tok = int(board(runner)[prep.tok_src.reshape(-1)[0]])
        h = dispatch(params, prep)
        entry = [name, int(a["positions"].reshape(-1)[0]),
                 int(np.asarray(we).reshape(-1)[0]), tok, None, None]
        if h.tokens is not None:
            entry[4] = int(np.asarray(h.tokens)[0])
            row = np.asarray(h.logits, np.float32)[0]
            entry[5] = row[:runner.model.cfg.vocab_size]
        log.append(entry)
        return h

    runner.dispatch = logging


def _run(case):
    """Both packages' results for ``case`` (cached: a JAX run compiles)."""
    if case in _RUNS:
        return _RUNS[case]
    _, darch, _, k, n, new = CASES[case]
    jtc, jdc, ptc, pdc = _configs(case)
    jt, jtp = _jmodel(jtc, 0, "tgt")
    jd, jdp = _jmodel(jdc, 1, "draft")
    if darch is None:
        jdp = jtp
    cfg = dict(k=k, kv_pool_bytes=16 << 20, chunk_size=8)
    jsd = JSpecDecodeEngine(jt, jd, JSpecDecodeConfig(**cfg),
                            target_params=jtp, draft_params=jdp)
    if case == "larger-draft-page":
        _jax_sized_like_the_port(jsd)
    jlog, log = [], []
    for runner in (jsd.t_runner, jsd.d_runner):
        _logged(runner, jlog, lambda r: np.asarray(r._board))
    jout = jsd.generate(_prompt(n), max_new_tokens=new)

    tp = params_from_numpy(jax.tree.map(np.asarray, jtp), ptc, "cpu")
    dp = tp if darch is None else params_from_numpy(
        jax.tree.map(np.asarray, jdp), pdc, "cpu")
    sd = SpecDecodeEngine(build_model(ptc), build_model(pdc),
                          SpecDecodeConfig(**cfg), target_params=tp,
                          draft_params=dp, device="cpu")
    rounds = []
    fetch_round = sd._fetch_round

    def counted(d_handles, v_handles):
        rounds.append((len(d_handles), len(v_handles)))
        return fetch_round(d_handles, v_handles)

    sd._fetch_round = counted
    for runner in (sd.t_runner, sd.d_runner):
        _logged(runner, log, lambda r: r._board.numpy())

    def no_per_handle_fetch(*a, **kw):
        raise AssertionError("a round fetched a token handle on its own")

    sd.t_runner.fetch_tokens = sd.d_runner.fetch_tokens = \
        no_per_handle_fetch
    out = sd.generate(_prompt(n), max_new_tokens=new)
    total = sd.mgr.geometry.total_units
    _RUNS[case] = dict(
        jsd=jsd, sd=sd, jout=jout, out=out, rounds=rounds, tp=tp,
        jlog=jlog, log=log,
        jbuf=np.asarray(jsd.t_runner.buffer).reshape(-1)[:total],
        buf=sd.t_runner.buffer[:total].clone())
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_spec_decode_matches_jax(case):
    r = _run(case)
    jsd, sd = r["jsd"], r["sd"]
    assert r["out"] == r["jout"]
    assert sd.accept_lengths == jsd.accept_lengths
    assert sd.overlapped_rounds == jsd.overlapped_rounds
    assert sd.spec_rollback_pages == jsd.spec_rollback_pages
    k = sd.cfg.k
    assert r["rounds"] == [(k, k + 1)] * len(sd.accept_lengths)
    if case == "self-draft-k3":
        assert sd.overlapped_rounds > 0 and \
            set(sd.accept_lengths) == {k}
    else:
        assert sd.spec_rollback_pages > 0
    assert len(r["log"]) == len(r["jlog"])
    forked = np.zeros(r["buf"].numel(), bool)
    for (jname, jpos, jeid, jin, jtok, jrow), (name, pos, eid, tin, tok,
                                               row) in zip(r["jlog"],
                                                           r["log"]):
        assert (name, pos, eid) == (jname, jpos, jeid)
        if tin != jin:          # downstream of a fork: its slot differs
            spec = sd.mgr.spec(name)
            rows = spec.page_units // (2 * spec.num_layers *
                                       spec.tokens_per_page)
            for slot in range(pos % spec.tokens_per_page,
                              spec.page_units // rows, spec.tokens_per_page):
                off = eid * spec.page_units + slot * rows
                forked[off:off + rows] = True
        elif tok != jtok:
            gaps = (jrow.max() - jrow[tok], row.max() - row[jtok])
            assert max(gaps) <= TIE_FORK_TOL, (case, pos, jtok, tok, gaps)
    ours = r["buf"].float().numpy()
    ref = r["jbuf"].astype(np.float32)
    assert np.array_equal(ours != 0, ref != 0)
    keep = ~forked
    assert np.abs(ours - ref)[keep].max() <= \
        bf16_ulp(np.abs(ref).max())
    stats = sd.mgr.memory_stats()
    assert stats.used_units == 0, f"leaked referenced pages: {stats}"
    sd.mgr.check_invariants()


def test_spec_decode_equals_the_ports_plain_engine():
    """Greedy speculative decoding emits the target's own greedy
    trajectory: the port's plain ``Engine`` on the same weights, chunk
    size and prompt, prefix caching off."""
    for case in ("pair-k3", "moe-target-k2"):
        r = _run(case)
        tarch, _, _, _, n, new = CASES[case]
        eng = Engine(build_model(reduced(ARCHS[tarch])),
                     EngineConfig(kv_pool_bytes=8 << 20, chunk_size=8,
                                  enable_prefix_caching=False),
                     params=r["tp"], device="cpu")
        eng.submit(Request(rid="ref", prompt=_prompt(n),
                           sampling=SamplingParams(max_new_tokens=new)))
        eng.run_until_done()
        assert r["out"] == eng.finished[0].output, case


def test_scratch_page_is_a_page_of_every_type():
    """The shared buffer's scratch page (where dropped writes land: every
    type's view puts it at ``vp - 1``) lies past every real page of every
    type. The parent commit sized it from the runner's own model (1024
    units for the granite target); the 6-layer draft's 1536-unit view
    then refused the 8,387,584-unit buffer, so ``larger-draft-page``
    above failed there."""
    _, _, ptc, pdc = _configs("larger-draft-page")
    tm, dm = build_model(ptc), build_model(pdc)
    tm.kv_prefix, dm.kv_prefix = "tgt_", "draft_"
    mgr = JengaKVCacheManager(tuple(tm.kv_specs()) + tuple(dm.kv_specs()),
                              total_memory_bytes=16 << 20,
                              enable_prefix_caching=False)
    sizes = {s.name: s.page_units for s in mgr.specs}
    assert sizes == {"tgt_full_attn": 1024, "draft_full_attn": 1536}
    t = ModelRunner(tm, mgr, device="cpu")
    d = ModelRunner(dm, mgr, device="cpu", buffer=t.buffer)
    assert d.buffer is t.buffer
    total = mgr.geometry.total_units
    assert t.buffer.numel() == total + 3072
    for size in sizes.values():
        vp = t.buffer.numel() // size
        assert vp * size == t.buffer.numel()
        assert (vp - 1) * size >= total
    with pytest.raises(AssertionError):
        ModelRunner(dm, mgr, device="cpu", buffer=t.buffer[:total])


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """``SpecDecodeEngine`` and ``DPEngine`` default to ``"cuda"``: without
    a card they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, ptc, pdc = _configs("pair-k2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpecDecodeEngine(build_model(ptc), build_model(pdc),
                         SpecDecodeConfig(kv_pool_bytes=1 << 20))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DPEngine(build_model(ptc), EngineConfig(kv_pool_bytes=1 << 20),
                 num_shards=2)


def _runner_pair():
    """A JAX and a port runner of reduced granite on managers driven the
    same way, with the same weights."""
    jcfg = jreduced(JARCHS[TARGET])
    jmodel = jbuild_model(jcfg, single_device_dist())
    jparams = jmodel.init(0)
    cfg = reduced(ARCHS[TARGET])
    model = build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jmgr = JManager(jmodel.kv_specs(), total_memory_bytes=8 << 20,
                    enable_prefix_caching=False)
    mgr = JengaKVCacheManager(model.kv_specs(), total_memory_bytes=8 << 20,
                              enable_prefix_caching=False)
    return (JModelRunner(jmodel, jmgr), jparams, JRequest, JSequenceState), \
        (ModelRunner(model, mgr, device="cpu"), params, Request,
         SequenceState)


def test_build_plan_and_run_plan_match_jax():
    """``build_plan`` uploads the same batch as JAX's, field by field, and
    ``run_plan`` (a prefill chunk each for two requests, then a mixed step
    of a decode and a continuing chunk) gives the same logits within the
    serve-step tolerance and writes the same pages."""
    prompts = [_prompt(11), [(7 * j + 1) % 97 for j in range(19)]]
    plans = [[(0, 8), (1, 8)], [(0, 3), (1, 11)], [(0, 1), (1, 1)]]
    results = []
    for runner, params, req_cls, seq_cls in _runner_pair():
        reqs = []
        for i, p in enumerate(prompts):
            req = req_cls(rid=f"r{i}", prompt=list(p))
            req.seq = seq_cls(rid=f"r{i}", tokens=list(p))
            assert runner.mgr.begin_request(req.seq)[0]
            reqs.append(req)
        batches, logits = [], []
        for plan in plans:
            items = [(reqs[i], n) for i, n in plan]
            for req, n in items:
                seq = req.seq
                if seq.num_computed + n > len(seq.tokens):
                    seq.append_token(len(seq.tokens) % 97)
                assert runner.mgr.allocate_for_tokens(
                    seq, seq.num_computed + n)
            batches.append(runner.build_plan(items))
            logits.append(runner.run_plan(params, items))
            for req, n in items:
                runner.mgr.advance(req.seq, n)
        results.append((batches, logits, runner))
    (jb, jl, jr), (pb, pl, pr) = results
    for (jbatch, jinfo), (batch, info) in zip(jb, pb):
        assert jinfo["key"] == info["key"]
        for f in ("tokens", "positions", "seg_ids", "chunk_start",
                  "seg_start_tok", "seg_last_tok", "seq_lens", "tables",
                  "page_pos", "page_seg", "write_eids"):
            a, b = getattr(jbatch, f), getattr(batch, f)
            if isinstance(a, dict):
                assert a.keys() == b.keys(), f
                for key in a:
                    np.testing.assert_array_equal(np.asarray(a[key]),
                                                  b[key].numpy(), f)
            else:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), f)
    for a, b in zip(jl, pl):
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 2e-2
    total = pr.mgr.geometry.total_units
    ours = pr.buffer[:total].float().numpy()
    ref = np.asarray(jr.buffer).reshape(-1)[:total].astype(np.float32)
    assert np.array_equal(ours != 0, ref != 0)
    assert np.abs(ours - ref).max() <= bf16_ulp(np.abs(ref).max())
