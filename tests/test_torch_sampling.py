"""The port's seeded temperature/top-k sampler against the reference's
(``repro.serving.sampler``, jax.random), on the CPU.

* Keys and draws: ``derive_key`` (PRNGKey(seed) folded with the rid hash,
  then the position) and the ``(V,)`` uniform draws are BITWISE equal to
  jax.random's for a grid of int32 seeds (negative ones, and ones >= 2^31
  after the int32 cast), rid hashes and positions, at V = 256 and at
  granite-3-2b's padded vocab row.
* Tokens: ``host_sample`` equals the reference's on 600 seeded rows at
  several temperatures and top-k. The log-softmax and logs are torch's,
  not XLA's, so scores may differ by ulps: a token may differ only where
  the reference's perturbed scores put a candidate within BAND_TOL of the
  band edge ``max - TIE_EPS`` (asserted, not waived).
* Top-k membership and pad-column immunity; the batched dispatch tail
  (``sample_batch``) equals ``host_sample`` row by row.
* Engines: the port's seeded trajectories are the same across packed and
  padded layouts, sync host sampling and depth-4 device sampling, and
  change with the seed; and they match the JAX engine's on reduced
  granite and qwen2.5 at temperature 0.8, top-k 5, exactly or forked at a
  near tie: at the first differing token both tokens' perturbed scores
  lie within ENGINE_FORK_TOL of their row's band edge in both packages'
  scores (TIE_FORK_TOL, the greedy fork bar on logits, over T: the
  scores are logits / T).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import TIE_FORK_TOL, make_engine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import sampler as JS  # noqa: E402
from repro_torch.serving import Request, SamplingParams  # noqa: E402
from repro_torch.serving import sampler as S  # noqa: E402

from test_torch_engine import assert_drained_clean, port_engine  # noqa: E402

GRANITE_VOCAB = 49155
# a draw may differ from the reference's only where a candidate's score is
# this close to the band edge (torch vs XLA log-softmax: a few fp32 ulps
# of scores of magnitude ~10)
BAND_TOL = 1e-5
TEMP = 0.8
ENGINE_FORK_TOL = TIE_FORK_TOL / TEMP

SEEDS = [0, 1, -1, 42, -2**31, 2**31 - 1,
         int(np.int64(2**31 + 5).astype(np.int32)),
         int(np.int64(2**32 - 1).astype(np.int32))]
RIDS = [0, S.rid_hash("r0"), 2**32 - 1]
POSITIONS = [0, 7, 100000]


def _port_key(seed, rh, pos):
    return S.derive_key(torch.tensor([seed], dtype=torch.int32),
                        torch.tensor([rh], dtype=torch.int64),
                        torch.tensor([pos], dtype=torch.int32))


def _jax_key(seed, rh, pos):
    return JS._derive_key(jnp.int32(seed), jnp.uint32(rh), jnp.int32(pos))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_uniform_draws_bitwise_equal_jax(seed):
    for rh in RIDS:
        for pos in POSITIONS:
            jk = _jax_key(seed, rh, pos)
            k = _port_key(seed, rh, pos)
            assert [int(k[0][0]), int(k[1][0])] == \
                np.asarray(jk).astype(np.int64).tolist(), (seed, rh, pos)
            for v in (256, GRANITE_VOCAB):
                ju = np.asarray(jax.random.uniform(jk, (v,), jnp.float32,
                                                   1e-7, 1.0 - 1e-7))
                u = S.uniform(k, v)[0].numpy()
                assert np.array_equal(ju.view(np.uint32),
                                      u.view(np.uint32)), (seed, rh, pos, v)


def test_prng_key_and_fold_in_match_jax():
    for seed in SEEDS:
        k = S.prng_key(torch.tensor([seed], dtype=torch.int32))
        jk = np.asarray(jax.random.PRNGKey(jnp.int32(seed)))
        assert [int(k[0][0]), int(k[1][0])] == jk.astype(np.int64).tolist()
        for data in (0, 3, 2**32 - 1):
            f = S.fold_in(k, torch.tensor([data], dtype=torch.int64))
            jf = np.asarray(jax.random.fold_in(jnp.asarray(jk),
                                               jnp.uint32(data)))
            assert [int(f[0][0]), int(f[1][0])] == \
                jf.astype(np.int64).tolist()


def _near_band_edge(row, temp, top_k, rh, pos, seed):
    """The reference's perturbed scores have a candidate within BAND_TOL
    of the band edge max - TIE_EPS: a torch-vs-XLA ulp may move it."""
    g = np.asarray(JS._perturbed_scores(
        jnp.asarray(row), jnp.float32(temp), jnp.int32(top_k),
        _jax_key(seed, rh, pos)))
    edge = g.max() - S.TIE_EPS
    return bool((np.abs(g - edge) <= BAND_TOL).any())


@pytest.mark.parametrize("temp,top_k", [(0.5, 0), (0.8, 5), (1.0, 50),
                                        (1.3, 1), (0.8, 0), (2.0, 256)])
def test_host_sample_matches_reference(temp, top_k):
    """100 rows per (T, top_k), 600 in all: equal tokens, or a reference
    candidate at the band edge."""
    rng = np.random.default_rng(int(temp * 10) + top_k)
    v, pad = 200, 56
    diff = 0
    for i in range(100):
        row = np.full((v + pad,), S.NEG, np.float32)
        row[:v] = rng.standard_normal(v) * (1 + 4 * (i % 3))
        rh, pos, seed = int(rng.integers(2**32)), i, int(rng.integers(
            -2**31, 2**31))
        ref = JS.host_sample(row, temp, top_k, rh, pos, seed)
        ours = S.host_sample(row, temp, top_k, rh, pos, seed, "cpu")
        if ours != ref:
            diff += 1
            assert _near_band_edge(row, temp, top_k, rh, pos, seed), \
                (temp, top_k, i, ours, ref)
    assert diff <= 2, diff


def test_topk_membership_and_pad_immunity():
    """Every draw stays in its row's top-k set, and -1e30 pad columns are
    never drawn, even under extreme logit magnitudes; the same (row, key)
    gives the same draw."""
    rng = np.random.default_rng(1)
    v, pad = 40, 24
    for pos in range(20):
        row = np.full((v + pad,), -1e30, np.float32)
        row[:v] = rng.standard_normal(v) * (1e4 if pos % 5 == 0 else 3.0)
        tok = S.host_sample(row, 1.2, 5, S.rid_hash("rq"), pos, 7, "cpu")
        top5 = set(np.argsort(row)[::-1][:5].tolist())
        assert tok in top5, (pos, tok, sorted(top5))
        assert tok < v
    row = rng.standard_normal(v + pad).astype(np.float32)
    a = S.host_sample(row, 0.9, 0, S.rid_hash("x"), 3, 11, "cpu")
    assert a == S.host_sample(row, 0.9, 0, S.rid_hash("x"), 3, 11, "cpu")


def test_sample_batch_matches_host_sample_and_greedy():
    """The fused tail over a batch: temperature rows draw what
    ``host_sample`` draws for the row alone, greedy rows take the band
    pick, and the board gets every token at its slot (dst -1: nowhere)."""
    rng = np.random.default_rng(2)
    n, v = 12, 300
    rows = rng.standard_normal((n, v)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 0.0] * 3, np.float32)
    top_ks = np.array([0, 5, 0, 3] * 3, np.int32)
    rhs = rng.integers(0, 2**32, n).astype(np.uint32)
    poss = np.arange(n, dtype=np.int32) * 11
    seeds = rng.integers(-2**31, 2**31, n).astype(np.int32)
    dst = np.arange(n, dtype=np.int32)
    dst[5] = -1
    board = torch.zeros(n + 1, dtype=torch.int32)
    samp = (torch.from_numpy(temps), torch.from_numpy(top_ks),
            torch.from_numpy(rhs.view(np.int32)), torch.from_numpy(poss),
            torch.from_numpy(seeds))
    toks = S.sample_batch(torch.from_numpy(rows), board,
                          torch.from_numpy(dst), samp).numpy()
    for i in range(n):
        want = (S.host_sample(rows[i], temps[i], top_ks[i], int(rhs[i]),
                              int(poss[i]), int(seeds[i]), "cpu")
                if temps[i] > 0 else S.greedy_token(rows[i]))
        assert toks[i] == want, i
    b = board.numpy()
    assert np.array_equal(b[dst[dst >= 0]], toks[dst >= 0])


# ------------------------------------------------------------- engines
PROMPTS = [[(7 * i + j) % 50 for j in range(6 + 3 * i)] for i in range(3)]


def _drain(eng, request_cls, sampling_cls, seed=42, max_new=8):
    for i, p in enumerate(PROMPTS):
        eng.submit(request_cls(rid=f"r{i}", prompt=p, sampling=sampling_cls(
            max_new_tokens=max_new, temperature=TEMP, top_k=5, seed=seed)))
    eng.run_until_done()
    return {r.rid: list(r.output) for r in eng.finished}


def test_seeded_sampling_reproducible_across_layouts_and_samplers():
    """Trajectories depend only on (seed, rid_hash, position): packed and
    padded layouts, sync host sampling and depth-4 device sampling give
    one output set; another seed changes it."""
    legs = dict(
        packed_sync=dict(batching_mode="packed", async_scheduling=False),
        padded_sync=dict(batching_mode="padded", async_scheduling=False),
        serial=dict(batching_mode="serial"),
        packed_async2=dict(batching_mode="packed", async_scheduling=True,
                           pipeline_depth=2),
        packed_async2_device=dict(batching_mode="packed",
                                  async_scheduling=True, pipeline_depth=2,
                                  device_sampling=True),
        packed_async4=dict(batching_mode="packed", async_scheduling=True,
                           pipeline_depth=4),
        padded_async4=dict(batching_mode="padded", async_scheduling=True,
                           pipeline_depth=4),
    )
    outs = {}
    for name, kw in legs.items():
        eng = port_engine(**kw)
        outs[name] = _drain(eng, Request, SamplingParams)
        assert_drained_clean(eng)
        if name.endswith("device") or name.endswith("4"):
            assert eng.device_sampling
    ref = outs["packed_sync"]
    for name, o in outs.items():
        assert o == ref, (name, o, ref)
    other = _drain(port_engine(**legs["packed_sync"]), Request,
                   SamplingParams, seed=43)
    assert other != ref


def _scores_port(row, rid, pos):
    g = S.perturbed_scores(
        torch.from_numpy(row)[None], torch.tensor([TEMP]),
        torch.tensor([5], dtype=torch.int32),
        _port_key(42, S.rid_hash(rid), pos))
    return g[0].numpy()


def _scores_jax(row, rid, pos):
    return np.asarray(JS._perturbed_scores(
        jnp.asarray(row), jnp.float32(TEMP), jnp.int32(5),
        _jax_key(42, S.rid_hash(rid), pos)))


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2.5-32b"])
def test_engine_matches_jax_sampled(arch):
    jeng, _ = make_engine(arch, record_sample_logits=True,
                          async_scheduling=False)
    ref = _drain(jeng, JRequest, JSamplingParams)
    eng = port_engine(arch, record_sample_logits=True,
                      async_scheduling=False)
    ours = _drain(eng, Request, SamplingParams)
    assert_drained_clean(eng)
    assert set(ours) == set(ref)
    prompts = {f"r{i}": p for i, p in enumerate(PROMPTS)}
    for rid, a in ref.items():
        b = ours[rid]
        i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 None)
        if i is None:
            assert len(a) == len(b), (rid, a, b)
            continue
        # the recorded rows are the unpadded vocab: the port's row is the
        # full one (v_pad == vocab on one device)
        pos = len(prompts[rid]) + i
        gj = _scores_jax(jeng.sample_log[rid][i], rid, pos)
        gp = _scores_port(eng.sample_log[rid][i], rid, pos)
        for g in (gj, gp):
            edge = g.max() - S.TIE_EPS
            assert g[a[i]] >= edge - ENGINE_FORK_TOL and \
                g[b[i]] >= edge - ENGINE_FORK_TOL, (
                    arch, rid, i, a[i], b[i], g.max(), g[a[i]], g[b[i]],
                    "fork beyond the near-tie tolerance")
