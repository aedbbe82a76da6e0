"""The port's MoE family on the CPU against the JAX package.

Models: reduced dbrx-132b (E 4, top-2) and reduced qwen3-moe-235b-a22b
with 16 experts, top-8, both with the JAX init's weights (bridged by
``params_from_numpy``).

* ``moe_block`` against JAX's ``moe_block`` (under ``shard_map`` on the
  one-device mesh: its all_to_all and psum name mesh axes) at capacity
  factors 1.25 and 0.5, on a plain stream, a stream with mid-stream pad
  rows and a killed segment, and one whose ``N * K / E * cf`` ends in .5.
  The set of dropped (token, k) copies must equal a numpy oracle of the
  reference's rule; the top-k sets must equal JAX's except at an asserted
  router near-tie (the K-th and (K+1)-th probabilities within 1e-6);
  outputs within 1 bf16 ulp of the block's largest output (h and y are
  rounded to bf16 after fp32 sums that another library may order
  otherwise; an output near zero is a cancellation, so an elementwise
  ulp would be no bound; measured equal). The expert weights
  are scaled up and the residual down so that the MoE term, not the
  residual, sets the output.
* Packed and padded ``serve_step`` logits and written K/V against JAX's
  with the dense serve-step tolerances (``test_torch_serve_step``).
* Engines: packed at depths 1/2/4, padded and serial against the JAX
  engine in the same mode (``assert_greedy_equiv``) under PageSan with no
  leaked page, a seeded run (temperature 0.8, top-k 5, seed 42), and the
  reference's
  own depths when requests finish at different steps: a finished
  request's rows already dispatched deeper in the ring still take expert
  capacity (and a killed row a queue place) ahead of later tokens, so
  the reference's depths 1 and 4 differ there. The port's depths are held
  to JAX's depth for depth.
* The varlen and paged CUDA wrappers' checks take G 6 and G 16 (no
  launch: the kernels run on the card only).
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
from repro.models import blocks_attn as JBA  # noqa: E402
from repro.models.common import rms_norm as jrms_norm  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.tp import shard_map, single_device_dist  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_varlen  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    check_inputs as varlen_check  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    varlen_kv_tiles  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_plan)
from repro_torch.kernels.paged_attention.kernel import \
    check_inputs as paged_check  # noqa: E402
from repro_torch.models import (DecoderLM, blocks_attn,  # noqa: E402
                                build_model, params_from_numpy)
from repro_torch.models.attention import view_offset  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, Request,  # noqa: E402
                                 SamplingParams)

from repro_torch.serving import sampler as S  # noqa: E402
from test_torch_engine import DEPTHS, assert_drained_clean, drain  # noqa: E402
from test_torch_paged import _rows_case  # noqa: E402
from test_torch_sampling import (ENGINE_FORK_TOL, PROMPTS,  # noqa: E402
                                 _scores_jax, _scores_port)
from test_torch_sampling import _drain as sdrain  # noqa: E402
from test_torch_serve_step import (bf16_ulp, to_batch,  # noqa: E402
                                   written_units)

# name -> (arch, reduced overrides)
MOE = {"dbrx": ("dbrx-132b", {}),
       "qwen3": ("qwen3-moe-235b-a22b",
                 dict(num_experts=16, experts_per_token=8))}
_JAX, _PORT = {}, {}


def _key(name, ov):
    return (name, tuple(sorted(ov.items())))


def jax_model(name, **ov):
    """(model, cfg, params) of the JAX package for a reduced MoE config."""
    arch, base = MOE[name]
    k = _key(name, ov)
    if k not in _JAX:
        cfg = jreduced(JARCHS[arch], **base, **ov)
        model = jbuild_model(cfg, single_device_dist())
        _JAX[k] = (model, cfg, model.init(0))
    return _JAX[k]


def port_model(name, **ov):
    """(DecoderLM, params) of the port with the JAX init's weights."""
    arch, base = MOE[name]
    k = _key(name, ov)
    if k not in _PORT:
        _, _, jparams = jax_model(name, **ov)
        cfg = reduced(ARCHS[arch], **base, **ov)
        _PORT[k] = (DecoderLM(cfg), params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return _PORT[k]


ENGINE_KW = dict(kv_pool_bytes=8 << 20, max_running=4, chunk_size=8)


def jax_engine(name, ov=None, **kw):
    model, _, params = jax_model(name, **(ov or {}))
    return JEngine(model, JEngineConfig(**dict(ENGINE_KW, **kw)),
                   params=params)


def port_engine(name, ov=None, **kw):
    model, params = port_model(name, **(ov or {}))
    return Engine(model, EngineConfig(**dict(ENGINE_KW, **kw)),
                  params=params, device="cpu")


def jrun(fn, *args, **kw):
    """A JAX block under ``shard_map`` on the one-device mesh."""
    dist = single_device_dist()
    spec = jax.sharding.PartitionSpec()
    body = shard_map(lambda *a: fn(*a, dist=dist, **kw), mesh=dist.mesh,
                     in_specs=(spec,) * len(args), out_specs=spec)
    return jax.jit(body)(*args)


# ---------------------------------------------------------------- block
def _layer(name, scale=8.0):
    """Layer 0's JAX leaves (tp dim squeezed) with the router and expert
    weights scaled by ``scale``, and the port's copy of the same values."""
    model, cfg, jparams = jax_model(name)
    sq = model._squeeze_params(jparams)["layers"]
    jl = {k: v[0] * (scale if k == "router" or k.startswith("moe_") else 1)
          for k, v in sq.items()}
    pl = {k: tensor_from_numpy(np.asarray(v)) for k, v in jl.items()}
    pl = {k: v.to(torch.bfloat16 if k.startswith("moe_") else torch.float32)
          for k, v in pl.items()}
    return cfg, jl, pl


def _stream(kind, n_half, d, seed):
    """(B, T, d) bf16 block inputs, the residual at 1e-3 so the MoE term
    sets the output, and the rows that are pads or a killed segment (all
    the same row: pad tokens carry token 0). ``half``: one row of
    ``n_half`` tokens."""
    rng = np.random.default_rng(seed)
    if kind == "plain":
        x = rng.standard_normal((2, 24, d))
        dead = []
    elif kind == "pads":
        x = rng.standard_normal((1, 40, d))
        dead = list(range(6, 14)) + list(range(34, 40))   # killed; bucket pads
        x[0, dead] = rng.standard_normal(d)
    else:
        x = rng.standard_normal((1, n_half, d))
        dead = []
    x = jnp.asarray(1e-3 * x.astype(np.float32), jnp.bfloat16)
    return x, dead


def drop_oracle(idx, n_experts, cap):
    """The reference's rule in numpy: walk the (token, k) copies in
    token-major order; a copy whose expert already holds ``cap`` is
    dropped. Returns the dropped (N, K) mask."""
    count = np.zeros(n_experts, np.int64)
    dropped = np.zeros(idx.shape, bool)
    for tkn in range(idx.shape[0]):
        for k in range(idx.shape[1]):
            e = idx[tkn, k]
            dropped[tkn, k] = count[e] >= cap
            count[e] += 1
    return dropped


# (n, K, E, cf) -> cap: N * K / E * cf = 12.5 and 2.5 round half to even
HALF = {1.25: (20, 12), 0.5: (10, 2)}


@pytest.mark.parametrize("kind", ["plain", "pads", "half"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("name", list(MOE))
def test_moe_block_matches_jax_and_drops_the_reference_copies(name, cf,
                                                              kind):
    cfg, jl, pl = _layer(name)
    e, k = cfg.num_experts, cfg.experts_per_token
    x, dead = _stream(kind, HALF[cf][0], cfg.d_model, seed=len(kind))
    b, t, d = x.shape
    n = b * t

    # routing: the port's against the reference's softmax + top_k
    xn = jrms_norm(x, jl["mlp_norm"], cfg.norm_eps).reshape(n, d)
    jprobs = np.asarray(jax.nn.softmax(jnp.einsum(
        "nd,de->ne", xn.astype(jnp.float32), jl["router"].astype(
            jnp.float32)), axis=-1))
    _, jidx = jax.lax.top_k(jnp.asarray(jprobs), k)
    jidx = np.asarray(jidx)
    xt = tensor_from_numpy(np.asarray(x))
    tok = rms_norm(xt, pl["mlp_norm"], cfg.norm_eps).reshape(n, d)
    gates, idx, slot, cap = blocks_attn.moe_route(
        tok, pl["router"], num_experts=e, top_k=k, capacity_factor=cf)
    idx = idx.numpy()
    assert cap == int(max(1, round(n * k / e * cf)))
    if kind == "half":
        assert n * k / e * cf % 1 == 0.5 and cap == HALF[cf][1]
    differs = [i for i in range(n) if set(idx[i]) != set(jidx[i])]
    for i in differs:
        srt = np.sort(jprobs[i])[::-1]
        assert srt[k - 1] - srt[k] < 1e-6, (i, srt[k - 1], srt[k])
    first = differs[0] if differs else n     # queues agree before it

    # drops: the port's slots against the numpy oracle of the rule
    dropped = (slot.numpy() == e * cap).reshape(n, k)
    np.testing.assert_array_equal(dropped, drop_oracle(idx, e, cap))
    kept_place = slot.numpy().reshape(n, k)
    for i in range(n):
        for j in range(k):
            if not dropped[i, j]:
                assert kept_place[i, j] // cap == idx[i, j]
    if cf == 0.5:
        assert dropped.any()
    if kind == "pads" and cf == 0.5:
        # the killed segment takes queue places: without it, a later real
        # token would keep a copy that it loses here
        live = np.array([i not in dead for i in range(n)])
        alone = drop_oracle(idx[live], e, cap)
        later = live & (np.arange(n) > 13)          # after the killed rows
        assert (dropped[live] != alone)[later[live]].any()

    # outputs
    ref, _ = jrun(JBA.moe_block, jl, x, num_experts=e, top_k=k,
                  capacity_factor=cf, norm_eps=cfg.norm_eps)
    drops = []
    ours = blocks_attn.moe_block(pl, xt, num_experts=e, top_k=k,
                                 capacity_factor=cf, norm_eps=cfg.norm_eps,
                                 drops=drops)
    assert int(drops[0]) == int(dropped.sum())
    a = ours.float().numpy().reshape(n, d)[:first]
    r = np.asarray(ref, np.float32).reshape(n, d)[:first]
    assert np.abs(a - r).max() <= bf16_ulp(np.abs(r).max())
    # a token with every copy dropped passes its residual through exactly
    xs = np.asarray(x, np.float32).reshape(n, d)
    gone = dropped.all(1)[:first]
    assert np.array_equal(a[gone], xs[:first][gone])
    assert np.abs(a - xs[:first]).max() > 10 * np.abs(xs).max()


def test_top_k_breaks_exact_ties_toward_the_lower_index():
    """``jax.lax.top_k`` keeps the lower index among equal values;
    ``moe_top_k`` (a stable descending sort) does the same, also through
    a whole ``moe_block`` whose router has two equal columns."""
    rng = np.random.default_rng(3)
    probs = rng.choice(np.float32([0.1, 0.2, 0.3]), size=(64, 16))
    for k in (1, 2, 4, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = blocks_attn.moe_top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    cfg, jl, pl = _layer("dbrx")
    router = np.asarray(jl["router"]).copy()
    router[:, 2] = router[:, 0]            # experts 0 and 2 tie on every row
    jl = dict(jl, router=jnp.asarray(router))
    pl = dict(pl, router=torch.from_numpy(router))
    x, _ = _stream("plain", 0, cfg.d_model, seed=4)
    ref, _ = jrun(JBA.moe_block, jl, x, num_experts=4, top_k=2,
                  capacity_factor=1.25, norm_eps=cfg.norm_eps)
    xt = tensor_from_numpy(np.asarray(x))
    tok = rms_norm(xt, pl["mlp_norm"], cfg.norm_eps).reshape(-1, 64)
    _, idx, _, _ = blocks_attn.moe_route(tok, pl["router"], num_experts=4,
                                         top_k=2, capacity_factor=1.25)
    # the tied pair at the top-2 boundary: expert 0 is kept, 2 left out
    rows = [set(r) for r in idx.numpy().tolist()]
    assert any(0 in r and 2 not in r for r in rows)
    assert not any(2 in r and 0 not in r for r in rows)
    ours = blocks_attn.moe_block(pl, xt, num_experts=4, top_k=2,
                                 capacity_factor=1.25, norm_eps=cfg.norm_eps)
    r = np.asarray(ref, np.float32)
    assert np.abs(ours.float().numpy() - r).max() <= bf16_ulp(np.abs(r).max())


def test_kernel_wrappers_accept_the_new_group_sizes():
    """The CUDA wrappers' checks (made before every launch) take the MoE
    and VLM configs' GQA groups in the serve path's layouts: varlen at
    G 6 (dbrx, qwen2-vl) and G 16 (qwen3-moe) on token-major views, paged
    decode at G 6 and G 16 (its largest) with the step's plan; G 17 is
    refused by the paged kernel. No launch: there is no card here."""
    rng = np.random.default_rng(5)
    t_, s = 32, 96
    for h, kvl in ((12, 2), (48, 8), (64, 4)):
        q = torch.zeros(t_, h, 128, dtype=torch.bfloat16).transpose(0, 1)
        k, v = (torch.zeros(s, kvl, 128, dtype=torch.bfloat16).transpose(
            0, 1) for _ in range(2))
        meta = [torch.from_numpy(a) for a in (
            np.zeros(t_, np.int32), np.zeros(s, np.int32),
            np.arange(s - t_, s, dtype=np.int32),
            np.arange(s, dtype=np.int32))]
        tiles = varlen_kv_tiles(meta[1], meta[3])
        assert varlen_check(q, k, v, *meta, 128, 128, tiles) == \
            (h, t_, s, 128, h // kvl)
    lens = [int(n) for n in rng.integers(20, 200, 4)]
    for g, kvl in ((6, 8), (6, 2), (16, 4), (17, 1)):
        q, kv, tables, page_pos, positions = _rows_case(
            lens, 16, 16, seed=g, kvl=kvl, g=g, d=128)
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            q, kv, tables, page_pos, positions)]
        args[0], args[1] = args[0].bfloat16(), args[1].bfloat16()
        plan = paged_decode_plan(*args[2:], 16)
        if g > 16:
            with pytest.raises(ValueError):
                paged_check(*args, plan=plan)
        else:
            assert paged_check(*args, plan=plan)[:4] == (4, kvl, g, 128)


# ---------------------------------------------------------------- model
def test_build_model_params_and_init():
    """``build_model`` returns a ``DecoderLM`` for both MoE configs; the
    bridged tree and the port's seeded init have the same leaves, shapes
    and dtypes (router fp32, experts bf16, no dense MLP); MoE trains
    from fp32 masters (``test_torch_train_moe_vlm.py`` holds it to
    JAX)."""
    for name, (arch, ov) in MOE.items():
        cfg = reduced(ARCHS[arch], **ov)
        model = build_model(cfg)
        assert isinstance(model, DecoderLM) and model.is_moe
        _, bridged = port_model(name)
        own = model.init(seed=0, device="cpu")
        flat = jax.tree_util.tree_flatten_with_path
        a, b = flat(own)[0], flat(bridged)[0]
        assert [k for k, _ in a] == [k for k, _ in b]
        for (k, x), (_, y) in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype, k
        lay = own["layers"]
        assert "gate" not in lay and lay["router"].dtype == torch.float32
        assert lay["moe_gate"].shape == (cfg.num_layers, cfg.num_experts,
                                         cfg.d_model, cfg.moe_d_ff)
        assert lay["moe_down"].dtype == torch.bfloat16
        # moe_down drawn at 0.02 / sqrt(2L), the others at 0.02
        ratio = float(lay["moe_down"].float().std() /
                      lay["moe_gate"].float().std())
        assert abs(ratio - (2 * cfg.num_layers) ** -0.5) < 0.05
        tok = torch.arange(16, dtype=torch.int32).reshape(2, 8)
        loss = model.train_loss(model.init(0, "cpu", master=True), tok, tok)
        assert loss.dtype == torch.float32 and torch.isfinite(loss)


# ---------------------------------------------------------- serve step
def _jax_step(name, packed, steps, lens=(13, 6, 45), **kw):
    """A JAX engine advanced ``steps`` steps; the next plan's
    PreparedStep, the buffer before and after JAX's dispatch of it, and
    JAX's logits."""
    eng = jax_engine(name, batching_mode="packed" if packed else "padded",
                     **kw)
    for i, n in enumerate(lens):
        eng.submit(JRequest(rid=f"r{i}",
                            prompt=[(5 * i + 3 * j) % 97 for j in range(n)],
                            sampling=JSamplingParams(max_new_tokens=8)))
    for _ in range(steps):
        eng.step()
    plan = eng.scheduler.schedule()
    prep = eng.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled], packed=packed)
    eng.runner.zero_pages(eng.mgr.drain_fresh_pages())
    buf0 = np.array(eng.runner.buffer).reshape(-1)
    jlogits = eng.runner.fetch(eng.runner.dispatch(eng.params, prep),
                               prep.n)
    return plan, prep, buf0, jlogits, np.asarray(
        eng.runner.buffer).reshape(-1)


# a token whose K-th and (K+1)-th router logits at some layer are this
# close may route differently from JAX from there on: the two packages'
# residual streams differ by bf16 roundings (1 ulp in a part of the
# elements), which moves a logit of these reduced widths (d 64, router
# weights ~0.02) by ~3e-4
ROUTE_TIE = 2e-3


def _route_spy(monkeypatch):
    """Record, per ``moe_route`` call (one per layer, in layer order), each
    token's gap between its K-th and (K+1)-th router logit."""
    gaps = []
    route = blocks_attn.moe_route

    def spy(tok, router, **kw):
        srt = (tok.float() @ router.float()).sort(-1, descending=True).values
        k = kw["top_k"]
        gaps.append((srt[:, k - 1] - srt[:, k]).numpy())
        return route(tok, router, **kw)

    monkeypatch.setattr(blocks_attn, "moe_route", spy)
    return gaps


def check_step(model, params, prep, buf0, jlogits, jbuf, gaps=None):
    """The port's step on the same bytes: logits within 2e-2; written K/V
    of layer 0 within 1 bf16 ulp of each value, of every layer within 1
    ulp of the pages' largest value, except (MoE: ``gaps`` from
    ``_route_spy``) a token after a layer where its routing sat at a
    near-tie (``ROUTE_TIE``), held within 4; every other byte but the
    scratch page unchanged. Returns the port's logits."""
    buf = tensor_from_numpy(buf0.copy())
    logits = model.serve_step(params, buf, to_batch(prep.arrs),
                              prefill=prep.info["prefill"])[:prep.n]
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    assert np.abs(logits.numpy() - jlogits).max() < 2e-2
    ours = buf.float().numpy()
    ref = jbuf.astype(np.float32)
    view = model._layer_views(buf)["full_attn"]
    scratch = ours.shape[0] - view[1] * int(np.prod(view[2:]))
    w = written_units(prep, view, ours.shape[0], range(view[1]))
    assert w.any()
    untouched = ~w
    untouched[scratch:] = False
    assert np.array_equal(buf.view(torch.int16).numpy()[untouched],
                          buf0.view(np.int16)[untouched])
    w0 = written_units(prep, view, ours.shape[0], [0])
    a, b = ours[w0], ref[w0]
    assert (np.abs(a - b) <= np.maximum(bf16_ulp(a), bf16_ulp(b))).all()
    ulp = bf16_ulp(np.abs(ref[w]).max())
    _, n_layers, _, tpp, kvl, d = view
    eids = prep.arrs["write_eids"]["full_attn"].reshape(-1)
    slots = prep.arrs["positions"].reshape(-1) % tpp
    if gaps is None:
        gaps = [np.full(eids.shape, np.inf)] * n_layers
    assert len(gaps) == n_layers
    tied = np.logical_or.accumulate(np.stack(gaps) < ROUTE_TIE, axis=0)
    assert not tied[-1][eids >= 0].all()
    for layer in range(n_layers):
        for tkn, (eid, slot) in enumerate(zip(eids, slots)):
            if eid < 0:
                continue
            bound = 4 * ulp if layer and tied[layer - 1, tkn] else ulp
            for sel in (0, 1):
                off = int(view_offset(view, int(eid), layer, sel, int(slot)))
                diff = np.abs(ours[off:off + kvl * d] -
                              ref[off:off + kvl * d]).max()
                assert diff <= bound, (layer, tkn, diff, ulp)
    return logits


@pytest.mark.parametrize("step", ["packed mixed", "padded mixed",
                                  "padded decode"])
@pytest.mark.parametrize("name", list(MOE))
def test_serve_step_matches_jax(name, step, monkeypatch):
    packed = step.startswith("packed")
    if step.endswith("decode"):
        plan, prep, *rest = _jax_step(name, packed, steps=5,
                                      lens=(13, 6, 21))
        assert not prep.info["prefill"] and len(plan.decodes) == 3
    else:
        plan, prep, *rest = _jax_step(name, packed, steps=2,
                                      max_num_batched_tokens=24)
        assert plan.decodes and plan.prefills
    model, params = port_model(name)
    gaps = _route_spy(monkeypatch)
    model.moe_drops = []
    try:
        check_step(model, params, prep, *rest, gaps)
        assert len(model.moe_drops) == 1
    finally:
        model.moe_drops = None


# -------------------------------------------------------------- engines
def workload(n=4, max_new=6, eos=None):
    return [dict(rid=f"r{i}", prompt=[(7 * i + j) % 50
                                      for j in range(6 + 3 * i)],
                 max_new_tokens=max_new,
                 eos_token=(eos or {}).get(f"r{i}")) for i in range(n)]


@pytest.mark.parametrize("name", list(MOE))
def test_engines_match_jax_in_every_mode(name, monkeypatch):
    """Packed at depths 1/2/4 (bitwise equal: no request finishes early,
    so every depth runs the same steps), padded at depths 1 and 4 and
    serial, each fork-aware equal to the JAX engine in its mode, under
    PageSan, drained with no page left; packed dispatches take the varlen
    route and padded T == 1 dispatches the paged one (plain here)."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    reqs = workload()
    outs = {}
    for mode, depths in (("packed", DEPTHS), ("padded", DEPTHS[::2]),
                         ("serial", DEPTHS[:1])):
        jeng = jax_engine(name, batching_mode=mode,
                          record_sample_logits=True)
        drain(jeng, reqs, JRequest, JSamplingParams)
        for depth, kw in depths:
            eng = port_engine(name, batching_mode=mode,
                              record_sample_logits=True, **kw)
            assert eng.mgr.sanitizer is not None
            before = (flash_attention_varlen.launches,
                      paged_decode_attention.launches)
            outs[mode, depth] = drain(eng, reqs, Request, SamplingParams)
            assert (flash_attention_varlen.launches,
                    paged_decode_attention.launches) == before
            assert_drained_clean(eng)
            eng.mgr.sanitizer.assert_drained()
            if depth == 1:
                assert_greedy_equiv(jeng, eng, label=f"{name}/{mode}")
    assert outs["packed", 1] == outs["packed", 2] == outs["packed", 4]
    assert outs["padded", 1] == outs["padded", 4]


def _staggered_eos(name, ov):
    """EOS tokens that end the 4 requests at different steps (first
    occurrences at output indices 1, 3, 5 and 7 of a greedy run)."""
    probe = port_engine(name, ov, enable_prefix_caching=False)
    ref = drain(probe, workload(max_new=10), Request, SamplingParams)
    eos = {}
    for k, rid in zip((1, 3, 5, 7), sorted(ref)):
        out = ref[rid]
        j = next(j for j in range(k, len(out)) if out[j] not in out[:j])
        eos[rid] = out[j]
    return eos


def test_reference_depths_differ_when_requests_finish_early():
    """The reference's own MoE engines at depths 1 and 4, packed and
    padded, requests ending by EOS at different steps: at depth 4 the
    steps dispatched after a request's last token still carry its row
    (and killed rows take queue places), so the expert capacity of the
    other rows' tokens differs from depth 1's and so do their logits —
    here by up to 0.87 on reduced dbrx at the default capacity factor.
    Without early finishes the depths run the same steps and agree
    bitwise (``test_engines_match_jax_in_every_mode``)."""
    eos = _staggered_eos("dbrx", {})
    for mode in ("packed", "padded"):
        rows = {}
        for depth, kw in (DEPTHS[0], DEPTHS[2]):
            jeng = jax_engine("dbrx", batching_mode=mode,
                              enable_prefix_caching=False,
                              record_sample_logits=True, **kw)
            drain(jeng, workload(max_new=10, eos=eos), JRequest,
                  JSamplingParams)
            assert (jeng.spec_kills > 0) == (depth > 1)
            rows[depth] = jeng.sample_log
        diff = max(float(np.abs(a - b).max())
                   for rid in rows[1] for a, b in zip(rows[1][rid],
                                                      rows[4][rid]))
        assert diff > 0.1, (mode, diff)


@pytest.mark.parametrize("mode", ["packed", "padded"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_engines_match_jax_depth_for_depth_with_early_finishes(mode, cf,
                                                               monkeypatch):
    """Where the reference's depths differ (early EOS, capacity binding),
    the port at depth d is held to the JAX engine at depth d, fork-aware,
    on reduced qwen3-moe (16 experts, top-8) under PageSan."""
    monkeypatch.setenv("REPRO_PAGE_SANITIZER", "1")
    ov = dict(capacity_factor=cf)
    eos = _staggered_eos("qwen3", ov)
    reqs = workload(max_new=10, eos=eos)
    for depth, kw in (DEPTHS[0], DEPTHS[2]):
        ekw = dict(batching_mode=mode, enable_prefix_caching=False,
                   record_sample_logits=True, **kw)
        jeng = jax_engine("qwen3", ov, **ekw)
        drain(jeng, reqs, JRequest, JSamplingParams)
        eng = port_engine("qwen3", ov, **ekw)
        drain(eng, reqs, Request, SamplingParams)
        assert eng.spec_kills == jeng.spec_kills
        assert_drained_clean(eng)
        eng.mgr.sanitizer.assert_drained()
        assert_greedy_equiv(jeng, eng, label=f"qwen3/{mode}/cf{cf}/{depth}")


@pytest.mark.parametrize("name", list(MOE))
def test_seeded_sampling_matches_jax(name):
    """Temperature 0.8, top-k 5, seed 42: the port's packed engine draws
    what the JAX engine draws, exactly or forked where both packages'
    perturbed scores put both picks at the band edge (the rule of
    ``test_torch_sampling.test_engine_matches_jax_sampled``)."""
    jeng = jax_engine(name, record_sample_logits=True)
    ref = sdrain(jeng, JRequest, JSamplingParams)
    eng = port_engine(name, record_sample_logits=True)
    ours = sdrain(eng, Request, SamplingParams)
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
        pos = len(prompts[rid]) + i
        for g in (_scores_jax(jeng.sample_log[rid][i], rid, pos),
                  _scores_port(eng.sample_log[rid][i], rid, pos)):
            edge = g.max() - S.TIE_EPS
            assert min(g[a[i]], g[b[i]]) >= edge - ENGINE_FORK_TOL, (
                name, rid, i, a[i], b[i])
