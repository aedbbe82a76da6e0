"""Serving across ranks: the port's ``serve_step`` on a ``(data, model)``
mesh over ``torch.distributed`` (``gloo``, one process per rank) against
the JAX reference's ``shard_map``'d ``serve_step`` over the same mesh of
forced CPU devices, on reduced configs with the reference's
``model.init(0)`` drawn at each mesh's tp and bridged as serving weights.

Cases: (a) granite 1 x 2; (b) granite 1 x 4, whose 2 K/V heads are
replicated twice, each replica holding half of every sequence's pages;
(c) granite 2 x 1, padded rows over the data axis; (d) granite 2 x 2
``sp``, every sequence's pages split over the data ranks; (e) qwen3-moe
2 x 2, experts over the data axis; (f) qwen2-vl 1 x 2, a packed step with
image embeddings and M-RoPE; (g) zamba2 1 x 2. Each runs the layouts its
specs accept: packed mixed steps, padded prefill (T > 1, ``last_idx``)
and padded decode (T == 1).

Both packages get the same per-rank inputs: the rank's batch, split from
one (1, 1) batch by ``launch.input_specs.split_batch``, and the rank's
buffer of random old pages (so attention sees history). Compared:

* logits, gathered to the reference's global layout, within 1e-2
  (``LOGIT_TOL``). The one-device serving tests assert 2e-2 and measure
  up to 2.2e-3 (3.1e-3 for the hybrid) on engine states; on these
  inputs, whose old pages hold N(0, 1) K/V, the one-device port itself
  differs from the one-device reference by up to 3.0e-3, and the meshes
  measure up to 4.1e-3 (``sp`` packed: each member's partial is rounded
  to bf16 by the varlen kernel before the combine);
* the written K/V of every rank within 2 bf16 ulps of the written pages'
  largest magnitude (``KV_ULPS``; the one-device port on these inputs
  measures up to 1: a 4-rank bf16 all-reduce rounds after each addition
  where XLA rounds once, and a combine group's partials are rounded to
  bf16 by the kernels), the written Mamba2 state's conv part (bf16
  projection inputs, like K/V) within as many ulps and its SSM part
  within 2e-2 of their largest magnitudes (the SSM part's one-device
  bar, ``test_torch_hybrid.py``), and every other
  byte of every rank's buffer (the scratch page excepted) unchanged.

Besides: the mesh path at 1 x 1 equal bit for bit to the single-device
``serve_step``; rows that see nothing on every member of a combine group
combining to what the reference's ``combine_partials`` gives masked
partials; the planner's per-rank weights equal to the rank's tensors and
its per-rank pool to ``serve_cell``'s split; an ``Engine`` or
``ModelRunner`` given a mesh model refusing it.

The JAX side runs in one background process (this file run as a script
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``); the port's
meshes run one ``gloo`` world per mesh shape, every case of that shape in
it. Every run has a deadline and every collective times out.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.input_specs import (example_batch,  # noqa: E402
                                            example_pool, split_batch)
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.models.lm import DecodeBatch  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.models.tp import Dist, replica_info  # noqa: E402

DEADLINE = 150.0    # seconds a mesh run may take before it is killed
LOGIT_TOL = 1e-2    # see the module docstring
# name -> (arch, (dp, tp), sp, layouts)
CASES = {
    "a-granite-1x2": ("granite-3-2b", (1, 2), False,
                      ("packed", "prefill", "decode")),
    "b-granite-1x4": ("granite-3-2b", (1, 4), False,
                      ("packed", "prefill", "decode")),
    "c-granite-2x1": ("granite-3-2b", (2, 1), False, ("prefill", "decode")),
    "d-granite-2x2-sp": ("granite-3-2b", (2, 2), True, ("decode", "packed")),
    "e-moe-2x2": ("qwen3-moe-235b-a22b", (2, 2), False,
                  ("prefill", "decode")),
    "f-vlm-1x2": ("qwen2-vl-2b", (1, 2), False, ("packed",)),
    "g-hybrid-1x2": ("zamba2-1.2b", (1, 2), False, ("packed", "decode")),
}
# (old tokens in pages, new tokens this step) per sequence
SEQS = {"packed": [(0, 7), (9, 5), (13, 1), (6, 1)],
        "prefill": [(0, 6), (9, 4), (5, 3), (13, 2)],
        "decode": [(13, 1), (6, 1), (21, 1), (2, 1)]}
SMALL_PAGES = 48    # pages of each type a rank's pool holds at least
KV_ULPS = 2         # written K/V: bf16 ulps of the pages' largest value


def _rank_model(arch, mesh, sp):
    """The rank model's shapes at ``mesh`` (no process groups)."""
    cfg = reduced(ARCHS[arch])
    repl = replica_info(cfg.num_heads, cfg.num_kv_heads, mesh[1])["repl"]
    return build_model(cfg, Dist(dp=mesh[0], tp=mesh[1], sp=sp, repl=repl))


# ------------------------------------------------------------ the inputs
def make_arrays(model, layout, seed):
    """A (1, 1) batch of ``SEQS[layout]`` (``input_specs.example_batch``
    over the rank model's pool); a VLM's carries an image span in its
    first sequence: embeddings spliced in, and M-RoPE streams that differ
    over it (t, h, w)."""
    arrs, units = example_batch(model, SEQS[layout], layout == "packed",
                                seed, SMALL_PAGES)
    if model.cfg.family == "vlm":
        rng = np.random.default_rng(seed + 1)
        pos = arrs["positions"]
        arrs["mm_mask"] = np.zeros(pos.shape, bool)
        arrs["mm_mask"][0, 1:5] = True
        arrs["mm_embeds"] = (rng.standard_normal(
            pos.shape + (model.cfg.d_model,)) * 0.02).astype(np.float32)
        mr = np.broadcast_to(pos[None], (3,) + pos.shape).copy()
        mr[1, 0, 1:5] = [1, 1, 2, 2]
        mr[2, 0, 1:5] = [1, 2, 1, 2]
        arrs["mrope_pos"] = mr
    return arrs, units


def make_buffer(model, units, seed):
    """A rank's buffer: random bf16 K/V in the attention types' large
    pages, random fp32 state (as bf16 pairs) in the state's, zeros in the
    scratch page. Returns a uint16 numpy array (bf16 bits). No state
    value's low half is a bf16 NaN pattern: the reference's buffer ops on
    the CPU canonicalise NaN payloads (0x7f89 comes back 0x7fc0), which
    would change state bytes no step writes."""
    rng = np.random.default_rng(seed)
    _, first, big = example_pool(model, SMALL_PAGES)
    buf = np.zeros(units, np.uint16)
    for s in model.kv_specs():
        lo = first[s.name][0] * s.page_units
        n = first[s.name][1] * s.page_units
        if s.kind == "mamba":
            st = (rng.standard_normal(n // 2) * 0.1).astype(np.float32)
            bits = st.view(np.uint32)
            nan_low = (bits & 0x7F80) == 0x7F80
            bits[nan_low] ^= 0x4000
            buf[lo:lo + n] = bits.view(np.uint16)
        else:
            x = rng.standard_normal(n).astype(np.float32)
            buf[lo:lo + n] = (x.view(np.uint32) >> 16).astype(np.uint16)
    return buf


def case_inputs(name):
    """Every layout's per-rank batches and buffers of case ``name``:
    {layout: {"arrs": (1, 1) batch, "ranks": {(d, m): (batch, buffer)}}}."""
    arch, mesh, sp, layouts = CASES[name]
    model = _rank_model(arch, mesh, sp)
    out = {}
    for li, layout in enumerate(layouts):
        seed = 1000 * (list(CASES).index(name) + 1) + li
        arrs, units = make_arrays(model, layout, seed)
        ranks = {}
        for d in range(mesh[0]):
            for m in range(mesh[1]):
                ranks[(d, m)] = (split_batch(arrs, model, d, m),
                                 make_buffer(model, units,
                                             seed * 16 + d * mesh[1] + m))
        out[layout] = dict(arrs=arrs, ranks=ranks)
    return out


def _dump(obj, path):
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(obj, fh)
    os.rename(path + ".tmp", path)


def _load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _wait_for(path, proc=None, deadline=DEADLINE):
    import time
    end = time.monotonic() + deadline
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the JAX reference exited ({proc.returncode}) "
                               f"before writing {path}")
        if time.monotonic() > end:
            raise TimeoutError(f"no {path} after {deadline} s")
        time.sleep(0.2)


# ------------------------------------------------------------- JAX side
def _global(arrs_by_rank, mesh, sp, packed):
    """The reference's global batch from the ranks' batches: per-type
    tables, page starts, owners and write ids (s_dim, tp, B_loc, .), state
    ids (s_dim, B_loc); the per-row fields over the data axis (padded,
    not sp) or the batch's own (packed, sp)."""
    dp, tp = mesh
    any_rank = arrs_by_rank[(0, 0)]
    g = {}
    for f, v in any_rank.items():
        if f in ("tables", "page_pos", "write_eids", "page_seg"):
            g[f] = None if v is None else {k: np.stack([np.stack(
                [arrs_by_rank[(d, m)][f][k][0, 0] for m in range(tp)])
                for d in range(dp)]) for k in v}
        elif f == "state_eids":
            g[f] = {k: np.stack([arrs_by_rank[(d, 0)][f][k][0]
                                 for d in range(dp)]) for k in v}
        elif v is None or packed or sp or dp == 1:
            g[f] = v
        else:
            axis = 1 if f == "mrope_pos" else 0
            g[f] = np.concatenate([arrs_by_rank[(d, 0)][f]
                                   for d in range(dp)], axis=axis)
    return g


def _jax_reference(tmp: str):
    """The reference's results under ``tmp``: every case's params
    (``jax-params.pkl``, written first), then per case and layout the
    global logits and every rank's buffer after the step
    (``jax-main.pkl``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models.lm import DecodeBatch as JBatch
    from repro.models.registry import build_model as jbuild
    from repro.models.tp import Dist as JDist
    from repro.models.tp import make_mesh_auto

    import time
    t0 = time.monotonic()
    inputs = _load(os.path.join(tmp, "inputs.pkl"))
    models, params, drawn = {}, {}, {}
    for name, (arch, mesh, sp, _) in CASES.items():
        jmesh = make_mesh_auto(mesh, ("data", "model"),
                               devices=jax.devices()[:mesh[0] * mesh[1]])
        models[name] = jbuild(jreduced(JARCHS[arch]),
                              JDist(mesh=jmesh, sp=sp))
        # the init depends on the arch and tp only
        key = (arch, mesh[1])
        if key not in drawn:
            drawn[key] = jax.jit(models[name].init, static_argnums=0)(0)
        params[name] = drawn[key]
    _dump({n: jax.tree.map(np.asarray, p) for n, p in params.items()},
          os.path.join(tmp, "jax-params.pkl"))
    res = {}
    for name, (arch, mesh, sp, layouts) in CASES.items():
        for layout in layouts:
            ranks = inputs[name][layout]["ranks"]
            arrs = {k: b for k, (b, _) in ranks.items()}
            g = _global(arrs, mesh, sp, layout == "packed")
            batch = JBatch(**{f: (None if v is None else jax.tree.map(
                jnp.asarray, v)) for f, v in g.items()})
            buf = np.stack([np.stack([ranks[(d, m)][1]
                                      for m in range(mesh[1])])
                            for d in range(mesh[0])])
            buf = jnp.asarray(buf.view(jnp.bfloat16))
            step = jax.jit(lambda p, b, x, m=models[name],
                           pf=layout != "decode": m.serve_step(
                               p, b, x, prefill=pf))
            logits, out = step(params[name], buf, batch)
            res[(name, layout)] = (np.asarray(logits),
                                   np.asarray(out).view(np.uint16))
            print(f"{name} {layout} {time.monotonic() - t0:.1f} s",
                  flush=True)
    _dump(res, os.path.join(tmp, "jax-main.pkl"))


def _start_jax(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    log = open(os.path.join(tmp, "jax.log"), "w")
    return subprocess.Popen([sys.executable, __file__, tmp], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


# ----------------------------------------------------------- torch side
def to_batch(arrs):
    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: tensor_from_numpy(x) for k, x in v.items()}
        return tensor_from_numpy(v)
    return DecodeBatch(**{f: conv(v) for f, v in arrs.items()})


def _rank_serve(dist, dev, tmp, names):
    """Every case of ``names`` (one mesh shape) on this rank: each
    layout's local logits and buffer after the step, the bytes each
    collective sent, and the rank's weight bytes."""
    from repro_torch.launch.dryrun import mesh_model, weight_bytes
    jparams = _load(os.path.join(tmp, "jax-params.pkl"))
    inputs = _load(os.path.join(tmp, "inputs.pkl"))
    out = {}
    for name in names:
        arch, mesh, sp, layouts = CASES[name]
        cfg = reduced(ARCHS[arch])
        d = dataclasses.replace(dist, sp=sp)
        model = build_model(cfg, d)
        params = params_from_numpy(jparams[name], cfg, dev, dist=d)
        nbytes = sum(t.numel() * t.element_size()
                     for t in _leaves(params))
        planned = weight_bytes(mesh_model(cfg, mesh, sp=sp))
        for layout in layouts:
            batch, buf = inputs[name][layout]["ranks"][(d.data_rank,
                                                         d.model_rank)]
            buf = torch.from_numpy(buf.copy()).view(torch.bfloat16)
            before = dict(d.comm_bytes)
            logits = model.serve_step(params, buf, to_batch(batch),
                                      prefill=layout != "decode")
            sent = {k: d.comm_bytes[k] - before[k] for k in before}
            out[(name, layout)] = (logits.numpy(),
                                   buf.view(torch.int16).numpy().view(
                                       np.uint16), sent)
        out[(name, "weights")] = (nbytes, planned)
    if dist.dp == 1 and dist.tp > 1:
        out["own"] = _own_init_logits(dist, dev)
    return out


def _own_init(tp=1):
    """Reduced granite with the port's own init (at any mesh the slices of
    the one-device draw: one function), a packed batch and its one-device
    buffer (numpy bf16 bits)."""
    cfg = reduced(ARCHS["granite-3-2b"])
    one = build_model(cfg)
    arrs, units = make_arrays(one, "packed", 4242)
    return cfg, one, arrs, make_buffer(one, units, 4243)


def _own_init_logits(dist, dev):
    """This rank's logits of ``_own_init``'s step on a 1 x tp mesh, its
    buffer the one-device buffer's K/V heads of its group."""
    cfg, one, arrs, buf1 = _own_init()
    model = build_model(cfg, dist)
    params = model.init(0, device=dev)
    view = one._layer_views(torch.empty(0, dtype=torch.bfloat16)
                            .new_empty(buf1.shape[0]))["full_attn"]
    kvl, kv0 = model.kv_local, (dist.model_rank // dist.repl) * \
        model.kv_local
    whole = torch.from_numpy(buf1.copy()).view(torch.bfloat16)
    n = int(np.prod(view))
    mine = whole[:n].view(view)[..., kv0:kv0 + kvl, :].reshape(-1)
    units = n // view[4] * kvl + (buf1.shape[0] - n) // view[4] * kvl
    buf = torch.zeros(units, dtype=torch.bfloat16)
    buf[:mine.numel()] = mine
    batch = split_batch(arrs, model, 0, dist.model_rank)
    return model.serve_step(params, buf, to_batch(batch)).numpy()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


WORLDS = {}
for _n, (_a, _mesh, _sp, _l) in CASES.items():
    WORLDS.setdefault(_mesh, []).append(_n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every result the tests compare: the inputs (built here), the JAX
    reference's results (a background process) and the port's (one gloo
    world per mesh shape, started as soon as the params exist)."""
    tmp = str(tmp_path_factory.mktemp("mesh_serve"))
    inputs = {name: case_inputs(name) for name in CASES}
    _dump(inputs, os.path.join(tmp, "inputs.pkl"))
    proc = _start_jax(tmp)
    try:
        _wait_for(os.path.join(tmp, "jax-params.pkl"), proc)
        ours = {}
        for mesh, names in WORLDS.items():
            repl = {_rank_model(*CASES[n][:3]).dist.repl for n in names}
            assert len(repl) == 1, (mesh, repl)
            ranks = run_mesh(_rank_serve, mesh, args=(tmp, names),
                             backend="gloo", device="cpu", timeout=60,
                             deadline=DEADLINE, repl=repl.pop())
            ours[mesh] = ranks
        _wait_for(os.path.join(tmp, "jax-main.pkl"), proc, 3 * DEADLINE)
        ref = _load(os.path.join(tmp, "jax-main.pkl"))
    finally:
        proc.kill()
        proc.wait()
    return inputs, ref, ours


def bf16_ulp(x):
    x = np.maximum(np.abs(x), np.float32(1e-30))
    return np.exp2(np.floor(np.log2(x)) - 7)


def _bf16(u16):
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _written(model, batch, units):
    """(K/V units, state units) each a mask over a rank's buffer: the
    slots its live write ids cover in every layer, and its live state
    pages."""
    kv = np.zeros(units, bool)
    st = np.zeros(units, bool)
    pos = batch["positions"]
    for s in model.kv_specs():
        shape = model._layer_views(torch.empty(units))[s.name]
        if s.kind == "mamba":
            vp, nl, u2 = shape
            for e in batch["state_eids"][s.name].reshape(-1):
                if e >= 0:
                    st[e * nl * u2:(e + 1) * nl * u2] = True
            continue
        vp, nl, _, tpp, kvl, hd = shape
        w = batch["write_eids"][s.name]
        for e, p in zip(w.reshape(-1), pos.reshape(w.shape).reshape(-1)):
            if e < 0:
                continue
            for layer in range(nl):
                for sel in (0, 1):
                    off = ((((e * nl + layer) * 2 + sel) * tpp) + p % tpp) \
                        * kvl * hd
                    kv[off:off + kvl * hd] = True
    return kv, st


def _global_logits(ranks, mesh, packed, sp):
    dp, tp = mesh
    rows = []
    for d in range(dp if not (packed or sp) else 1):
        rows.append(np.concatenate([ranks[d * tp + m][0] for m in range(tp)],
                                   axis=-1))
    return np.concatenate(rows, axis=0)


CASE_LAYOUTS = [(n, lay) for n, (_a, _m, _s, ls) in CASES.items()
                for lay in ls]


@pytest.mark.parametrize("name,layout", CASE_LAYOUTS)
def test_serve_step_on_a_mesh_matches_jax(runs, name, layout):
    inputs, ref, ours = runs
    arch, mesh, sp, _ = CASES[name]
    model = _rank_model(arch, mesh, sp)
    per_rank = [r[(name, layout)] for r in ours[mesh]]
    jlogits, jbuf = ref[(name, layout)]
    packed = layout == "packed"
    logits = _global_logits(per_rank, mesh, packed, sp)
    assert logits.shape == jlogits.shape, (logits.shape, jlogits.shape)
    real = np.arange(logits.shape[-1]) < model.cfg.vocab_size
    err = np.abs(logits[:, real] - jlogits[:, real]).max()
    print(f"[mesh serve] {name} {layout} logits err {err:.3e}")
    assert err <= LOGIT_TOL, err
    assert (logits[:, ~real] == -1e30).all()
    units = jbuf.shape[-1]
    for d in range(mesh[0]):
        for m in range(mesh[1]):
            batch, buf0 = inputs[name][layout]["ranks"][(d, m)]
            ours_buf = per_rank[d * mesh[1] + m][1]
            ref_buf = jbuf[d, m]
            kv, st = _written(model, batch, units)
            scratch = np.zeros(units, bool)
            scratch[units - example_pool(model, SMALL_PAGES)[2]:] = True
            rest = ~(kv | st | scratch)
            assert np.array_equal(ours_buf[rest], buf0[rest]), (d, m)
            assert np.array_equal(ref_buf[rest], buf0[rest]), (d, m)
            if kv.any():
                a, b = _bf16(ours_buf[kv]), _bf16(ref_buf[kv])
                err = np.abs(a - b).max() / bf16_ulp(np.abs(b).max())
                print(f"[mesh serve] {name} {layout} rank {d},{m} written "
                      f"K/V err {err:.3f} ulp")
                assert err <= KV_ULPS, (d, m, err)
            if st.any():
                _check_state(model, ours_buf, ref_buf, batch)
    # the combine's bytes: only where a sequence's pages are split
    sent = per_rank[0][2]
    assert (sent["combine"] > 0) == (model.dist.repl > 1 or
                                     (sp and mesh[0] > 1))


def _check_state(model, ours, ref, batch):
    """Written Mamba2 state pages: conv part within KV_ULPS bf16 ulps, SSM
    part within 2e-2 of their largest magnitudes."""
    shape = model._layer_views(torch.empty(ours.shape[0]))["mamba"]
    vp, nl, u2 = shape
    n_ssm = model.md["ssm_units"]
    for e in batch["state_eids"]["mamba"].reshape(-1):
        if e < 0:
            continue
        for layer in range(nl):
            lo = (e * nl + layer) * u2
            a = ours[lo:lo + u2].view(np.float32)
            b = ref[lo:lo + u2].view(np.float32)
            assert np.abs(a[n_ssm:] - b[n_ssm:]).max() <= \
                KV_ULPS * bf16_ulp(np.abs(b[n_ssm:]).max()), (e, layer)
            assert np.abs(a[:n_ssm] - b[:n_ssm]).max() <= \
                2e-2 * np.abs(b[:n_ssm]).max(), (e, layer)


def test_replica_combine_mixes_q_heads(runs):
    """A reference behaviour the port copies (ROADMAP queue 3): where a
    kv head group's pages are split over its ``repl`` K/V replicas, the
    reference's ``combine_partials`` sums the partials of the replicas'
    own q heads, which differ, so such a mesh serves another function
    than one device. With the port's own init (the slices of one draw:
    one function at any mesh), 1 x 2 (no replicas) matches one device
    within the bf16 noise, and 1 x 4 (2 replicas a group) is far off."""
    _, _, ours = runs
    cfg, one, arrs, buf1 = _own_init()
    params = one.init(0, device="cpu")
    ref = one.serve_step(params, torch.from_numpy(buf1.copy()).view(
        torch.bfloat16), to_batch(arrs)).numpy()[:, :cfg.vocab_size]
    err = {}
    for tp in (2, 4):
        got = np.concatenate([r["own"] for r in ours[(1, tp)]], axis=-1)
        err[tp] = np.abs(got[:, :cfg.vocab_size] - ref).max()
    print(f"[mesh serve] own init against one device: {err}")
    assert err[2] <= LOGIT_TOL and err[4] > 5 * LOGIT_TOL, err


def test_reference_scatter_canonicalises_nan_payloads():
    """A reference behaviour (ROADMAP queue 3): on the CPU the reference's
    buffer scatter (``attention.write_state`` here, as every serve step
    runs it) rewrites a bf16 NaN payload anywhere in the buffer to the
    canonical 0x7fc0, though no byte there is written. fp32 state is
    stored as bf16 pairs, and a low half can be such a pattern, so the
    inputs here keep none (``make_buffer``); the port leaves every
    unwritten byte as it is."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as JA
    bits = np.zeros(64, np.uint16)
    bits[10] = 0x7F89
    buf = jnp.asarray(bits.view(jnp.bfloat16))
    out = jax.jit(lambda b: JA.write_state(
        b, (4, 2, 8), 0, jnp.array([1], jnp.int32),
        jnp.ones((1, 4), jnp.float32)))(buf)
    assert int(np.asarray(out).view(np.uint16)[10]) == 0x7FC0
    from repro_torch.models import attention as A
    ours = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    A.write_state(ours, (4, 2, 8), 0, torch.tensor([1]),
                  torch.ones((1, 4)))
    assert int(ours.view(torch.int16)[10]) & 0xFFFF == 0x7F89


def test_planner_weights_are_the_ranks(runs):
    """``dryrun.weight_bytes`` of each mesh's rank model equals the bytes
    of the rank's serving params (the reference's init at that tp,
    bridged), on every rank of every case."""
    _, _, ours = runs
    for mesh, ranks in ours.items():
        for name in WORLDS[mesh]:
            for r in ranks:
                nbytes, planned = r[(name, "weights")]
                assert nbytes == planned, (name, nbytes, planned)


def test_planner_pool_is_the_replica_and_sp_split():
    """``serve_cell`` at a serving mesh: a rank's tables hold 1 / repl of a
    K/V group's pages (qwen2-vl-2b at 1 x 4: 2 replicas), an ``sp`` decode
    cell's ranks hold 1 / dp of each sequence (qwen2.5-32b ``long_500k``
    at 2 x 2), and the pool is ``buffer_units_for`` of those tokens."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch.dryrun import cell_terms, mesh_model
    from repro_torch.launch.input_specs import buffer_units_for
    for arch, shape, mesh, tokens in (
            ("qwen2-vl-2b", "decode_32k", (1, 4), 32768 // 2),
            ("qwen2.5-32b", "long_500k", (2, 2), 524288 // 2),
            ("granite-3-2b", "decode_32k", (1, 4), 32768),
            ("granite-3-2b", "decode_32k", (1, 1), 32768)):
        cfg = ARCHS[arch]
        terms, cell = cell_terms(cfg, SHAPES_BY_NAME[shape], mesh)
        model = mesh_model(cfg, mesh, sp=mesh[0] > 1)
        tpp = cfg.tokens_per_page
        rows = cell.notes["rows"]
        assert cell.arrays["tables/full_attn"][0] == (rows, -(-tokens //
                                                              tpp))
        assert cell.buffer_units == buffer_units_for(model, cfg, tokens,
                                                     rows)
        assert terms["pool"] == cell.pool_bytes


def test_rows_no_member_sees_combine_as_the_reference():
    """Partials of rows that see nothing on every member (kernel log-sum-
    exp -inf), combined over the group and merged with the fresh token,
    equal the reference's ``combine_partials`` of masked partials (its
    m -1e30 and l = the masked slot count) merged the same way: the fresh
    part alone. Rows that some members see combine as the reference's
    too. The group's sums are emulated: the port's local half
    (``rescale_partials``) summed over members; the reference's runs
    under ``jax.vmap`` over a named axis."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as JA
    from repro_torch.models import attention as A
    rng = np.random.default_rng(3)
    n, rows, dh = 4, 6, 8
    q = rng.standard_normal((rows, dh)).astype(np.float32)
    k = rng.standard_normal((n, rows, 5, dh)).astype(np.float32)
    v = rng.standard_normal((n, rows, 5, dh)).astype(np.float32)
    seen = rng.random((n, rows, 5)) < 0.5
    seen[:, :2] = False             # rows 0 and 1: nothing on any member
    kf = rng.standard_normal((rows, dh)).astype(np.float32)
    vf = rng.standard_normal((rows, dh)).astype(np.float32)

    def member_ref(km, vm, sm):
        logit = jnp.einsum("rd,rsd->rs", q, km)
        logit = jnp.where(sm, logit, JA.NEG_INF)
        m = logit.max(-1)
        p = jnp.exp(logit - m[:, None])
        return jnp.einsum("rs,rsd->rd", p, vm), m, p.sum(-1)

    def ref_fn(km, vm, sm):
        o, m, l = member_ref(km, vm, sm)
        o, m, l = JA.combine_partials(o, m, l, "g")
        fl = jnp.einsum("rd,rd->r", q, kf)
        o, m, l = JA.merge_partials(o, m, l, vf, fl, jnp.ones_like(fl))
        return o / l[:, None]

    ref = np.asarray(jax.vmap(ref_fn, axis_name="g")(k, v, seen))[0]
    parts = []
    for i in range(n):
        logit = np.where(seen[i], np.einsum("rd,rsd->rs", q, k[i]),
                         -np.inf)
        lse = torch.from_numpy(logit).logsumexp(-1)
        w = torch.softmax(torch.from_numpy(logit), -1).nan_to_num(0.0)
        out = torch.einsum("rs,rsd->rd", w, torch.from_numpy(v[i]))
        parts.append(A.lse_partials(out, lse))
    gmax = torch.stack([m for _, m, _ in parts]).amax(0)
    o = sum(A.rescale_partials(oi, mi, li, gmax)[0]
            for oi, mi, li in parts)
    l = sum(A.rescale_partials(oi, mi, li, gmax)[1]
            for oi, mi, li in parts)
    fl = torch.from_numpy(np.einsum("rd,rd->r", q, kf))
    o, m, l = A.merge_partials(o, gmax, l, torch.from_numpy(vf), fl,
                           torch.ones_like(fl))
    ours = (o / l[:, None]).numpy()
    assert np.array_equal(ours[:2], vf[:2])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)


def test_one_by_one_mesh_is_the_single_device_step():
    """At a 1 x 1 mesh ``serve_step`` is the single-device step, bit for
    bit: logits and buffer, packed and padded decode, dense and hybrid."""
    for arch, layouts in (("granite-3-2b", ("packed", "decode")),
                          ("zamba2-1.2b", ("packed",))):
        cfg = reduced(ARCHS[arch])
        one = build_model(cfg)
        mesh = build_model(cfg, Dist(dp=1, tp=1))
        params = one.init(0, device="cpu")
        for li, layout in enumerate(layouts):
            arrs, units = make_arrays(one, layout, 77 + li)
            buf0 = make_buffer(one, units, 78 + li)
            outs = []
            for model in (one, mesh):
                buf = torch.from_numpy(buf0.copy()).view(torch.bfloat16)
                logits = model.serve_step(params, buf, to_batch(arrs),
                                          prefill=layout != "decode")
                outs.append((logits, buf))
            assert torch.equal(outs[0][0], outs[1][0])
            assert torch.equal(outs[0][1].view(torch.int16),
                               outs[1][1].view(torch.int16))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "zamba2-1.2b"])
def test_mesh_init_keeps_only_the_ranks_slices(arch):
    """A repaired fault: ``init`` on a mesh drew each one-device leaf and
    kept a contiguous slice of it, a view that held the whole leaf (a
    vocabulary table tp times the rank's part: 0.7 GB more a rank of
    qwen2-vl-2b at 1 x 4). Every leaf now owns only its own bytes."""
    model = build_model(reduced(ARCHS[arch]), Dist(tp=2))

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from walk(v)
            else:
                yield v
    for leaf in walk(model.init(0, device="cpu")):
        assert leaf.untyped_storage().nbytes() == \
            leaf.numel() * leaf.element_size(), tuple(leaf.shape)


def test_engine_and_runner_refuse_a_mesh_model():
    from repro_torch.core.manager import JengaKVCacheManager
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.runner import ModelRunner
    for arch in ("granite-3-2b", "zamba2-1.2b"):
        model = _rank_model(arch, (1, 2), False)
        with pytest.raises(NotImplementedError, match="1 x 2 mesh"):
            Engine(model, EngineConfig(), device="cpu")
        mgr = JengaKVCacheManager(model.kv_specs(),
                                  total_memory_bytes=1 << 22)
        with pytest.raises(NotImplementedError, match="one device"):
            ModelRunner(model, mgr, device="cpu")


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
