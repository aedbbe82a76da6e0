"""Training the hybrid (``HybridLM``, reduced zamba2-1.2b: 5 Mamba2 layers,
the shared attention block after every 2, 8 Mamba2 heads) across ranks:
the port's ``(data, model)`` mesh over ``torch.distributed`` (``gloo``, one
process per rank) against the JAX reference's ``shard_map`` over the same
mesh of forced CPU devices, with the reference's ``model.init(0)`` drawn at
each mesh and bridged as fp32 masters (the harness of
``tests/test_torch_mesh_train.py``).

Meshes: 2 x 2 (4 Mamba2 heads a rank) and 1 x 4 (2 a rank; the shared
block's 4 heads one a rank). In each:

* ``train_loss`` and every leaf's gradient, gathered to the reference's
  global layout, against ``jax.value_and_grad(model.train_loss)`` within
  the hybrid's one-device bars (``tests/test_torch_train_hybrid.py``:
  loss 1e-3, gradients 3e-2 relative L2, ``dt_bias`` 6e-2), which the
  one-device comparison itself needs (the two frameworks round bf16
  activations and cotangents at other places, and the scan sums in
  another order): measured on the mesh, the loss within 2.2e-4 and every
  gradient within 1.8e-2 but the tail layer's ``dt_bias`` (3.1e-2);
* three ``Trainer`` steps within 1e-2 of the reference ``Trainer``'s;
* each rank's parameter and moment element counts equal to the
  reference's shardings, and the planner's per-card bytes equal to the
  rank's tensors.

Besides: the 1 x 1 mesh equal bit for bit to the one-device path; FSDP
refused; and two reference behaviours the port copies: the gated
``out_norm`` normalises over each rank's heads only (so tp moves the
function: the port's own init at tp 2 and 4 computes the one-device model
with that norm taken per group of heads), and ``w_B`` / ``w_C`` are stored
with a tp axis, one draw broadcast, each copy receiving only its own
heads' gradient (so the copies drift apart once trained).
"""
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.dryrun import mesh_train_bytes  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import HybridLM, blocks_seq, params_from_numpy  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.params import gather_tree  # noqa: E402
from repro_torch.models.tp import Dist  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,  # noqa: E402
                                  TrainerConfig, init)
from repro_torch.training.optimizer import leaves  # noqa: E402
from test_torch_mesh_train import (ADAMW, DATA, DEADLINE,  # noqa: E402
                                   TRAIN_TOL, _dump, _flat, _nbytes,
                                   _numel, _rel, _wait_for)

ARCH = "zamba2-1.2b"
CASES = {"2x2": (2, 2), "1x4": (1, 4)}
STEPS = 3
# the hybrid's one-device bars (tests/test_torch_train_hybrid.py)
LOSS_TOL, GRAD_TOL, DT_BIAS_TOL = 1e-3, 3e-2, 6e-2


def _cfg():
    return reduced(ARCHS[ARCH])


def _batch(vocab):
    rng = np.random.default_rng(1)
    return (rng.integers(0, vocab, (4, 32)).astype(np.int32),
            rng.integers(0, vocab, (4, 32)).astype(np.int32))


# ------------------------------------------------------------- JAX side
def _jax_reference(tmp: str):
    """The reference's results, pickled under ``tmp``: every mesh's params
    first (``jax-params.pkl``), then per mesh its loss and gradients, its
    Trainer's losses, its initial and final ``w_B``, and its shardings'
    local shapes
    (``jax-main.pkl``)."""
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models.registry import build_model
    from repro.models.tp import Dist as JDist
    from repro.models.tp import make_mesh_auto
    from repro.training import AdamWConfig as JAdamW
    from repro.training import SyntheticLM as JData
    from repro.training import Trainer as JTrainer
    from repro.training import TrainerConfig as JTcfg

    def local_counts(shardings, struct):
        return jax.tree.map(
            lambda sh, s: int(np.prod(sh.shard_shape(s.shape))),
            shardings, struct)

    models = {}
    for name, shape in CASES.items():
        mesh = make_mesh_auto(shape, ("data", "model"),
                              devices=jax.devices()[:shape[0] * shape[1]])
        models[name] = build_model(jreduced(JARCHS[ARCH]), JDist(mesh=mesh))
    params = {name: m.init(0) for name, m in models.items()}
    _dump({name: jax.tree.map(np.asarray, p) for name, p in params.items()},
          os.path.join(tmp, "jax-params.pkl"))
    res = {}
    for name, m in models.items():
        tok, tgt = _batch(m.cfg.vocab_size)
        loss, grads = jax.jit(jax.value_and_grad(m.train_loss))(
            params[name], tok, tgt)
        tr = JTrainer(m, JAdamW(**ADAMW), JTcfg(
            ckpt_dir=os.path.join(tmp, f"jax-{name}"), ckpt_every=1 << 30,
            micro_batches=2, zero1=True))
        p, s = tr.init_state(0)
        p, _, hist = tr.run(p, s, JData(m.cfg.vocab_size, **DATA),
                            num_steps=STEPS)
        res[name] = dict(
            loss=float(loss), grads=jax.tree.map(np.asarray, grads),
            hist=hist, w_B=np.asarray(p["mamba_main"]["w_B"]),
            w_B0=np.asarray(params[name]["mamba_main"]["w_B"]),
            counts={"params": local_counts(tr.param_shardings, m.struct()),
                    "mu": local_counts(tr.opt_shardings.mu, m.struct())})
    _dump(res, os.path.join(tmp, "jax-main.pkl"))


def _start_jax(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    log = open(os.path.join(tmp, "jax.log"), "w")
    return subprocess.Popen([sys.executable, __file__, tmp], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


# ----------------------------------------------------------- torch side
def _trainer(model, ckpt, micro=2):
    return Trainer(model, AdamWConfig(**ADAMW), TrainerConfig(
        ckpt_dir=ckpt, ckpt_every=1 << 30, micro_batches=micro, zero1=True))


def _data(cfg):
    return SyntheticLM(cfg.vocab_size, **DATA)


def _own_loss(model, dev):
    """The loss of ``_batch`` on the port's own init at ``model``'s mesh."""
    params = model.init(0, device=dev, master=True)
    tok, tgt = (torch.from_numpy(a) for a in _batch(model.cfg.vocab_size))
    with torch.no_grad():
        return float(model.train_loss(params, tok, tgt))


def _rank_case(dist, dev, name, tmp):
    """One mesh on one rank, from the reference's params: the loss and
    gathered gradients of ``_batch``, the rank's element counts and bytes,
    the Trainer's losses and its final ``w_B`` gathered, and the loss of
    the port's own init at this mesh."""
    with open(os.path.join(tmp, "jax-params.pkl"), "rb") as fh:
        jparams = pickle.load(fh)[name]
    cfg = _cfg()
    model = HybridLM(cfg, dist)
    params = params_from_numpy(jparams, cfg, dev, master=True, dist=dist)
    tok, tgt = (torch.from_numpy(a) for a in _batch(cfg.vocab_size))
    tr = _trainer(model, os.path.join(tmp, "unused"), micro=1)
    loss, grads = tr.loss_and_grads(params, tok, tgt)
    grads = gather_tree(grads, model.shards(), dist)
    tr._release(params)
    run = _trainer(model, os.path.join(tmp, f"port-{name}"))
    state = init(params, run.layout)
    out = dict(counts={"params": _numel(params), "mu": _numel(state.mu)},
               nbytes={"params": _nbytes(params), "mu": _nbytes(state.mu),
                       "nu": _nbytes(state.nu)})
    params, _, out["hist"] = run.run(params, state, _data(cfg),
                                     num_steps=STEPS)
    w_b = gather_tree({"w_B": params["mamba_main"]["w_B"]},
                      {"w_B": model.shards()["mamba_main"]["w_B"]}, dist)
    out["own_loss"] = _own_loss(model, dev)
    if dist.rank == 0:
        out.update(loss=float(loss), grads=grads, w_B=w_b["w_B"])
    return out


def _rank_one(dist, dev, tmp):
    """At 1 x 1: the mesh path against the one-device path (no Dist) on
    the port's own init, bit for bit: loss, gradients, three Trainer
    steps' losses and the params after them."""
    cfg = _cfg()
    tok, tgt = (torch.from_numpy(a) for a in _batch(cfg.vocab_size))
    found = []
    for model in (HybridLM(cfg), HybridLM(cfg, dist)):
        tr = _trainer(model, tempfile.mkdtemp(dir=tmp))
        params, state = tr.init_state(0, device=dev)
        loss, grads = tr.loss_and_grads(params, tok, tgt)
        grads = [g.clone() for g in leaves(grads)]
        tr._release(params)
        _, _, hist = tr.run(params, state, _data(cfg), num_steps=STEPS)
        found.append((loss, grads, hist, list(leaves(params))))
    (pl, pg, ph, pp), (ml, mg, mh, mp) = found
    return dict(loss=torch.equal(pl, ml),
                grads=all(torch.equal(a, b) for a, b in zip(pg, mg)),
                hist=ph == mh,
                params=all(torch.equal(a, b) for a, b in zip(pp, mp)))


def _mesh(fn, shape, args=()):
    return run_mesh(fn, shape, args=args, backend="gloo", device="cpu",
                    timeout=60, deadline=DEADLINE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every result the tests compare. The reference runs in a background
    process; the port's mesh runs start once it has written the params."""
    tmp = str(tmp_path_factory.mktemp("mesh_hybrid"))
    proc = _start_jax(tmp)
    try:
        _wait_for(os.path.join(tmp, "jax-params.pkl"), proc)
        ours = {name: _mesh(_rank_case, shape, (name, tmp))
                for name, shape in CASES.items()}
        ours["one"] = _mesh(_rank_one, (1, 1), (tmp,))[0]
        proc.wait(timeout=3 * DEADLINE)    # JAX may finish last under load
        if proc.returncode:
            with open(os.path.join(tmp, "jax.log")) as fh:
                raise RuntimeError(f"the JAX reference failed:\n{fh.read()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(tmp, "jax-main.pkl"), "rb") as fh:
        return pickle.load(fh), ours


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax_on_the_mesh(runs, name):
    ref, ours = runs
    r0 = ours[name][0]
    assert abs(r0["loss"] - ref[name]["loss"]) <= LOSS_TOL, \
        (r0["loss"], ref[name]["loss"])
    want, got = _flat(ref[name]["grads"]), _flat(r0["grads"])
    assert sorted(want) == sorted(got)
    for leaf, g in want.items():
        tol = DT_BIAS_TOL if leaf.endswith("dt_bias") else GRAD_TOL
        assert got[leaf].shape == g.shape, leaf
        assert _rel(got[leaf], g) <= tol, (leaf, _rel(got[leaf], g))


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_matches_jax_on_the_mesh(runs, name):
    ref, ours = runs
    hists = [r["hist"] for r in ours[name]]
    assert all(h == hists[0] for h in hists)        # every rank alike
    np.testing.assert_allclose(hists[0], ref[name]["hist"], atol=TRAIN_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_local_sizes_match_the_reference_shardings(runs, name):
    ref, ours = runs
    dp, tp = CASES[name]
    want = {k: _flat(v) for k, v in ref[name]["counts"].items()}
    plan = mesh_train_bytes(HybridLM(_cfg(), Dist(dp=dp, tp=tp)), zero1=True)
    for r in ours[name]:
        for kind in ("params", "mu"):
            assert _flat(r["counts"][kind]) == want[kind], (kind, r["counts"])
        assert plan == dict(params=r["nbytes"]["params"],
                            grads=r["nbytes"]["params"],
                            moments=r["nbytes"]["mu"] + r["nbytes"]["nu"])


def test_one_by_one_mesh_is_the_single_device_path(runs):
    _, ours = runs
    assert ours["one"] == dict(loss=True, grads=True, hist=True, params=True)


def _grouped_out_norm(groups):
    """``rms_norm`` that normalises the Mamba2 gated output (its last dim
    ``d_inner``) over ``groups`` equal groups of heads, as ``groups``
    ranks of the model axis do; every other norm as it was."""
    d_inner = _cfg().mamba_expand * _cfg().d_model

    def norm(x, w, eps=1e-5):
        if x.shape[-1] != d_inner:
            return rms_norm(x, w, eps)
        xs = x.reshape(*x.shape[:-1], groups, -1)
        return rms_norm(xs, w.reshape(groups, -1), eps).reshape(x.shape)
    return norm


@pytest.mark.parametrize("name", list(CASES))
def test_out_norm_runs_over_each_ranks_heads(runs, name, monkeypatch):
    """Reference behaviour 2: at tp > 1 the gated ``out_norm`` averages
    over the rank's heads only. The port's own init at this mesh keeps
    the one-device draw's slices, so its loss is the one-device model's
    with that norm taken over tp groups of heads: at least 5 times closer
    to that than to the one-device model's own (measured: 3.6e-5 against
    6.9e-4 at tp 2, 4.8e-5 against 1.0e-3 at tp 4)."""
    _, ours = runs
    tp = CASES[name][1]
    model = HybridLM(_cfg())
    plain = _own_loss(model, "cpu")
    monkeypatch.setattr(blocks_seq, "rms_norm", _grouped_out_norm(tp))
    grouped = _own_loss(model, "cpu")
    mesh = ours[name][0]["own_loss"]
    assert 5 * abs(mesh - grouped) < abs(mesh - plain), \
        (mesh, grouped, plain)


@pytest.mark.parametrize("name", list(CASES))
def test_w_b_copies_get_their_own_heads_gradient(runs, name):
    """Reference behaviour 3: ``w_B`` (and ``w_C``) is one draw broadcast
    over the tp axis, and each copy is a leaf of its own: its gradient is
    its rank's heads' part only, so the copies differ after one update,
    in the reference as in the port."""
    ref, ours = runs
    w0 = ref[name]["w_B0"]
    assert w0.shape[1] == CASES[name][1]
    assert all(np.array_equal(w0[:, 0], w0[:, m])
               for m in range(1, w0.shape[1]))
    for side in (ref[name], ours[name][0]):
        g = side["grads"]["mamba_main"]["w_B"]
        assert not np.allclose(g[:, 0], g[:, 1], rtol=1e-2, atol=0)
        w = side["w_B"]
        assert not np.array_equal(w[:, 0], w[:, 1])


def test_the_hybrid_refuses_fsdp():
    with pytest.raises(NotImplementedError, match="no FSDP"):
        HybridLM(_cfg(), Dist(dp=2, fsdp=True))


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
