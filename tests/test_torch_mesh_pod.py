"""The reference's third mesh axis, "pod": training on a ``(pod, data,
model)`` mesh over ``torch.distributed`` (``gloo``, one process per rank)
against the JAX reference's ``shard_map`` over the same 3-axis mesh of
forced CPU devices (``Dist(mesh, dp_axes=("pod", "data"))``), with the
reference's ``model.init(0)`` bridged as fp32 masters.

Cases: reduced granite-3-2b at (2, 2, 1) with FSDP (its shards over
"data", replicated over "pod") and at (2, 1, 2); reduced qwen3-moe at
(2, 2, 1), its experts over "data" and replicated over "pod". In each:

* ``train_loss`` and every leaf's gradient, gathered to the reference's
  global layout, within the dense file's bars (``TOLS``: 1e-4 / 8.3e-3
  relative L2 at tp 1, 2e-4 / 1e-2 at tp 2): the batch rows split over
  pod x data, the loss's mean and the replicated leaves' gradients summed
  over both, FSDP's and the experts' gradients over "pod";
* every rank's ZeRO-1 moment shapes equal to the reference's
  ``zero1_shardings`` shard shapes (each moment over "data", then over
  "pod" on the next free dim the pod size divides), the tp axis dropped.

Besides: one ``Trainer`` step at (2, 2, 1) FSDP with ZeRO-1 against the
reference ``Trainer``'s (loss within ``TRAIN_TOL``, every parameter within
``PARAM_TOL`` relative L2); its checkpoint (global arrays, the moments
gathered over "pod" and "data") restored at (1, 4, 1) and continued to
the uninterrupted run's losses; and ``dryrun --multi-pod`` planning one
card's share of the reference's 2 x 16 x 16 cells, ``global_batch / 32``
rows. The two-axis meshes are unchanged: their own files hold them.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, reduced  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.models.params import gather_tree  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,  # noqa: E402
                                  TrainerConfig, init)
from repro_torch.training.optimizer import leaves  # noqa: E402
from test_torch_mesh_serve import _dump, _load, _wait_for  # noqa: E402
from test_torch_mesh_train import ADAMW, DATA, TOLS, TRAIN_TOL, _flat, _rel  # noqa: E402

GRANITE, MOE = "granite-3-2b", "qwen3-moe-235b-a22b"
# name -> (arch, (pod, data, model), fsdp)
CASES = {"g-221-fsdp": (GRANITE, (2, 2, 1), True),
         "g-212": (GRANITE, (2, 1, 2), False),
         "moe-221": (MOE, (2, 2, 1), False)}
STEP_CASE = "g-221-fsdp"
RESUME, RESUME_TOL = 1, 5e-3
# parameters after one AdamW step (lr 2e-3 at step 1), relative L2: each
# element moves by about lr, by the sign of its gradient, so a gradient
# near 0 whose sign differs between the two sides moves its element by
# 2 lr; the one-device port against the one-device reference measures up
# to 2.1e-2 (``down``) after one step of this configuration
PARAM_TOL = 3e-2
DEADLINE = 150.0
BATCH_SEED = 12     # routes alike on both sides (test_torch_mesh_train_moe_vlm)


def _batch(vocab):
    rng = np.random.default_rng(BATCH_SEED)
    return (rng.integers(0, vocab, (4, 32)).astype(np.int32),
            rng.integers(0, vocab, (4, 32)).astype(np.int32))


def _trainer(model, ckpt, micro=2, every=1 << 30):
    return Trainer(model, AdamWConfig(**ADAMW), TrainerConfig(
        ckpt_dir=ckpt, ckpt_every=every, micro_batches=micro, zero1=True))


# ------------------------------------------------------------- JAX side
def _jax_reference(tmp: str):
    """The reference's results under ``tmp``: every case's params
    (``jax-params.pkl``, written first), then per case its loss, gradients
    and ZeRO-1 moment shard shapes, and the (2, 2, 1) Trainer's first loss
    and parameters after one step (``jax-main.pkl``)."""
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models.registry import build_model as jbuild
    from repro.models.tp import Dist as JDist
    from repro.models.tp import make_mesh_auto
    from repro.training import AdamWConfig as JAdamW
    from repro.training import SyntheticLM as JData
    from repro.training import Trainer as JTrainer
    from repro.training import TrainerConfig as JTcfg
    from repro.training.optimizer import zero1_shardings

    models, params = {}, {}
    for name, (arch, shape, fsdp) in CASES.items():
        mesh = make_mesh_auto(shape, ("pod", "data", "model"),
                              devices=jax.devices()[:math.prod(shape)])
        models[name] = jbuild(jreduced(JARCHS[arch]), JDist(
            mesh=mesh, dp_axes=("pod", "data"), fsdp=fsdp))
        params[name] = models[name].init(0)
    _dump({n: jax.tree.map(np.asarray, p) for n, p in params.items()},
          os.path.join(tmp, "jax-params.pkl"))
    res = {}
    for name, m in models.items():
        tok, tgt = _batch(m.cfg.vocab_size)
        loss, grads = jax.jit(jax.value_and_grad(m.train_loss))(
            params[name], tok, tgt)
        shard = zero1_shardings(m.specs(), m.struct(), m.dist.mesh)
        res[name] = dict(loss=float(loss),
                         grads=jax.tree.map(np.asarray, grads),
                         mu=jax.tree.map(lambda sh, s: tuple(
                             sh.shard_shape(s.shape)), shard, m.struct()))
    m = models[STEP_CASE]
    tr = JTrainer(m, JAdamW(**ADAMW), JTcfg(
        ckpt_dir=os.path.join(tmp, "jax-ckpt"), ckpt_every=1 << 30,
        micro_batches=2, zero1=True))
    p, s = tr.init_state(0)
    p, _, hist = tr.run(p, s, JData(m.cfg.vocab_size, **DATA), num_steps=1)
    res["step"] = dict(hist=hist, params=jax.tree.map(np.asarray, p))
    _dump(res, os.path.join(tmp, "jax-main.pkl"))


def _start_jax(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    log = open(os.path.join(tmp, "jax.log"), "w")
    return subprocess.Popen([sys.executable, __file__, tmp], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


# ----------------------------------------------------------- torch side
def _case(dist, dev, tmp, name, jparams):
    """One case on this rank: the loss and gathered gradients, and the
    rank's ZeRO-1 moment shapes; the step case also runs its Trainer one
    step (params gathered) and on to step RESUME + 2, checkpointing every
    step."""
    arch, _, fsdp = CASES[name]
    cfg = reduced(ARCHS[arch])
    dist = dataclasses.replace(dist, fsdp=fsdp)
    model = build_model(cfg, dist)
    params = params_from_numpy(jparams[name], cfg, dev, master=True,
                               dist=dist)
    tok, tgt = (torch.from_numpy(a) for a in _batch(cfg.vocab_size))
    tr = _trainer(model, os.path.join(tmp, "unused"), micro=1)
    loss, grads = tr.loss_and_grads(params, tok, tgt)
    grads = gather_tree(grads, model.shards(), dist)
    tr._release(params)
    run = _trainer(model, os.path.join(tmp, f"port-{name}"), every=1)
    state = init(params, run.layout)
    out = dict(mu=[tuple(t.shape) for t in leaves(state.mu)],
               tp_axes=[sh.tp_axis for sh in leaves(model.shards())])
    if name == STEP_CASE:
        data = SyntheticLM(cfg.vocab_size, **DATA)
        params, state, hist = run.run(params, state, data, num_steps=1)
        out["step"] = gather_tree(params, model.shards(), dist)
        _, _, rest = run.run(params, state, data, num_steps=RESUME + 2,
                             start_step=1)
        out["hist"] = hist + rest
    if dist.rank == 0:
        out.update(loss=float(loss), grads=grads)
    return out


def _rank_world(dist, dev, tmp, names):
    jparams = _load(os.path.join(tmp, "jax-params.pkl"))
    return {n: _case(dist, dev, tmp, n, jparams) for n in names}


def _rank_resume(dist, dev, tmp):
    """The step case's checkpoint at step RESUME restored on this mesh
    (FSDP) and continued to step RESUME + 2."""
    cfg = reduced(ARCHS[GRANITE])
    dist = dataclasses.replace(dist, fsdp=True)
    tr = _trainer(build_model(cfg, dist),
                  os.path.join(tmp, f"port-{STEP_CASE}"))
    p, s, _ = tr.restore(RESUME, device=dev)
    _, _, hist = tr.run(p, s, SyntheticLM(cfg.vocab_size, **DATA),
                        num_steps=RESUME + 2, start_step=RESUME)
    return hist


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_pod"))
    proc = _start_jax(tmp)
    try:
        _wait_for(os.path.join(tmp, "jax-params.pkl"), proc, DEADLINE)
        worlds = {}
        for name, (_, shape, _) in CASES.items():
            worlds.setdefault(shape, []).append(name)
        ours = {}
        for shape, names in worlds.items():
            for r in run_mesh(_rank_world, shape, args=(tmp, names),
                              backend="gloo", device="cpu", timeout=60,
                              deadline=DEADLINE):
                for n, v in r.items():
                    ours.setdefault(n, []).append(v)
        ours["resume"] = run_mesh(_rank_resume, (1, 4, 1), args=(tmp,),
                                  backend="gloo", device="cpu", timeout=60,
                                  deadline=DEADLINE)
        _wait_for(os.path.join(tmp, "jax-main.pkl"), proc, 3 * DEADLINE)
        ref = _load(os.path.join(tmp, "jax-main.pkl"))
    finally:
        proc.kill()
        proc.wait()
    return ref, ours


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax_on_a_pod_mesh(runs, name):
    ref, ours = runs
    loss_tol, grad_tol = TOLS[CASES[name][1][2] > 1]
    r0 = ours[name][0]
    assert abs(r0["loss"] - ref[name]["loss"]) <= loss_tol, \
        (r0["loss"], ref[name]["loss"])
    want, got = _flat(ref[name]["grads"]), _flat(r0["grads"])
    assert sorted(want) == sorted(got)
    for leaf, g in want.items():
        assert got[leaf].shape == g.shape, leaf
        assert _rel(got[leaf], g) <= grad_tol, (leaf, _rel(got[leaf], g))


@pytest.mark.parametrize("name", list(CASES))
def test_zero1_moments_are_the_reference_shards(runs, name):
    """Each rank's moment shapes are the reference's ``zero1_shardings``
    shard shapes with the (size-1) tp axis dropped, on every rank; a
    leaf's moment is split over "pod" on a dim of its own."""
    ref, ours = runs
    want = list(leaves(ref[name]["mu"]))
    for r in ours[name]:
        got = r["mu"]
        assert len(got) == len(want)
        for g, w, ax in zip(got, want, r["tp_axes"]):
            w = tuple(n for i, n in enumerate(w) if i != ax)
            assert g == w, (g, w)
    total = sum(math.prod(s) for s in ours[name][0]["mu"])
    params = sum(np.prod(v.shape) for v in _flat(ref[name]["grads"]).values())
    assert total < params / 2        # split over pod x data, most leaves


def test_trainer_step_matches_jax_on_a_pod_mesh(runs):
    ref, ours = runs
    r0 = ours[STEP_CASE][0]
    assert all(r["hist"] == r0["hist"] for r in ours[STEP_CASE])
    assert abs(r0["hist"][0] - ref["step"]["hist"][0]) <= TRAIN_TOL
    want, got = _flat(ref["step"]["params"]), _flat(r0["step"])
    for leaf, w in want.items():
        assert _rel(got[leaf], w) <= PARAM_TOL, (leaf, _rel(got[leaf], w))


def test_pod_checkpoint_restores_on_another_pod_size(runs):
    """The (2, 2, 1) Trainer's checkpoint at step RESUME restored at
    (1, 4, 1), which computes the same function (rows over 4 ranks either
    way), and continued: the uninterrupted run's losses."""
    _, ours = runs
    whole = ours[STEP_CASE][0]["hist"]
    resumed = ours["resume"]
    assert all(r == resumed[0] for r in resumed)
    np.testing.assert_allclose(resumed[0], whole[RESUME:], atol=RESUME_TOL)


def test_multi_pod_plans_a_thirty_second_of_the_batch(tmp_path):
    """``dryrun --multi-pod``: one card's share of the reference's
    2 x 16 x 16 cells holds ``global_batch / 32`` rows of every cell that
    is not sequence-parallel (an ``sp`` cell's sequences stay whole on
    one card, as without pods)."""
    import json

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import card_share
    for arch, shape in (("granite-3-2b", "train_4k"),
                        ("rwkv6-3b", "prefill_32k"),
                        ("whisper-tiny", "decode_32k"),
                        ("qwen2.5-32b", "long_500k")):
        assert dryrun.main(["--arch", arch, "--shape", shape, "--multi-pod",
                            "--out", str(tmp_path)]) == 0
        with open(tmp_path / f"{arch}__{shape}__2x16x16.json") as fh:
            rec = json.load(fh)
        s = SHAPES_BY_NAME[shape]
        want = s.global_batch if card_share(s).sp else s.global_batch // 32
        assert rec["rows"] == want and rec["pods"] == 2, (arch, shape, rec)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
