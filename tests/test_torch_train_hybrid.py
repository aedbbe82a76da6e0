"""The port's hybrid training (``HybridLM.train_loss``, reduced zamba2-1.2b:
5 layers, a shared attention block after every 2) against the JAX
package's, with the reference's ``model.init(0)`` weights bridged as fp32
masters (``params_from_numpy(..., master=True)``).

* Loss and per-leaf gradients against ``jax.value_and_grad(model.
  train_loss)`` on 2 x 128 tokens (two scan chunks a row in the port,
  one in the reference, whose chunk is 128: the scan differs only by
  summation order). Loss within 1e-3 abs (measured 1.3e-4 at T 64). Every
  leaf's gradient within 3e-2 relative L2 (the dense bar of
  ``test_torch_train.py``: the two frameworks round bf16 activations and
  bf16 cotangents at different places, and the attention differs by
  design), except ``dt_bias``, held within 6e-2: its gradient sums every
  token's dt cotangent and cancels to ~1e-6 against the terms' size, so
  the same noise is relatively larger (measured 4.7e-2 on the tail layer;
  the port's own gradient moves by ~3e-2 when only its attention's
  rounding points are changed to the reference's).
* ``Trainer`` against the JAX ``Trainer`` (``AdamWConfig(lr=1e-2,
  warmup_steps=5)``, two micro-batches): the first 5 losses within 1e-2.
* A checkpoint written by the JAX ``Trainer`` (step 5) restores into the
  port (the hybrid's nested leaves: ``params_mamba_main_w_z.npy`` with its
  tp axis at 1, ``params_shared_attn_q.npy`` at 0) and the port continues
  2 steps within 5e-3 of JAX's own continuation; the port writes the same
  file names and shapes back, and resumes its own checkpoint exactly.

The JAX trainer run is shared by the file (module fixture).
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

from conftest import get_model  # noqa: E402
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import HybridLM, params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,  # noqa: E402
                                  TrainerConfig, init)
from repro_torch.training.optimizer import leaves  # noqa: E402

ARCH = "zamba2-1.2b"
ADAMW = dict(lr=1e-2, warmup_steps=5, total_steps=200)
DATA = dict(seq_len=64, global_batch=4, mode="markov")
GRAD_TOL = 3e-2
DT_BIAS_TOL = 6e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def names(tree, pre=""):
    """Leaf names in ``leaves`` order (sorted keys, subtrees dotted)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from names(tree[k], f"{pre}{k}.")
        else:
            yield pre + k


def test_loss_and_grads_match_jax():
    jmodel, cfg, jparams = get_model(ARCH)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.train_loss))(
        jparams, tok, tgt)
    pcfg = reduced(ARCHS[ARCH])
    model = HybridLM(pcfg)
    params = params_from_numpy(_np(jparams), pcfg, "cpu", master=True)
    assert all(p.dtype == torch.float32 for p in leaves(params))
    for p in leaves(params):
        p.requires_grad_(True)
    loss = model.train_loss(params, torch.from_numpy(tok),
                            torch.from_numpy(tgt))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-3
    want = params_from_numpy(_np(jgrads), pcfg, "cpu", master=True)
    for name, ours, theirs in zip(names(params), leaves(params),
                                  leaves(want)):
        assert ours.grad.shape == theirs.shape, name
        rel = float((ours.grad - theirs).norm() / theirs.norm())
        tol = DT_BIAS_TOL if name.endswith("dt_bias") else GRAD_TOL
        assert rel <= tol, (name, rel)


def test_master_init_has_the_bridged_tree():
    """``init(master=True)``: every leaf fp32, the bridged tree's names and
    shapes; serving's init keeps bf16 matrices."""
    _, cfg, jparams = get_model(ARCH)
    pcfg = reduced(ARCHS[ARCH])
    model = HybridLM(pcfg)
    own = model.init(0, device="cpu", master=True)
    bridged = params_from_numpy(_np(jparams), pcfg, "cpu", master=True)
    assert list(names(own)) == list(names(bridged))
    for a, b in zip(leaves(own), leaves(bridged)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    serve = model.init(0, device="cpu")
    assert serve["mamba_main"]["w_z"].dtype == torch.bfloat16
    assert serve["mamba_main"]["conv_w"].dtype == torch.float32


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer on reduced zamba2 for 7 steps, checkpointing every
    5: its losses and its checkpoint directory (step 5)."""
    jmodel, _, _ = get_model(ARCH)
    ckpt = tmp_path_factory.mktemp("jax_hybrid_ckpt")
    tr = JTrainer(jmodel, JAdamWConfig(**ADAMW),
                  JTrainerConfig(ckpt_dir=str(ckpt), ckpt_every=5,
                                 micro_batches=2))
    params, state = tr.init_state(0)
    data = JSyntheticLM(jmodel.cfg.vocab_size, **DATA)
    _, _, hist = tr.run(params, state, data, num_steps=7)
    return hist, str(ckpt)


def _trainer(ckpt_dir, ckpt_every=5):
    return Trainer(HybridLM(reduced(ARCHS[ARCH])), AdamWConfig(**ADAMW),
                   TrainerConfig(ckpt_dir=str(ckpt_dir),
                                 ckpt_every=ckpt_every, micro_batches=2))


def _data():
    return SyntheticLM(reduced(ARCHS[ARCH]).vocab_size, **DATA)


def test_trainer_matches_jax(jax_run, tmp_path):
    jhist, _ = jax_run
    _, _, jparams = get_model(ARCH)
    tr = _trainer(tmp_path, ckpt_every=100)
    params = params_from_numpy(_np(jparams), tr.model.cfg, "cpu",
                               master=True)
    _, _, hist = tr.run(params, init(params), _data(), num_steps=5)
    assert all(np.isfinite(hist))
    np.testing.assert_allclose(hist, jhist[:5], atol=1e-2)


def test_restores_a_jax_checkpoint_and_resumes(jax_run, tmp_path):
    jhist, ckpt = jax_run
    tr = _trainer(ckpt, ckpt_every=100)
    params, state, meta = tr.restore(5, device="cpu")
    assert meta["step"] == 5 and int(state.step) == 5
    d = f"{ckpt}/step_00000005"
    np.testing.assert_array_equal(
        params["mamba_main"]["w_z"].numpy(),
        np.load(f"{d}/params_mamba_main_w_z.npy")[:, 0])
    np.testing.assert_array_equal(
        state.mu["shared_attn"]["q"].numpy(),
        np.load(f"{d}/opt_.mu_shared_attn_q.npy")[0])
    np.testing.assert_array_equal(
        state.nu["mamba_tail"]["A_log"].numpy(),
        np.load(f"{d}/opt_.nu_mamba_tail_A_log.npy")[:, 0])
    # the port writes the reference's file names, and the params' and
    # moments' shapes, back
    rt = _trainer(tmp_path / "rt", ckpt_every=100)
    rt.save(5, params, state, blocking=True)
    out = tmp_path / "rt" / "step_00000005"
    files = sorted(f.name for f in out.iterdir())
    assert files == sorted(f.name for f in pathlib.Path(d).iterdir())
    for f in files:
        if f.startswith(("params_", "opt_.mu", "opt_.nu")):
            assert np.load(out / f).shape == np.load(f"{d}/{f}").shape, f
    # continue 2 steps against JAX's own continuation
    _, _, hist = tr.run(params, state, _data(), num_steps=7, start_step=5)
    np.testing.assert_allclose(hist, jhist[5:7], atol=5e-3)
    # and a port checkpoint resumes exactly
    mine = _trainer(tmp_path / "own", ckpt_every=2)
    p, s = mine.init_state(0, device="cpu")
    _, _, h1 = mine.run(p, s, _data(), num_steps=4)
    again = _trainer(tmp_path / "own", ckpt_every=100)
    p2, s2, _ = again.restore(2, device="cpu")
    _, _, h2 = again.run(p2, s2, _data(), num_steps=4, start_step=2)
    assert np.allclose(h1[-2:], h2, rtol=1e-5), (h1[-2:], h2)
