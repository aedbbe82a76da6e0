"""The port's training slice against the JAX package's, on reduced
granite-3-2b, internlm2-1.8b (at head dim 128) and qwen2.5-32b (QKV bias),
with the reference's ``model.init(0)`` weights bridged as fp32 masters.

* ``DecoderLM.train_loss`` and its gradients against
  ``jax.value_and_grad(model.train_loss)``: loss within 1e-3 abs, every
  leaf's gradient within 3e-2 relative L2. Both sides round activations to
  bf16 at the same places; the attention differs by design (the reference's
  jnp flash rounds q*scale and the probabilities to bf16, the port's kernel
  keeps them fp32), which moves gradients by ~1e-2 relative (measured
  <= 8.3e-3).
* ``Trainer`` against the JAX ``Trainer`` (``AdamWConfig(lr=1e-2,
  warmup_steps=5)``, two micro-batches, the reference test's data): the
  first 5 losses within 1e-2 abs (the bf16 differences above, amplified by
  lr 1e-2 updates: measured <= 2.8e-3). The port meets the reference's bar
  over 30 steps (last-5 mean > 0.3 below first-5 mean); the JAX trainer's
  own 30-step run on the same config is ``tests/test_training.py::
  test_loss_decreases`` (not repeated here: ~2 s a step on the CPU).
* A checkpoint written by the JAX ``Trainer`` (step 5) restores into the
  port's ``Trainer`` (params, mu, nu, step; leaf names parsed from the
  reference's keystr, tp axis squeezed), and the port continues 2 steps
  within 5e-3 abs of JAX's own continuation.
* Exact resume and the NaN watchdog: the port's versions of
  ``tests/test_training.py``.

One JAX trainer run is shared by the file (module fixture).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

from conftest import get_model  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.models.tp import single_device_dist  # noqa: E402
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import DecoderLM, params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,  # noqa: E402
                                  TrainerConfig, init)
from repro_torch.training.optimizer import leaves  # noqa: E402

# arch -> reduced-config overrides: internlm2 keeps its real head dim 128
ARCHS3 = {"granite-3-2b": {}, "internlm2-1.8b": {"head_dim": 128},
          "qwen2.5-32b": {}}
ADAMW = dict(lr=1e-2, warmup_steps=5, total_steps=200)
DATA = dict(seq_len=32, global_batch=8, mode="markov")


def _jax_model(arch):
    over = ARCHS3[arch]
    if not over:
        model, _, params = get_model(arch)
        return model, params
    model = build_model(jreduced(JARCHS[arch], **over), single_device_dist())
    return model, model.init(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(arch, jparams):
    cfg = reduced(ARCHS[arch], **ARCHS3[arch])
    return DecoderLM(cfg), params_from_numpy(_np(jparams), cfg, "cpu",
                                             master=True)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("arch", list(ARCHS3))
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams = _jax_model(arch)
    rng = np.random.default_rng(1)
    vocab = jmodel.cfg.vocab_size
    tok = rng.integers(0, vocab, (2, 32)).astype(np.int32)
    tgt = rng.integers(0, vocab, (2, 32)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.train_loss))(
        jparams, tok, tgt)
    model, params = _port(arch, jparams)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = model.train_loss(params, torch.from_numpy(tok),
                            torch.from_numpy(tgt))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-3
    want = params_from_numpy(_np(jgrads), model.cfg, "cpu", master=True)
    names = sorted(k for k in params if k != "layers") + \
        [f"layers.{k}" for k in sorted(params["layers"])]
    for name, ours, theirs in zip(names, leaves(params), leaves(want)):
        assert ours.grad.shape == theirs.shape, name
        assert _rel(ours.grad, theirs) <= 3e-2, (name, _rel(ours.grad,
                                                              theirs))


def test_train_loss_rejects_multimodal_arguments():
    """Only the vlm family takes a multimodal batch (its training is held
    to JAX in ``test_torch_train_moe_vlm.py``)."""
    model, params = _port("granite-3-2b", get_model("granite-3-2b")[2])
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        model.train_loss(params, tok, tok, mm_embeds=torch.zeros(1))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer on reduced granite for 7 steps, checkpointing every
    5: its losses and its checkpoint directory (step 5)."""
    jmodel, _ = _jax_model("granite-3-2b")
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    tr = JTrainer(jmodel, JAdamWConfig(**ADAMW),
                  JTrainerConfig(ckpt_dir=str(ckpt), ckpt_every=5,
                                 micro_batches=2))
    params, state = tr.init_state(0)
    data = JSyntheticLM(jmodel.cfg.vocab_size, **DATA)
    _, _, hist = tr.run(params, state, data, num_steps=7)
    return hist, str(ckpt)


def _trainer(ckpt_dir, ckpt_every=5):
    cfg = reduced(ARCHS["granite-3-2b"])
    return Trainer(DecoderLM(cfg), AdamWConfig(**ADAMW),
                   TrainerConfig(ckpt_dir=str(ckpt_dir),
                                 ckpt_every=ckpt_every, micro_batches=2))


def _data():
    return SyntheticLM(reduced(ARCHS["granite-3-2b"]).vocab_size, **DATA)


def test_synthetic_data_matches_reference():
    ours, theirs = _data(), JSyntheticLM(256, **DATA)
    for step in (0, 7):
        for a, b in zip(ours.batch_at(step), theirs.batch_at(step)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_trainer_matches_jax_and_learns(jax_run, tmp_path):
    jhist, _ = jax_run
    _, _, jparams = get_model("granite-3-2b")
    tr = _trainer(tmp_path)
    params = params_from_numpy(_np(jparams), tr.model.cfg, "cpu",
                               master=True)
    _, _, hist = tr.run(params, init(params), _data(), num_steps=30)
    np.testing.assert_allclose(hist[:5], jhist[:5], atol=1e-2)
    assert all(np.isfinite(hist))
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.3, hist[:5] + hist[-5:]


def test_restores_a_jax_checkpoint(jax_run):
    jhist, ckpt = jax_run
    tr = _trainer(ckpt, ckpt_every=100)
    params, state, meta = tr.restore(5, device="cpu")
    assert meta["step"] == 5 and int(state.step) == 5
    np_files = {f: np.load(f"{ckpt}/step_00000005/{f}")
                for f in ("params_layers_q.npy", "opt_.mu_embed.npy",
                          "opt_.nu_layers_down.npy")}
    np.testing.assert_array_equal(params["layers"]["q"].numpy(),
                                  np_files["params_layers_q.npy"][:, 0])
    np.testing.assert_array_equal(state.mu["embed"].numpy(),
                                  np_files["opt_.mu_embed.npy"][0])
    np.testing.assert_array_equal(state.nu["layers"]["down"].numpy(),
                                  np_files["opt_.nu_layers_down.npy"][:, 0])
    _, _, hist = tr.run(params, state, _data(), num_steps=7, start_step=5)
    np.testing.assert_allclose(hist, jhist[5:7], atol=5e-3)


def test_checkpoint_exact_resume(tmp_path):
    tr = _trainer(tmp_path)
    params, state = tr.init_state(0, device="cpu")
    params, state, hist = tr.run(params, state, _data(), num_steps=12)
    # a fresh trainer restores step 10 and reproduces steps 10-11 exactly
    tr2 = _trainer(tmp_path)
    p2, s2, _ = tr2.restore(10, device="cpu")
    _, _, hist2 = tr2.run(p2, s2, _data(), num_steps=12, start_step=10)
    assert np.allclose(hist[-2:], hist2, rtol=1e-5), (hist[-2:], hist2)


def test_checkpoint_round_trips_the_reference_layout(tmp_path):
    """A checkpoint the port writes holds the reference's file names and
    leaf shapes (tp axis included), and reads back bit for bit."""
    tr = _trainer(tmp_path)
    params, state = tr.init_state(3, device="cpu")
    tr.save(4, params, state, blocking=True)
    jmodel, _, _ = get_model("granite-3-2b")
    struct = jmodel.struct()
    want = {f"params_{k}.npy": v.shape for k, v in struct.items()
            if k != "layers"}
    want.update({f"params_layers_{k}.npy": v.shape
                 for k, v in struct["layers"].items()})
    for fname, shape in want.items():
        assert np.load(tmp_path / "step_00000004" / fname).shape == shape
    p2, s2, _ = tr.restore(4, device="cpu")
    for a, b in zip(leaves({"p": params, "m": state.mu, "n": state.nu}),
                    leaves({"p": p2, "m": s2.mu, "n": s2.nu})):
        assert torch.equal(a, b)
    assert int(s2.step) == 0


def test_nan_watchdog_restores(tmp_path):
    tr = _trainer(tmp_path)
    params, state = tr.init_state(0, device="cpu")
    params, state, _ = tr.run(params, state, _data(), num_steps=10)
    # poison params -> next step NaN -> watchdog must restore from step 10
    bad = {k: ({n: w * float("nan") for n, w in v.items()}
               if k == "layers" else v * float("nan"))
           for k, v in params.items()}
    _, _, hist = tr.run(bad, state, _data(), num_steps=12, start_step=10)
    assert all(np.isfinite(hist)), hist
    assert tr.restores >= 1
