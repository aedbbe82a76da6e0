"""The port's RWKV6 and enc-dec training (``RWKVLM.train_loss``, reduced
rwkv6-3b: 4 layers, d 64, heads of 16; ``EncDecLM.train_loss``, reduced
whisper-tiny: 2 + 2 layers, d 64, 16 stub frames) against the JAX
package's, with the reference's ``model.init(0)`` weights bridged as fp32
masters (``params_from_numpy(..., master=True)``).

* Loss and per-leaf gradients against ``jax.value_and_grad(model.
  train_loss)`` on 2 x 128 tokens (two RWKV chunks a row, so the wkv
  state carries across a chunk); whisper's ``enc_embeds`` are numpy
  draws (2, 16, d), whose 16 frames both sides pad to 512 zero keys in
  the encoder's and the cross attention. Loss within 1e-3 abs (measured
  1.1e-4 / 6.6e-5), every leaf's gradient within 3e-2 relative L2, the
  dense bar of ``test_torch_train.py`` (measured <= 1.9e-2 / 1.2e-2: the
  two frameworks round bf16 activations and cotangents at different
  places).
* Gradients stay finite, and match JAX's, when every row's cumulative
  decay passes 88 nats inside a chunk (``exp`` of it underflows in fp32).
* ``Trainer`` against the JAX ``Trainer`` (``AdamWConfig(lr=1e-2,
  warmup_steps=5)``, two micro-batches; whisper's frames through
  ``extra_batch``): the first 5 losses within 1e-2.
* A checkpoint written by the JAX ``Trainer`` (step 5) restores into the
  port and the port continues 2 steps within 5e-3 of JAX's own
  continuation; the port writes the same file names and shapes back (the
  size-1 tp axis of RWKV6's ``layers`` and of the enc-dec stacks at axis
  1: ``params_layers_w_r.npy`` (L, 1, d, d_att),
  ``params_enc_mlp_w1.npy`` (n, 1, d, ff)), and resumes its own
  checkpoint exactly.

Each family's JAX trainer run is shared by the file (module fixture).
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
from repro_torch.models import blocks_seq, build_model  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.tp import embed_lookup  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,  # noqa: E402
                                  TrainerConfig, init)
from repro_torch.training.optimizer import leaves  # noqa: E402
from test_torch_train_hybrid import names  # noqa: E402

RWKV, WHISPER = "rwkv6-3b", "whisper-tiny"
ADAMW = dict(lr=1e-2, warmup_steps=5, total_steps=200)
DATA = dict(seq_len=64, global_batch=4, mode="markov")
GRAD_TOL = 3e-2
T = 128                      # two RWKV chunks of 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def frames(cfg, seed):
    """``Trainer.extra_batch`` for enc-dec: (B, encoder_seq, d) stub frame
    embeddings drawn from ``seed`` and the step's first token."""
    def extra(tokens):
        rng = np.random.default_rng([seed, int(tokens[0, 0])])
        return {"enc_embeds": rng.standard_normal(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model),
            dtype=np.float32)}
    return extra


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    kw = frames(cfg, seed)(tok) if cfg.family == "encdec" else {}
    return tok, tgt, kw


def _compare(arch, jparams, tok, tgt, kw):
    """The port's loss and gradients against JAX's on the same masters:
    (loss diff, {leaf: relative L2 gradient gap}, port grads finite)."""
    jmodel, cfg, _ = get_model(arch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(p, tok, tgt, **kw)))(jparams)
    pcfg = reduced(ARCHS[arch])
    params = params_from_numpy(_np(jparams), pcfg, "cpu", master=True)
    assert all(p.dtype == torch.float32 for p in leaves(params))
    for p in leaves(params):
        p.requires_grad_(True)
    loss = build_model(pcfg).train_loss(
        params, torch.from_numpy(tok), torch.from_numpy(tgt),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    loss.backward()
    want = params_from_numpy(_np(jgrads), pcfg, "cpu", master=True)
    rel = {}
    for name, ours, theirs in zip(names(params), leaves(params),
                                  leaves(want)):
        assert ours.grad.shape == theirs.shape, name
        rel[name] = float((ours.grad - theirs).norm() / theirs.norm())
    finite = all(bool(torch.isfinite(p.grad).all()) for p in leaves(params))
    return abs(float(loss.detach()) - float(jloss)), rel, finite


@pytest.mark.parametrize("arch", [RWKV, WHISPER])
def test_loss_and_grads_match_jax(arch):
    _, cfg, jparams = get_model(arch)
    dloss, rel, finite = _compare(arch, jparams, *_batch(cfg))
    assert finite
    assert dloss <= 1e-3, dloss
    bad = {n: r for n, r in rel.items() if not r <= GRAD_TOL}
    assert not bad, bad


def test_rwkv_grads_finite_past_88_nats():
    """``w_base`` 2.0 (e^2 = 7.4 nats a token before the LoRA's share):
    every row's cumulative decay inside a 64-token chunk passes 88 nats,
    where exp(L) underflows in fp32 and ``_decay`` feeds -inf through its
    mask. Loss and gradients stay finite and match JAX's."""
    _, cfg, jparams = get_model(RWKV)
    jparams = jax.tree.map(lambda a: a, jparams)      # a new tree
    jparams["layers"]["w_base"] = jparams["layers"]["w_base"] * 0 + 2.0
    tok, tgt, kw = _batch(cfg, seed=3)
    # the premise: layer 0's in-chunk decay passes 88 nats in every row
    pcfg = reduced(ARCHS[RWKV])
    model = build_model(pcfg)
    params = params_from_numpy(_np(jparams), pcfg, "cpu", master=True)
    p0 = {n: a[0] for n, a in params["layers"].items()}
    x = rms_norm(embed_lookup(torch.from_numpy(tok), params["embed"]),
                 p0["ln1"], pcfg.norm_eps)
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    logw = blocks_seq._rwkv_proj(p0, x, x_prev, model.rd,
                                 pcfg.rwkv_head_size)[-1]
    decay = -logw[:, :64].sum(1)                     # (B, H, hs) nats
    assert float(decay.amin(dim=(1, 2)).min()) > 88.0
    dloss, rel, finite = _compare(RWKV, jparams, tok, tgt, kw)
    assert finite
    assert dloss <= 1e-3, dloss
    bad = {n: r for n, r in rel.items() if not r <= GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("arch", [RWKV, WHISPER])
def test_master_init_has_the_bridged_tree(arch):
    """``init(master=True)``: every leaf fp32, the bridged tree's names and
    shapes; serving's init keeps bf16 matrices."""
    _, cfg, jparams = get_model(arch)
    pcfg = reduced(ARCHS[arch])
    model = build_model(pcfg)
    own = model.init(0, device="cpu", master=True)
    bridged = params_from_numpy(_np(jparams), pcfg, "cpu", master=True)
    assert list(names(own)) == list(names(bridged))
    for a, b in zip(leaves(own), leaves(bridged)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    serve = model.init(0, device="cpu")
    assert serve["embed"].dtype == torch.bfloat16
    # the same draws: serving's matrices are the masters rounded
    assert torch.equal(serve["embed"], own["embed"].to(torch.bfloat16))


def test_encdec_train_loss_needs_frames():
    pcfg = reduced(ARCHS[WHISPER])
    model = build_model(pcfg)
    params = model.init(0, device="cpu", master=True)
    tok = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        model.train_loss(params, tok, tok)


def _extra(arch):
    cfg = reduced(ARCHS[arch])
    return frames(cfg, 7) if cfg.family == "encdec" else None


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each family's JAX Trainer run, made once on first use: 7 steps,
    checkpointing every 5 -> (losses, checkpoint directory)."""
    runs = {}

    def get(arch):
        if arch not in runs:
            jmodel, _, _ = get_model(arch)
            ckpt = tmp_path_factory.mktemp(f"jax_{arch}_ckpt")
            tr = JTrainer(jmodel, JAdamWConfig(**ADAMW),
                          JTrainerConfig(ckpt_dir=str(ckpt), ckpt_every=5,
                                         micro_batches=2),
                          extra_batch=_extra(arch))
            params, state = tr.init_state(0)
            data = JSyntheticLM(jmodel.cfg.vocab_size, **DATA)
            _, _, hist = tr.run(params, state, data, num_steps=7)
            runs[arch] = (hist, str(ckpt))
        return runs[arch]
    return get


def _trainer(arch, ckpt_dir, ckpt_every=5):
    return Trainer(build_model(reduced(ARCHS[arch])), AdamWConfig(**ADAMW),
                   TrainerConfig(ckpt_dir=str(ckpt_dir),
                                 ckpt_every=ckpt_every, micro_batches=2),
                   extra_batch=_extra(arch))


def _data(arch):
    return SyntheticLM(reduced(ARCHS[arch]).vocab_size, **DATA)


@pytest.mark.parametrize("arch", [RWKV, WHISPER])
def test_trainer_matches_jax(arch, jax_runs, tmp_path):
    jhist, _ = jax_runs(arch)
    _, _, jparams = get_model(arch)
    tr = _trainer(arch, tmp_path, ckpt_every=100)
    params = params_from_numpy(_np(jparams), tr.model.cfg, "cpu",
                               master=True)
    _, _, hist = tr.run(params, init(params), _data(arch), num_steps=5)
    assert all(np.isfinite(hist))
    np.testing.assert_allclose(hist, jhist[:5], atol=1e-2)


# a leaf whose tp axis the reference puts at 1, and its expected shape
TP_LEAF = {
    RWKV: ("params_layers_w_r.npy",
           lambda c: (c.num_layers, 1, c.d_model,
                      c.d_model // c.rwkv_head_size * c.rwkv_head_size)),
    WHISPER: ("params_enc_mlp_w1.npy",
              lambda c: (c.encoder_layers, 1, c.d_model, c.d_ff)),
}


@pytest.mark.parametrize("arch", [RWKV, WHISPER])
def test_restores_a_jax_checkpoint_and_resumes(arch, jax_runs, tmp_path):
    jhist, ckpt = jax_runs(arch)
    tr = _trainer(arch, ckpt, ckpt_every=100)
    params, state, meta = tr.restore(5, device="cpu")
    assert meta["step"] == 5 and int(state.step) == 5
    d = pathlib.Path(ckpt) / "step_00000005"
    if arch == RWKV:
        np.testing.assert_array_equal(
            params["layers"]["w_r"].numpy(),
            np.load(d / "params_layers_w_r.npy")[:, 0])
        np.testing.assert_array_equal(
            state.nu["layers"]["u"].numpy(),
            np.load(d / "opt_.nu_layers_u.npy")[:, 0])
    else:
        np.testing.assert_array_equal(
            params["enc"]["mlp"]["w1"].numpy(),
            np.load(d / "params_enc_mlp_w1.npy")[:, 0])
        np.testing.assert_array_equal(
            state.mu["dec_cross"]["q"].numpy(),
            np.load(d / "opt_.mu_dec_cross_q.npy")[:, 0])
    # the port writes the reference's file names, and the params' and
    # moments' shapes, tp axes included, back
    rt = _trainer(arch, tmp_path / "rt", ckpt_every=100)
    rt.save(5, params, state, blocking=True)
    out = tmp_path / "rt" / "step_00000005"
    files = sorted(f.name for f in out.iterdir())
    assert files == sorted(f.name for f in d.iterdir())
    for f in files:
        if f.startswith(("params_", "opt_.mu", "opt_.nu")):
            assert np.load(out / f).shape == np.load(d / f).shape, f
    fname, shape = TP_LEAF[arch]
    assert np.load(out / fname).shape == shape(reduced(ARCHS[arch]))
    # continue 2 steps against JAX's own continuation
    _, _, hist = tr.run(params, state, _data(arch), num_steps=7,
                        start_step=5)
    np.testing.assert_allclose(hist, jhist[5:7], atol=5e-3)
    # and a port checkpoint resumes exactly
    mine = _trainer(arch, tmp_path / "own", ckpt_every=2)
    p, s = mine.init_state(0, device="cpu")
    _, _, h1 = mine.run(p, s, _data(arch), num_steps=4)
    again = _trainer(arch, tmp_path / "own", ckpt_every=100)
    p2, s2, _ = again.restore(2, device="cpu")
    _, _, h2 = again.run(p2, s2, _data(arch), num_steps=4, start_step=2)
    assert np.allclose(h1[-2:], h2, rtol=1e-5), (h1[-2:], h2)
