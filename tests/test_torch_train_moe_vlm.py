"""The port's MoE and VLM training (``DecoderLM.train_loss`` for the
``moe`` and ``vlm`` families) against the JAX package's, with the
reference's ``model.init(0)`` weights bridged as fp32 masters.

* Loss and per-leaf gradients against ``jax.value_and_grad(model.
  train_loss)`` on 2 x 64 tokens: reduced dbrx and reduced qwen3-moe
  (E 4, top 2, as ``configs.reduced`` gives them), both with the Switch
  load-balance loss summed over the layers, divided by the cycles and
  added; reduced qwen2-vl-2b
  with the multimodal batch built as ``tests/test_arch_smoke.py`` builds
  it (``mm_embeds`` 0.05, ``mm_mask`` on the first 2 tokens, the three
  M-RoPE streams at the token's position). The dense bar of
  ``test_torch_train.py``: loss within 1e-3 abs (the aux loss is ~1e-2,
  so a missing one fails), every leaf's gradient within 3e-2 relative L2
  (measured <= 7.7e-3). A router near-tie would route a token to other
  experts on the two sides (their router sums run in another order, and
  deeper layers' inputs differ by bf16 roundings), which is no fault of
  either: the test asserts, through a spy on the port's ``moe_route``,
  that no token's K-th and (K+1)-th router logits lie within
  ``NEAR_TIE`` (1e-4 of the row's largest |logit|) of each other, so a
  comparison spoilt by a tie fails as such and not as a gradient gap
  (smallest gap measured: 4.9e-4, dbrx); a choice that flips above it
  fails the loss and gradient bars. (``test_torch_moe.py``'s wider qwen3
  route, 16 experts and top 8, sits at 2.3e-4 on these inputs, and there
  its expert and router leaves differ by ~4e-2 while its attention
  leaves stay within 7.2e-3.)
* ``moe_block``'s aux loss against the reference ``moe_block``'s on one
  layer: within 1e-7 relative (fp32, the same rounding points).
* ``Trainer`` with an ``extra_batch`` hook on reduced qwen2-vl-2b, two
  micro-batches: the step's loss is the mean of ``train_loss`` on each
  micro-batch's rows of the batch and its extras (``mrope_pos`` split on
  its batch axis, 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import get_model  # noqa: E402
from repro.models import blocks_attn as JBA  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import DecoderLM, blocks_attn  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,  # noqa: E402
                                  TrainerConfig, init)
from repro_torch.training.optimizer import leaves  # noqa: E402
from test_torch_moe import _layer, jrun  # noqa: E402
from test_torch_train_hybrid import names  # noqa: E402

VLM = "qwen2-vl-2b"
GRAD_TOL = 3e-2
# a token's K-th less its (K+1)-th router logit, over its row's largest
# |logit|, below which the two sides' fp32 sums in another order alone
# could pick other experts
NEAR_TIE = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch):
    """(JAX model, JAX params, port cfg) of a reduced config."""
    jmodel, _, jparams = get_model(arch)
    return jmodel, jparams, reduced(ARCHS[arch])


def mm_batch(cfg, b, t):
    """The multimodal batch of ``tests/test_arch_smoke.py``'s prefill."""
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t))
    return dict(mm_embeds=np.full((b, t, cfg.d_model), 0.05, np.float32),
                mm_mask=np.broadcast_to(np.arange(t)[None] < 2, (b, t)).copy(),
                mrope_pos=np.stack([pos] * 3))


@pytest.mark.parametrize("name", ["dbrx-132b", "qwen3-moe-235b-a22b", VLM])
def test_loss_and_grads_match_jax(name, monkeypatch):
    jmodel, jparams, cfg = _models(name)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    mm = mm_batch(cfg, 2, 64) if name == VLM else {}
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.train_loss))(
        jparams, tok, tgt, **mm)
    gaps = []
    route = blocks_attn.moe_route

    def spy(tok_, router, **kw):
        with torch.no_grad():
            srt = (tok_.float() @ router.float()).sort(-1, descending=True)
        k, v = kw["top_k"], srt.values
        gaps.append(float(((v[:, k - 1] - v[:, k]) /
                           v.abs().amax(-1)).min()))
        return route(tok_, router, **kw)

    monkeypatch.setattr(blocks_attn, "moe_route", spy)
    model = DecoderLM(cfg)
    params = params_from_numpy(_np(jparams), cfg, "cpu", master=True)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = model.train_loss(params, torch.from_numpy(tok),
                            torch.from_numpy(tgt),
                            **{k: torch.from_numpy(v) for k, v in mm.items()})
    loss.backward()
    assert len(gaps) == (2 * cfg.num_layers if model.is_moe else 0)
    assert min(gaps, default=1.0) > NEAR_TIE, gaps
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-3
    want = params_from_numpy(_np(jgrads), cfg, "cpu", master=True)
    for leaf, ours, theirs in zip(names(params), leaves(params),
                                  leaves(want)):
        rel = float((ours.grad - theirs).norm() / theirs.norm())
        assert rel <= GRAD_TOL, (leaf, rel)


def test_moe_aux_matches_jax():
    cfg, jl, pl = _layer("dbrx", scale=1.0)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 24, cfg.d_model)), jnp.bfloat16)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
              capacity_factor=cfg.capacity_factor, norm_eps=cfg.norm_eps)
    ref, jaux = jrun(JBA.moe_block, jl, x, aux_weight=0.01, **kw)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    out, aux = blocks_attn.moe_block(pl, xt, aux_weight=0.01, **kw)
    assert torch.equal(out, blocks_attn.moe_block(pl, xt, **kw))
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(float(aux) - float(jaux)) <= 1e-7 * abs(float(jaux))


def test_trainer_splits_the_extra_batch_per_micro_batch(tmp_path):
    cfg = reduced(ARCHS[VLM])
    data = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=4,
                       mode="markov")
    rng = np.random.default_rng(4)

    def extra_batch(tokens):
        b, t = tokens.shape
        mm = mm_batch(cfg, b, t)
        mm["mm_embeds"] = mm["mm_embeds"] + 0.02 * rng.standard_normal(
            mm["mm_embeds"].shape).astype(np.float32)
        mm["mrope_pos"][1:, :, :2] = [[[0, 1]]]       # a 1 x 2 image grid
        return mm

    seen = []
    tr = Trainer(DecoderLM(cfg), AdamWConfig(lr=1e-2, warmup_steps=5),
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                               micro_batches=2),
                 extra_batch=lambda tokens: seen.append(extra_batch(tokens))
                 or seen[-1])
    params = tr.model.init(0, device="cpu", master=True)
    tokens, targets = (torch.from_numpy(v) for v in data.batch_at(0))
    _, _, hist = tr.run(params, init(params), data, num_steps=1)
    ex = {k: torch.from_numpy(v) for k, v in seen[0].items()}
    with torch.no_grad():
        p0 = tr.model.init(0, device="cpu", master=True)
        want = [float(tr.model.train_loss(
            p0, tokens[i:i + 2], targets[i:i + 2],
            mm_embeds=ex["mm_embeds"][i:i + 2],
            mm_mask=ex["mm_mask"][i:i + 2],
            mrope_pos=ex["mrope_pos"][:, i:i + 2])) for i in (0, 2)]
    assert np.isfinite(hist).all()
    assert abs(hist[0] - np.mean(want)) <= 1e-6, (hist, want)
