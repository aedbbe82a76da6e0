"""The dense flash kernel's plain PyTorch version against the JAX kernel
``flash_attention_tpu`` (Pallas in interpret mode) and its oracle
``flash_attention_ref``, forward and gradients; the wrappers' argument
checks; and the kernels against the plain version on the card (marked
``cuda``, skipped without one).

Tolerances: fp32 forward 3e-5 (the JAX tests' own bound: online vs
two-pass softmax in fp32); fp32 gradients 1e-4 abs against ``jax.grad``
of the oracle (the same function differentiated by two frameworks: sums
of up to S terms of O(1) products taken in another order). GQA: the JAX
side takes K/V repeated G times, the port maps q head h to kv head h // G.
On the card, bf16 outputs within 2e-2 abs and bf16 gradients within 1e-2
of the largest |gradient| (a few bf16 ulps, summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    dense_flash_attention, dense_flash_bwd, dense_flash_fwd,
    flash_attention_plain)
from repro_torch.kernels.flash_attention.dense import (  # noqa: E402
    check_inputs, flash_lse_plain)


def _inputs(seed, bh, kvh, t, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, t, d)).astype(np.float32),
            rng.standard_normal((kvh, s, d)).astype(np.float32),
            rng.standard_normal((kvh, s, d)).astype(np.float32))


def _rep(a, g):
    return jnp.repeat(jnp.asarray(a), g, 0)


CASES = [
    # (bh, kvh, t, s, d, causal, window, blk)
    (2, 2, 128, 128, 64, True, 0, 64),
    (4, 2, 128, 128, 64, True, 16, 64),       # GQA G=2, window
    (4, 1, 64, 64, 128, True, 0, 32),         # D 128, G=4
    (2, 1, 64, 64, 128, False, 0, 32),        # non-causal (encoder)
    (2, 2, 128, 128, 64, False, 24, 64),      # non-causal with a window
]


@pytest.mark.parametrize("bh,kvh,t,s,d,causal,window,blk", CASES)
def test_plain_matches_jax_kernel_and_ref(bh, kvh, t, s, d, causal, window,
                                          blk):
    q, k, v = _inputs(11, bh, kvh, t, s, d)
    g = bh // kvh
    ours = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window).numpy()
    jq, jk, jv = jnp.asarray(q), _rep(k, g), _rep(v, g)
    kern = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                               blk_q=blk, blk_k=blk, interpret=True)
    ref = flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    for other in (kern, ref):
        np.testing.assert_allclose(ours, np.asarray(other), atol=3e-5,
                                   rtol=3e-5)


@pytest.mark.parametrize("bh,kvh,t,s,d,causal,window", [
    (4, 2, 64, 64, 64, True, 0),
    (4, 2, 64, 64, 64, True, 12),
    (2, 1, 48, 48, 128, False, 0),
    (2, 2, 40, 24, 16, True, 8),   # T > S + window - 1: rows that see nothing
])
def test_plain_grads_match_jax_grad(bh, kvh, t, s, d, causal, window):
    q, k, v = _inputs(3, bh, kvh, t, s, d)
    w = np.random.default_rng(4).standard_normal((bh, t, d)).astype(
        np.float32)
    g = bh // kvh

    def jloss(q_, k_, v_):
        out = flash_attention_ref(q_, jnp.repeat(k_, g, 0),
                                  jnp.repeat(v_, g, 0), causal=causal,
                                  window=window)
        return jnp.sum(out * w)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_plain(*leaves, causal=causal, window=window)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5,
                               atol=1e-4)
    for ours, theirs in zip(leaves, jg):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs),
                                   atol=1e-4, rtol=1e-4)


def test_empty_rows_give_mean_v_and_lse():
    """T > S + window - 1: rows that see nothing get mean(V) over all S
    columns, as the TPU kernel's -1e30 masking gives; lse is the row's
    log-sum-exp of its masked scores."""
    q, k, v = _inputs(5, 2, 2, 40, 24, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=True, window=8)
    tail = slice(24 + 8 - 1, 40)
    np.testing.assert_allclose(out[:, tail].numpy(),
                               np.broadcast_to(v.mean(1)[:, None],
                                               out[:, tail].shape),
                               atol=1e-6)
    ref = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    lse = flash_lse_plain(tq, tk, causal=True, window=8)
    d = 16
    logit = np.einsum("btd,bsd->bts", q, k) / d ** 0.5
    qp, kp = np.arange(40)[:, None], np.arange(24)[None]
    mask = (kp <= qp) & (kp > qp - 8)
    row = np.where(mask[None], logit, -np.inf)
    vis = mask.any(1)
    want = np.log(np.exp(row[:, vis] - row[:, vis].max(-1, keepdims=True))
                  .sum(-1)) + row[:, vis].max(-1)
    np.testing.assert_allclose(lse.numpy()[:, vis], want, rtol=1e-5)


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def test_wrappers_on_cpu_take_the_plain_version():
    """CPU tensors: the forward gives the plain output and lse, the
    backward autograd through the plain version, and no launch counts."""
    q, k, v = _bf16(4, 40, 16), _bf16(2, 40, 16, seed=1), \
        _bf16(2, 40, 16, seed=2)
    dout = _bf16(4, 40, 16, seed=3)
    fwd0, bwd0 = dense_flash_fwd.launches, dense_flash_bwd.launches
    out, lse = dense_flash_fwd(q, k, v, window=8)
    assert torch.equal(out, flash_attention_plain(q, k, v, window=8))
    assert torch.equal(lse, flash_lse_plain(q, k, window=8))
    grads = dense_flash_bwd(q, k, v, out, lse, dout, window=8)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    o2 = dense_flash_attention(*leaves, window=8)
    assert torch.equal(o2, out)
    for a, b in zip(torch.autograd.grad(o2, leaves, dout), grads):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert (dense_flash_fwd.launches, dense_flash_bwd.launches) == \
        (fwd0, bwd0)


def test_argument_checks_raise():
    q, k, v = _bf16(4, 32, 64), _bf16(2, 32, 64), _bf16(2, 32, 64)
    assert check_inputs(q, k, v) == (4, 32, 32, 64, 2)
    with pytest.raises(TypeError, match="dtype"):
        dense_flash_attention(q.float(), k, v)
    with pytest.raises(TypeError, match="dtype"):
        dense_flash_fwd(q, k.half(), v)
    with pytest.raises(ValueError, match="head dim"):
        dense_flash_attention(_bf16(4, 32, 48), _bf16(2, 32, 48),
                              _bf16(2, 32, 48))
    with pytest.raises(ValueError, match="kv heads"):
        dense_flash_attention(_bf16(3, 32, 64), k, v)
    with pytest.raises(ValueError, match="shape"):
        dense_flash_attention(q, k, _bf16(2, 31, 64))
    with pytest.raises(ValueError, match="contiguous"):
        dense_flash_attention(_bf16(32, 4, 64).transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="aligned"):
        flat = _bf16(4 * 32 * 64 + 1)
        dense_flash_attention(flat[1:].view(4, 32, 64), k, v)
    with pytest.raises(ValueError, match="window"):
        dense_flash_attention(q, k, v, window=-1)
    out, lse = dense_flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        dense_flash_bwd(q, k, v, out, lse.double(), out)
    with pytest.raises(ValueError, match="dout: shape"):
        dense_flash_bwd(q, k, v, out, lse, out[:, :16].contiguous())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Forward, gradients and bitwise-repeatable backward of the CUDA
    kernels against the plain version (``chip_smoke.py`` phase 2b runs the
    same comparison at the training shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for bh, kvh, t, s, d, causal, window in [
            (8, 2, 300, 300, 64, True, 0), (4, 2, 333, 200, 32, True, 50),
            (4, 2, 128, 128, 128, False, 0), (4, 4, 96, 96, 16, True, 7)]:
        q = _bf16(bh, t, d).to(dev)
        k, v = _bf16(kvh, s, d, seed=1).to(dev), _bf16(kvh, s, d,
                                                       seed=2).to(dev)
        dout = _bf16(bh, t, d, seed=3).to(dev)
        kw = dict(causal=causal, window=window)
        out, lse = dense_flash_fwd(q, k, v, **kw)
        grads = dense_flash_bwd(q, k, v, out, lse, dout, **kw)
        again = dense_flash_bwd(q, k, v, out, lse, dout, **kw)
        leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
        ref = flash_attention_plain(*leaves, **kw)
        refg = torch.autograd.grad(ref, leaves, dout)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        for a, b, c in zip(grads, again, refg):
            assert torch.equal(a, b)
            scale = max(1.0, c.float().abs().max().item())
            assert (a.float() - c.float()).abs().max().item() <= 1e-2 * scale
