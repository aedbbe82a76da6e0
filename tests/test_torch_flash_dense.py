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
A tiled emulation of the tensor-core kernels' arithmetic (bf16 products
into fp32, P and dS rounded to bf16 before their products) is held to
those same card tolerances on the CPU.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    dense_flash_attention, dense_flash_bwd, dense_flash_fwd,
    flash_attention_plain)
from repro_torch.kernels.flash_attention.dense import (  # noqa: E402
    check_inputs, dense_mask, flash_lse_plain)


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


# ---------------------------------------------------------------------------
# The tensor-core kernels' arithmetic, emulated tile by tile on the CPU.
LOG2E = 1.4426950408889634
MASKED2 = -1e30 * LOG2E       # a masked score, in log2 units
FWD_KV_TILE = 128             # kv rows per forward tile
DKV_Q_TILE = 64               # q rows per dK/dV tile
DQ_KV_TILE = 64               # kv rows per dQ tile
TOL, GRAD_TOL = 2e-2, 1e-2    # chip_smoke.py's card tolerances


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, causal, window):
    """bf16 q, k, v stay unscaled; scores are fp32 products scaled after
    the product into log2 units; the online softmax runs over kv tiles of
    FWD_KV_TILE in order; P is rounded to bf16 before P V while the row sum
    adds the fp32 P. Returns (out bf16, lse fp32)."""
    g = q.shape[0] // k.shape[0]
    t, s, d = q.shape[1], k.shape[1], q.shape[2]
    qf = q.float()
    kf, vf = (a.repeat_interleave(g, 0).float() for a in (k, v))
    sl2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * LOG2E
    mask = dense_mask(t, s, causal, window, q.device)
    m = torch.full(q.shape[:2], MASKED2)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros(q.shape)
    for j0 in range(0, s, FWD_KV_TILE):
        j1 = min(j0 + FWD_KV_TILE, s)
        sc = torch.einsum("btd,bsd->bts", qf, kf[:, j0:j1]) * sl2
        sc = torch.where(mask[None, :, j0:j1], sc, torch.tensor(MASKED2))
        mn = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.exp2(sc - mn[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bts,bsd->btd", _bf(p), vf[:, j0:j1])
        m = mn
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)
    return out, (m + torch.log2(l)) * math.log(2.0)


def _emulate_bwd(q, k, v, out, lse, dout, causal, window):
    """P = exp2(S * scale * log2e - lse * log2e) and dS = P (dP - delta)
    in fp32, rounded to bf16 before dV += P^T dO, dK += dS^T Q (q tiles of
    DKV_Q_TILE, the G q heads of a kv head in order) and dQ += dS K (kv
    tiles of DQ_KV_TILE); dK and dQ are scaled once at the end; rows that
    see nothing add their 1/S share of dO to every dV row."""
    kvh, s, d = k.shape
    bh, t = q.shape[:2]
    g = bh // kvh
    qf, of = q.float(), dout.float()
    kf, vf = (a.repeat_interleave(g, 0).float() for a in (k, v))
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    mask = dense_mask(t, s, causal, window, q.device)
    delta = (out.float() * of).sum(-1)
    sc = torch.einsum("btd,bsd->bts", qf, kf)
    p = torch.exp2(sc * (scale * LOG2E) - (lse * LOG2E)[..., None])
    p = torch.where(mask[None], p, torch.zeros(()))
    dp = torch.einsum("btd,bsd->bts", of, vf)
    ds = p * (dp - delta[..., None])
    pb, dsb = _bf(p), _bf(ds)
    dk = torch.zeros((kvh, s, d))
    dv = torch.zeros((kvh, s, d))
    for hq in range(bh):
        for i0 in range(0, t, DKV_Q_TILE):
            i1 = min(i0 + DKV_Q_TILE, t)
            dv[hq // g] += pb[hq, i0:i1].T @ of[hq, i0:i1]
            dk[hq // g] += dsb[hq, i0:i1].T @ qf[hq, i0:i1]
    dq = torch.zeros(q.shape)
    for j0 in range(0, s, DQ_KV_TILE):
        j1 = min(j0 + DQ_KV_TILE, s)
        dq += torch.einsum("bts,bsd->btd", dsb[:, :, j0:j1], kf[:, j0:j1])
    if window > 0 and s + window - 1 < t:
        tail = of[:, s + window - 1:].sum(1).view(kvh, g, d).sum(1)
        dv += tail[:, None, :] / s
    return tuple(a.to(torch.bfloat16) for a in (dq * scale, dk * scale, dv))


# chip_smoke.py's dense_cases() at reduced sizes: (bh, kvh, t, s, d,
# causal, window)
EMULATED_CASES = {
    "granite D=64 G=4 causal": (8, 2, 256, 256, 64, True, 0),
    "window": (8, 2, 320, 320, 64, True, 96),
    "non-causal": (8, 2, 192, 192, 64, False, 0),
    "internlm2 D=128 G=2": (4, 2, 256, 256, 128, True, 0),
    "ragged T > S + window D=32": (4, 2, 333, 200, 32, True, 50),
}


@pytest.mark.parametrize("case", list(EMULATED_CASES))
def test_tensor_core_rounding_fits_card_tolerances(case):
    """The kernels round P and dS to bf16 before their products and scale
    the fp32 scores after the product; an emulation of exactly that, tile
    by tile, stays within the card's TOL (output) and GRAD_TOL (gradients,
    of the largest |gradient|) of the plain version. The tolerances are
    chip_smoke.py's, unchanged: bf16 outputs a few ulps off, the bf16
    rounding of P and dS adding relative errors of 2^-9 per term that
    average out over the sums."""
    bh, kvh, t, s, d, causal, window = EMULATED_CASES[case]
    rng = np.random.default_rng(17)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in (
            (bh, t, d), (kvh, s, d), (kvh, s, d), (bh, t, d)))
    out, lse = _emulate_fwd(q, k, v, causal, window)
    grads = _emulate_bwd(q, k, v, out, lse, dout, causal, window)

    leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
    ref = flash_attention_plain(*leaves, causal=causal, window=window)
    ref_grads = torch.autograd.grad(ref, leaves, dout)
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    ref_lse = flash_lse_plain(q, k, causal=causal, window=window)
    seen = dense_mask(t, s, causal, window, q.device).any(-1)
    torch.testing.assert_close(lse[:, seen], ref_lse[:, seen], rtol=0,
                               atol=1e-4)
    for ours, theirs in zip(grads, ref_grads):
        bound = GRAD_TOL * max(1.0, theirs.float().abs().max().item())
        assert (ours.float() - theirs.float()).abs().max().item() <= bound
