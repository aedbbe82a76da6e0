"""The varlen flash kernel's plain PyTorch version against the JAX kernel
(Pallas in interpret mode) and its masked-softmax oracle, on the cases of
``test_kernels_flash_mamba.py`` and ``test_kernel_attention.py``; plus the
packed serve-path wrapper and the segment-mask property.

Tolerances: fp32 inputs 3e-5 (the JAX tests' own bound: online vs
two-pass softmax in fp32); bf16 packed-path outputs 2e-2 (a few bf16 ulps
at |out| ~ 1, with a different summation order). The CUDA kernel itself
runs only on the card: its test is marked ``cuda`` and skips here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_varlen_tpu  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_varlen_ref  # noqa: E402
from repro.models import blocks_attn as JBA  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_varlen, flash_attention_varlen_plain)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks_attn as BA  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402

from test_kernel_attention import packed_case  # noqa: E402
from test_kernels_flash_mamba import _packed_layout  # noqa: E402


def t(a):
    return tensor_from_numpy(np.asarray(a))


def _inputs(seed, bh, t_, s, d, n_seg=4, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or bh
    q = rng.standard_normal((bh, t_, d)).astype(np.float32)
    k = rng.standard_normal((kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((kvh, s, d)).astype(np.float32)
    return (q, k, v) + _packed_layout(rng, t_, s, n_seg)


def _jax_rep(q, k, v):
    """JAX streams repeat kv heads per q group (kv head h -> q heads
    h*G .. h*G+G-1), the port's kernel maps them by index."""
    g = q.shape[0] // k.shape[0]
    return jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, 0), \
        jnp.repeat(jnp.asarray(v), g, 0)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("bh,kvh,t_,s,d,blk", [
    (2, 2, 128, 128, 64, 64),
    (1, 1, 128, 256, 32, 64),
    (4, 1, 64, 96, 16, 32),          # GQA: 4 q heads on one kv head
])
def test_plain_matches_jax_kernel_and_ref(bh, kvh, t_, s, d, blk, window):
    q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(7, bh, t_, s, d,
                                                    kvh=kvh)
    meta = (q_seg, kv_seg, q_pos, kv_pos)
    ours = flash_attention_varlen_plain(t(q), t(k), t(v),
                                        *map(t, meta), window=window)
    jq, jk, jv = _jax_rep(q, k, v)
    jm = tuple(map(jnp.asarray, meta))
    kern = flash_attention_varlen_tpu(jq, jk, jv, *jm, window=window,
                                      blk_q=blk, blk_k=blk, interpret=True)
    ref = flash_attention_varlen_ref(jq, jk, jv, *jm, window=window)
    valid = q_seg >= 0
    for other in (kern, ref):
        np.testing.assert_allclose(ours.numpy()[:, valid],
                                   np.asarray(other)[:, valid],
                                   atol=3e-5, rtol=3e-5)


def test_plain_no_cross_segment_leak():
    """Scrambling one segment's K/V leaves every other segment's rows
    unchanged (direct no-leak check, independent of the oracle)."""
    q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(11, 1, 64, 64, 32,
                                                    n_seg=3)
    meta = tuple(map(t, (q_seg, kv_seg, q_pos, kv_pos)))
    base = flash_attention_varlen_plain(t(q), t(k), t(v), *meta).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, kv_seg == 0] = 1e3
    v2[:, kv_seg == 0] = -1e3
    pert = flash_attention_varlen_plain(t(q), t(k2), t(v2), *meta).numpy()
    others = q_seg > 0
    assert np.array_equal(base[:, others], pert[:, others])
    assert not np.array_equal(base[:, q_seg == 0], pert[:, q_seg == 0])


def test_plain_rows_without_visible_slot_are_exactly_zero():
    """Pad rows (seg -1 against kv pads -2) and a segment whose only slots
    lie in its future come out exactly 0.0 — in JAX's kernel too."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 16)).astype(np.float32)
    q_seg = np.array([0] * 6 + [1] * 4 + [-1] * 6, np.int32)
    q_pos = np.array(list(range(6)) + [0, 1, 2, 3] + [0] * 6, np.int32)
    kv_seg = np.array([0] * 12 + [1] * 4 + [-2] * 8, np.int32)
    kv_pos = np.array(list(range(12)) + [10, 11, 12, 13] + [0] * 8,
                      np.int32)
    meta = (q_seg, kv_seg, q_pos, kv_pos)
    ours = flash_attention_varlen_plain(t(q), t(k), t(v),
                                        *map(t, meta)).numpy()
    kern = np.asarray(flash_attention_varlen_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *map(jnp.asarray, meta), blk_q=8, blk_k=8))
    empty = q_seg != 0
    assert (ours[:, empty] == 0.0).all()
    assert (kern[:, empty] == 0.0).all()
    np.testing.assert_allclose(ours[:, ~empty], kern[:, ~empty],
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_packed_kernel_attention_matches_jax(window):
    """The port's one-call packed path (chunk-start gating by scatter-max,
    kv heads NOT repeated) vs the JAX kernel route on the hand-built packed
    step of ``test_kernel_attention.packed_case``."""
    q, k, v, kf, vf, seg, pos, cs, sseg, spos = packed_case()
    meta = BA.packed_attention_meta(t(spos), t(sseg), t(pos), t(seg), t(cs))
    ours = BA.packed_kernel_attention(t(q), t(k), t(v), t(kf), t(vf), meta,
                                      window=window)
    ref = JBA.packed_kernel_attention(q, k, v, spos, sseg, kf, vf, pos,
                                      seg, cs, window=window)
    rows = np.asarray(seg[0]) >= 0
    diff = np.abs(ours.float().numpy()[0, rows]
                  - np.asarray(ref, np.float32)[0, rows])
    assert diff.max() < 2e-2, diff.max()


def test_wrapper_takes_plain_version_on_cpu_only():
    q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(5, 2, 32, 48, 16)
    args = [t(x).to(torch.bfloat16) for x in (q, k, v)] + \
        [t(x) for x in (q_seg, kv_seg, q_pos, kv_pos)]
    before = flash_attention_varlen.launches
    out = flash_attention_varlen(*args, blk_q=8, blk_k=16)
    assert flash_attention_varlen.launches == before    # no kernel here
    assert torch.equal(out, flash_attention_varlen_plain(*args))
    with pytest.raises(ValueError):
        flash_attention_varlen(*(a.to("meta") for a in args))


def test_segment_mask_property():
    """Hypothesis: for random packed layouts, token i never sees a slot of
    another segment, a future position of its own segment, nor (with
    chunk_start) a slot at or after its chunk start; pads match nothing.
    kv pads are drawn as -2 only: the mask compares ids with ``==``, so a
    q pad (-1) DOES see a kv slot tagged -1, by the reference's design."""
    pytest.importorskip("hypothesis")
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @settings(max_examples=30, deadline=None, database=None)
    @given(st.data())
    def check(data):
        n_seg = data.draw(st.integers(1, 4))
        lens = [data.draw(st.integers(1, 6)) for _ in range(n_seg)]
        starts = [data.draw(st.integers(0, 20)) for _ in range(n_seg)]
        q_seg, q_pos, cs = [], [], []
        for i, (ln, st0) in enumerate(zip(lens, starts)):
            q_seg += [i] * ln
            q_pos += list(range(st0, st0 + ln))
            cs += [st0] * ln
        pad = data.draw(st.integers(0, 3))
        q_seg += [-1] * pad
        q_pos += [1 << 29] * pad
        cs += [1 << 29] * pad
        s = data.draw(st.integers(1, 24))
        kv_seg = [data.draw(st.sampled_from([-2] + list(range(n_seg))))
                  for _ in range(s)]
        kv_pos = [data.draw(st.integers(0, 30)) for _ in range(s)]
        qs, qp, c = (np.array([x], np.int32) for x in (q_seg, q_pos, cs))
        ks, kp = (np.array([x], np.int32) for x in (kv_seg, kv_pos))
        for chunk in (None, c):
            m = A.segment_mask(t(qs), t(qp), t(ks), t(kp),
                               chunk_start=None if chunk is None
                               else t(chunk)).numpy()[0]
            lim = qp[0][:, None] if chunk is None else c[0][:, None] - 1
            allowed = (ks[0][None, :] == qs[0][:, None]) & \
                (qs[0][:, None] >= 0) & (kp[0][None, :] <= lim)
            assert np.array_equal(m, allowed)

    check()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card (GQA, window,
    pad rows, dead slots), exact zeros where no slot is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    dev = torch.device("cuda")
    for window in (0, 8):
        q, k, v, q_seg, q_pos, kv_seg, kv_pos = _inputs(
            1, 8, 200, 300, 64, kvh=2)
        args = [t(x).to(dev, torch.bfloat16) for x in (q, k, v)] + \
            [t(x).to(dev) for x in (q_seg, kv_seg, q_pos, kv_pos)]
        before = flash_attention_varlen.launches
        out = flash_attention_varlen(*args, window=window, blk_q=32,
                                     blk_k=64)
        assert flash_attention_varlen.launches == before + 1
        ref = flash_attention_varlen_plain(*args, window=window)
        valid = torch.tensor(q_seg >= 0, device=dev)
        err = (out.float() - ref.float())[:, valid].abs().max().item()
        assert err < 2e-2, err
