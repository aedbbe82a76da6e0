"""The paged decode kernel's plain PyTorch version against the JAX kernel
(Pallas in interpret mode) and its oracle ``paged_decode_attention_ref``,
on the cases of ``test_kernel_paged.py`` and the ones the padded serve path
adds: invalid table entries with SENTINEL page positions, pad and killed
rows whose position is SENTINEL, a row with no visible slot (mean(V) over
every slot: no zero-row guard), and a kv_view that is one strided layer of
a (VP, L, ...) pool.

Tolerances: bf16 2e-2 (a few bf16 ulps at |out| ~ 1, summed in another
order), fp32 2e-5 (the JAX tests' own bound: online vs two-pass softmax in
fp32), 3e-5 for the page-permutation property as in the JAX test. The CUDA
kernel itself runs only on the card: its test is marked ``cuda`` and skips
here.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import hypothesis.strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.kernels.paged_attention.kernel import \
    paged_decode_attention as jax_kernel  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.paged_attention.kernel import check_inputs  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402

from test_kernel_paged import make_case  # noqa: E402

SENTINEL = 1 << 29


def t(a):
    return tensor_from_numpy(np.asarray(a))


def port(case, **kw):
    return paged_decode_attention_plain(*(t(a) for a in case), **kw)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a.float() if hasattr(a, "float")
                                          else a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,kvl,g,d,tpp,n_pages", [
    (2, 1, 4, 32, 8, 4),
    (3, 2, 2, 64, 16, 3),
    (1, 4, 1, 128, 8, 6),
])
def test_plain_matches_jax_kernel_and_ref(b, kvl, g, d, tpp, n_pages, dtype):
    case = make_case(b, kvl, g, d, tpp, n_pages, vp=n_pages * b + 3,
                     dtype=dtype)
    out = port(case)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    close(out, jax_kernel(*case, interpret=True), tol)
    close(out, jax_ref(*case), tol)


@pytest.mark.parametrize("window", [4, 16])
def test_plain_sliding_window(window):
    case = make_case(2, 1, 2, 32, 8, 5, vp=16, window=window)
    out = port(case, window=window)
    close(out, jax_kernel(*case, window=window, interpret=True), 2e-5)
    close(out, jax_ref(*case, window=window), 2e-5)


@settings(max_examples=15, deadline=None, database=None)
@given(seed=st.integers(0, 1000), tpp=st.sampled_from([8, 16]),
       n_pages=st.integers(2, 6))
def test_page_id_permutation_invariance(seed, tpp, n_pages):
    """Exec page ids are arbitrary: moving every page's content to a
    permuted slot of the pool and renaming the tables changes nothing."""
    vp = 24
    q, kv, tables, page_pos, positions = make_case(2, 1, 2, 32, tpp,
                                                   n_pages, vp, seed=seed)
    perm = np.random.default_rng(seed + 1).permutation(vp)
    kv2 = np.asarray(kv)[np.argsort(perm)]
    tables2 = perm[np.asarray(tables)].astype(np.int32)
    out1 = port((q, kv, tables, page_pos, positions))
    out2 = port((q, kv2, tables2, page_pos, positions))
    close(out1, out2, 3e-5)
    close(out2, jax_ref(q, kv, tables, page_pos, positions), 3e-5)


def _serve_like(dtype=np.float32, seed=3):
    """A padded decode batch as the serve path builds it: rows of different
    lengths, unused table entries -1 with SENTINEL page_pos, one freed entry
    inside a row; row 3 is a pad/killed row (tables -1, position SENTINEL)
    and row 4 a row whose pages all lie in its future."""
    rng = np.random.default_rng(seed)
    b, kvl, g, d, tpp, p, vp = 5, 2, 3, 32, 4, 8, 40
    q = rng.standard_normal((b, kvl, g, d)).astype(dtype)
    kv = rng.standard_normal((vp, 2, tpp, kvl, d)).astype(dtype)
    tables = np.full((b, p), -1, np.int32)
    page_pos = np.full((b, p), SENTINEL, np.int32)
    positions = np.full((b,), SENTINEL, np.int32)
    pool = rng.permutation(vp)
    for bi, n in enumerate((5, 13, 30)):            # n = query position
        npg = n // tpp + 1
        tables[bi, :npg] = pool[bi * p:bi * p + npg]
        page_pos[bi, :npg] = np.arange(npg) * tpp
        positions[bi] = n
    tables[1, 1] = -1                               # a freed entry
    page_pos[1, 1] = SENTINEL
    tables[4, :2] = pool[-2:]
    page_pos[4, :2] = (40, 44)
    positions[4] = 2
    return q, kv, tables, page_pos, positions


@pytest.mark.parametrize("window", [0, 8])
def test_plain_invalid_entries_and_pad_rows_match_ref(window):
    case = _serve_like()
    out = port(case, window=window)
    close(out, jax_ref(*case, window=window), 2e-5)
    close(out, jax_kernel(*case, window=window, interpret=True), 2e-5)
    q, kv, tables, page_pos, positions = case
    shape = q.shape[1:]
    # the pad row's SENTINEL position equals its SENTINEL page starts, so
    # slot 0 of every clamped entry (page 0) is visible: V[page 0, slot 0]
    close(out[3], np.broadcast_to(kv[0, 1, 0][:, None, :], shape), 2e-5)
    # no visible slot at all: mean(V) over every P*TPP slot, the -1
    # entries clamped to page 0 (no zero-row guard)
    v = kv[np.maximum(tables[4], 0), 1].reshape(-1, *kv.shape[3:])
    close(out[4], np.broadcast_to(v.mean(axis=0)[:, None, :], shape), 2e-5)


def test_plain_bf16_pad_rows_match_ref():
    case = _serve_like()
    case = tuple(jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
                 else a for a in case)
    close(port(case), jax_ref(*case), 2e-2)


def test_strided_layer_view_reads_the_pool_in_place():
    """kv_view = buffer.view(VP, L, 2, TPP, KVL, D)[:, layer]: a strided
    view whose page stride spans all L layers. The wrapper's checks accept
    it as it is, and the result equals the ref on a contiguous copy of
    that layer."""
    rng = np.random.default_rng(7)
    b, kvl, g, d, tpp, p, vp, n_layers = 3, 2, 2, 16, 4, 6, 20, 5
    pool = rng.standard_normal((vp, n_layers, 2, tpp, kvl, d)).astype(
        np.float32)
    buf = t(pool).to(torch.bfloat16).reshape(-1)
    q, _, tables, page_pos, positions = make_case(b, kvl, g, d, tpp, p, vp,
                                                  seed=7)
    qt = t(q).to(torch.bfloat16)
    for layer in (0, 3):
        view = buf.view(vp, n_layers, 2, tpp, kvl, d)[:, layer]
        assert not view.is_contiguous()
        assert view.stride(0) == n_layers * 2 * tpp * kvl * d
        args = (qt, view, t(tables), t(page_pos), t(positions))
        check_inputs(*args)
        out = paged_decode_attention_plain(*args)
        layer_np = np.asarray(view.float()).astype(np.float32)
        ref = jax_ref(jnp.asarray(np.asarray(qt.float()), jnp.bfloat16),
                      jnp.asarray(layer_np, jnp.bfloat16), tables, page_pos,
                      positions)
        close(out, ref, 2e-2)


def test_wrapper_takes_plain_version_on_cpu_only():
    case = tuple(t(a) for a in _serve_like())
    q, kv = (a.to(torch.bfloat16) for a in case[:2])
    args = (q, kv) + case[2:]
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, window=8)
    assert paged_decode_attention.launches == before      # no kernel here
    assert torch.equal(out, paged_decode_attention_plain(*args, window=8))
    with pytest.raises(ValueError):
        paged_decode_attention(*(a.to("meta") for a in args))


def test_check_inputs_rejects_what_the_kernel_does_not_take():
    q, kv, tables, page_pos, positions = (t(a) for a in _serve_like())
    q, kv = q.to(torch.bfloat16), kv.to(torch.bfloat16)
    assert check_inputs(q, kv, tables, page_pos, positions) == \
        (5, 2, 3, 32, 8, 4)
    bad = [
        (q.float(), kv, tables, page_pos, positions),          # dtype
        (q.transpose(1, 2).contiguous().transpose(1, 2), kv, tables,
         page_pos, positions),                                 # strided q
        (q, kv[..., :16], tables, page_pos, positions),        # shape
        (q, kv, tables.long(), page_pos, positions),           # int64
        (q, kv, tables.t().contiguous().t(), page_pos,
         positions),                                           # strided
        (q, kv, tables, page_pos[:, :4], positions),           # table shape
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            check_inputs(*args)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card: a strided
    layer of the pool, a window, invalid entries and pad rows (mean(V)),
    head dims 64 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    dev = torch.device("cuda")
    for d, g, window in ((64, 4, 0), (64, 4, 8), (128, 5, 0)):
        q, kv, tables, page_pos, positions = _serve_like()
        rng = np.random.default_rng(d + g)
        q = rng.standard_normal(q.shape[:2] + (g, d)).astype(np.float32)
        pool = rng.standard_normal((kv.shape[0], 3) + kv.shape[1:4] +
                                   (d,)).astype(np.float32)
        view = t(pool).to(dev, torch.bfloat16)[:, 1]
        args = (t(q).to(dev, torch.bfloat16), view) + tuple(
            t(a).to(dev) for a in (tables, page_pos, positions))
        before = paged_decode_attention.launches
        out = paged_decode_attention(*args, window=window)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        ref = paged_decode_attention_plain(*args, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        assert err < 2e-2, (d, g, window, err)
