"""Port primitives against their JAX counterparts (CPU, small shapes).

Inputs come from a numpy seed and go to both packages. Tolerances, in fp32
after the op's own rounding:

* bf16 outputs (rms_norm, dense, MLP, rope): 1 bf16 ulp of the output's
  magnitude — both sides round one fp32 value that differs only by
  summation order or a last-bit difference of rsqrt/cos/sin;
* buffer gathers, writes and the sampler: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import UnifiedLayout as JLayout  # noqa: E402
from repro.core import attention_spec as j_attention_spec  # noqa: E402
from repro.core import make_geometry as j_make_geometry  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks_attn as JBA  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import rotary as JR  # noqa: E402
from repro.models.tp import shard_map, single_device_dist  # noqa: E402
from repro.serving import sampler as JS  # noqa: E402
from repro_torch.core import UnifiedLayout, attention_spec, make_geometry  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks_attn as BA  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import rotary as R  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402
from repro_torch.serving import sampler as S  # noqa: E402

BF16 = ml_dtypes.bfloat16


def bf16(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(BF16)


def t(a):
    return tensor_from_numpy(np.asarray(a))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_within_ulp(a, b, n=1):
    """|a - b| <= n bf16 ulps of max(|a|, |b|), elementwise."""
    a, b = f32(a), f32(b)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(1e-30))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(a - b) > n * ulp
    assert not bad.any(), (a[bad][:5], b[bad][:5])


# ------------------------------------------------------------ layer math
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = bf16(rng, (3, 7, 64))
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    assert_within_ulp(C.rms_norm(t(x), t(w), 1e-5),
                      JC.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_jax(bias):
    rng = np.random.default_rng(1)
    x = bf16(rng, (2, 9, 64))
    w = (0.05 * rng.standard_normal((64, 48))).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32) if bias else None
    ours = C.dense(t(x), t(w).to(torch.bfloat16),
                   None if b is None else t(b))
    ref = JC.dense(jnp.asarray(x), jnp.asarray(w),
                   None if b is None else jnp.asarray(b))
    assert ours.dtype == torch.bfloat16
    assert_within_ulp(ours, ref)


def test_mlp_block_matches_jax():
    rng = np.random.default_rng(2)
    d, ff = 64, 128
    x = bf16(rng, (1, 12, d))
    p = {"mlp_norm": np.ones(d, np.float32),
         "gate": (0.05 * rng.standard_normal((d, ff))).astype(np.float32),
         "up": (0.05 * rng.standard_normal((d, ff))).astype(np.float32),
         "down": (0.05 * rng.standard_normal((ff, d))).astype(np.float32)}
    ours = BA.mlp_block({k: t(v) for k, v in p.items()}, t(x))
    dist = single_device_dist()
    ref = shard_map(lambda pp, xx: JBA.mlp_block(pp, xx, dist),
                    mesh=dist.mesh, in_specs=(P(), P()), out_specs=P())(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    # the residual add rounds once more on both sides
    assert_within_ulp(ours, ref, n=2)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = bf16(rng, (1, 10, 4, 16))
    pos = np.array([[0, 1, 2, 5, 9, 100, 4095, 70000, 1 << 29, 3]],
                   np.int32)
    assert_within_ulp(R.apply_rope(t(x), t(pos), 1e6),
                      JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_heads_match_jax():
    """embed_lookup (bf16 rows), logits_local (fp32, never rounded to
    bf16) and the pad-vocab mask."""
    rng = np.random.default_rng(4)
    table = (0.02 * rng.standard_normal((40, 16))).astype(np.float32)
    tok = np.array([[0, 3, 39, 7]], np.int32)
    emb = TP.embed_lookup(t(tok), t(table).to(torch.bfloat16))
    assert np.array_equal(f32(emb), f32(jnp.asarray(table).astype(
        jnp.bfloat16)[tok]))
    x = bf16(rng, (5, 16))
    ours = TP.logits_local(t(x), t(table))
    ref = np.asarray(jnp.einsum("nd,vd->nv", jnp.asarray(x),
                                jnp.asarray(table).astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-7)
    masked = TP.mask_pad_vocab(ours, 33).numpy()
    assert (masked[:, 33:] == -1e30).all()
    assert np.array_equal(masked[:, :33], ours.numpy()[:, :33])


# ------------------------------------------------------------ attention
def test_attention_partials_match_jax():
    rng = np.random.default_rng(5)
    q = bf16(rng, (1, 6, 2, 2, 16))
    k = bf16(rng, (1, 9, 2, 16))
    v = bf16(rng, (1, 9, 2, 16))
    seg = np.array([[0, 0, 0, 1, 1, -1]], np.int32)
    pos = np.array([[0, 1, 2, 0, 1, 1 << 29]], np.int32)
    kseg = np.array([[0, 0, 0, 1, 1, -2, 1, -2, 0]], np.int32)
    kpos = np.array([[0, 1, 2, 0, 1, 0, 2, 0, 4]], np.int32)
    for kw in ({}, {"window": 2}, {"chunk_start": pos}):
        m_ours = A.segment_mask(t(seg), t(pos), t(kseg), t(kpos),
                                **{k: (t(v) if k == "chunk_start" else v)
                                   for k, v in kw.items()})
        m_ref = JA.segment_mask(jnp.asarray(seg), jnp.asarray(pos),
                                jnp.asarray(kseg), jnp.asarray(kpos), **kw)
        assert np.array_equal(m_ours.numpy(), np.asarray(m_ref))
    mask = JA.segment_mask(jnp.asarray(seg), jnp.asarray(pos),
                           jnp.asarray(kseg), jnp.asarray(kpos))
    o1, m1, l1 = A.attend_tokens(t(q), t(k), t(v), t(np.asarray(mask)))
    r1 = JA.attend_tokens(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask)
    for a, b in zip((o1, m1, l1), r1):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5)
    o2, m2, l2 = A.attend_tokens(t(q), t(v), t(k), t(np.asarray(mask)))
    r2 = JA.attend_tokens(jnp.asarray(q), jnp.asarray(v), jnp.asarray(k),
                          mask)
    merged = A.finalize_softmax(*A.merge_partials(o1, m1, l1, o2, m2,
                                                  l2)[::2])
    ref = JA.finalize_softmax(*JA.merge_partials(*r1, *r2)[::2])
    np.testing.assert_allclose(f32(merged), f32(ref), rtol=1e-5, atol=1e-5)


def _attn_view(rng, vp=6, nl=3, tpp=4, kvl=2, d=16):
    shape = (vp, nl, 2, tpp, kvl, d)
    flat = bf16(rng, (int(np.prod(shape)),))
    return shape, flat


def test_gather_pages_matches_jax_and_zeroes_invalid():
    rng = np.random.default_rng(6)
    shape, flat = _attn_view(rng)
    tables = np.array([[3, -1, 0, 5, -1]], np.int32)
    k, v = A.gather_pages(t(flat).view(shape), t(tables), 1)
    jk, jv = JA.gather_pages(jnp.asarray(flat).reshape(shape),
                             jnp.asarray(tables), 1)
    assert np.array_equal(f32(k), f32(jk))
    assert np.array_equal(f32(v), f32(jv))
    tpp = shape[3]
    assert (f32(k)[0, tpp:2 * tpp] == 0).all()        # entry -1 -> zeros
    assert (f32(v)[0, 4 * tpp:] == 0).all()


def test_write_token_kv_matches_jax_and_drops_to_scratch():
    """Live writes land exactly where JAX puts them; dropped writes
    (eid < 0) go to the scratch page only — every other byte is equal."""
    rng = np.random.default_rng(7)
    vp, nl, tpp, kvl, d = 6, 3, 4, 2, 16
    shape = (vp, nl, 2, tpp, kvl, d)
    page = nl * 2 * tpp * kvl * d
    flat = bf16(rng, (vp * page,))
    eids = np.array([[2, 2, -1, 0, -1]], np.int32)      # pages 0..4 live
    slots = np.array([[1, 2, 0, 3, 3]], np.int32)
    kn = bf16(rng, (1, 5, kvl, d))
    vn = bf16(rng, (1, 5, kvl, d))
    ours = t(flat.copy())
    A.write_token_kv(ours, shape, 2, t(eids), t(slots), t(kn), t(vn))
    ref = JA.write_token_kv(jnp.asarray(flat), shape, 2, jnp.asarray(eids),
                            jnp.asarray(slots), jnp.asarray(kn),
                            jnp.asarray(vn))
    ours, ref = f32(ours), f32(ref)
    body = slice(0, (vp - 1) * page)           # last page: the scratch page
    assert np.array_equal(ours[body], ref[body])
    assert not np.array_equal(ours[body], f32(flat)[body])   # writes landed
    scratch = ours[(vp - 1) * page:]
    assert not np.array_equal(scratch, f32(flat)[(vp - 1) * page:])
    row = kvl * d
    for tok, slot in ((2, 0), (4, 3)):          # the two dropped tokens
        off = int(A.view_offset(shape, vp - 1, 2, 0, slot)) - (vp - 1) * page
        assert np.array_equal(scratch[off:off + row],
                              f32(kn)[0, tok].reshape(-1))


def test_view_offset_is_int64():
    shape = (1 << 20, 40, 2, 16, 8, 64)
    off = A.view_offset(shape, torch.tensor([(1 << 20) - 1], dtype=torch.int32),
                        39, 1, 15)
    assert off.dtype == torch.int64
    assert int(off[0]) == int(np.prod(shape)) - 8 * 64


def test_layout_twin_matches_jax():
    spec = attention_spec("full_attn", num_layers=2, kv_heads=2,
                          head_dim=16, tokens_per_page=4)
    jspec = j_attention_spec("full_attn", num_layers=2, kv_heads=2,
                             head_dim=16, tokens_per_page=4)
    geo = make_geometry([spec], total_memory_bytes=1 << 20)
    jgeo = j_make_geometry([jspec], total_memory_bytes=1 << 20)
    shapes = {"full_attn": (2, 4, 2, 16)}
    lay, jlay = UnifiedLayout(geo, shapes), JLayout(jgeo, shapes)
    buf = lay.alloc_buffer("cpu")
    assert buf.dtype == torch.bfloat16 and buf.shape == (lay.total_units,)
    assert lay.views["full_attn"].view_shape == \
        jlay.views["full_attn"].view_shape
    view = lay.view(buf, "full_attn")
    view[1, 0, 0, 2] = 1.0
    assert float(lay.flatten(view, "full_attn").sum()) == 2 * 16


# ------------------------------------------------------------ sampler
def test_band_pick_and_board_match_jax():
    """Device band-argmax == host greedy_token == the JAX fused tail,
    bitwise, including engineered near-ties at the band edge; the board
    scatter drops -1 destinations and writes the picks elsewhere."""
    rng = np.random.default_rng(8)
    rows = rng.standard_normal((32, 128)).astype(np.float32)
    for r in range(0, 32, 4):
        m = int(rows[r].argmax())
        rows[r, (m + 37) % 128] = rows[r, m] - 0.5 * S.TIE_EPS
    dst = np.arange(32, dtype=np.int32)
    dst[5] = dst[17] = -1
    board = torch.full((40 + 1,), 7, dtype=torch.int32)
    toks = S.sample_batch(t(rows), board, t(dst))
    jtoks, jboard = JS.get_sample_fn(False)(
        jnp.asarray(rows), jnp.full((40,), 7, jnp.int32), jnp.asarray(dst),
        jnp.zeros((32,), jnp.float32), jnp.zeros((32,), jnp.int32),
        jnp.zeros((32,), jnp.uint32), jnp.zeros((32,), jnp.int32),
        jnp.zeros((32,), jnp.int32))
    assert np.array_equal(toks.numpy(), np.asarray(jtoks))
    assert toks.numpy().tolist() == [S.greedy_token(r) for r in rows]
    assert np.array_equal(board.numpy()[:40], np.asarray(jboard))
    assert board[5] == 7 and board[17] == 7
    src = np.array([[-1, 3, -1, 30]], np.int32)
    tok = np.array([[11, 12, 13, 14]], np.int32)
    fed = S.inject_tokens(t(tok), t(src), board)
    ref = JS.inject_tokens(jnp.asarray(tok), jnp.asarray(src), jboard)
    assert np.array_equal(fed.numpy(), np.asarray(ref))


def test_host_helpers_copied():
    assert S.rid_hash("abc") == JS.rid_hash("abc")
    row = np.array([0.1, 0.3, 0.3 - 1e-3, -1.0], np.float32)
    assert S.greedy_token(row) == JS.greedy_token(row) == 1
    # seeded draws are ported (tests/test_torch_sampling.py holds them)
    assert S.host_sample(row, 0.8, 0, 0, 0, 0, "cpu") == \
        JS.host_sample(row, 0.8, 0, 0, 0, 0)


def test_bridge_bf16_leaves_bit_exact():
    rng = np.random.default_rng(9)
    a = bf16(rng, (3, 5))
    out = tensor_from_numpy(a)
    assert out.dtype == torch.bfloat16
    assert np.array_equal(out.view(torch.int16).numpy(), a.view(np.int16))
