"""The paged decode kernel's plain PyTorch version against the JAX kernel
(Pallas in interpret mode) and its oracle ``paged_decode_attention_ref``,
on the cases of ``test_kernel_paged.py`` and the ones the padded serve path
adds: invalid table entries with SENTINEL page positions, pad and killed
rows whose position is SENTINEL, a row with no visible slot (mean(V) over
every slot: no zero-row guard), and a kv_view that is one strided layer of
a (VP, L, ...) pool.

The per-step plan (``paged_decode_plan``) against a brute-force numpy
mirror; an emulation of the kernel's arithmetic on the plan's work list
(per split a base-2 online softmax over 16-slot tiles, p rounded to bf16
before P V for bf16 inputs as the tensor cores take it, fp32 partials
combined in split order) against the plain version, the JAX kernel and
the ref; and the plain version with a plan against itself without one.

Tolerances: bf16 2e-2 (a few bf16 ulps at |out| ~ 1, summed in another
order), fp32 2e-5 (the JAX tests' own bound: online vs two-pass softmax in
fp32), 3e-5 for the page-permutation property as in the JAX test, 1e-6 for
the plain version with and without a plan (the same fp32 sums over fewer
zero terms). The CUDA kernel itself runs only on the card: its test is
marked ``cuda`` and skips here.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import hypothesis.strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.kernels.paged_attention.kernel import \
    paged_decode_attention as jax_kernel  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.paged_attention.kernel import (  # noqa: E402
    PAGES_PER_SPLIT, check_inputs, max_splits, n_splits, paged_decode_plan)
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
    (2, 2, 6, 16, 8, 4),             # G 6 (dbrx, qwen2-vl-2b)
    (2, 1, 16, 16, 8, 4),            # G 16 (qwen3-moe): two groups of 8
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


def _rows_case(lens, tpp, p, seed, kvl=2, g=2, d=16, invalid=False, pad=0,
               dtype=np.float32):
    """Rows at query positions ``lens`` over pages of ``tpp`` slots, as the
    padded serve path lays them out: unused entries -1 / SENTINEL, an
    invalid second entry in every row (``invalid``), the last ``pad`` rows
    pad rows; the pages scattered over a pool."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    n_pages = [n // tpp + 1 for n in lens]
    vp = sum(n_pages) + 1
    tables = np.full((b, p), -1, np.int32)
    page_pos = np.full((b, p), SENTINEL, np.int32)
    positions = np.full((b,), SENTINEL, np.int32)
    perm = rng.permutation(vp)
    off = 0
    for r in range(b - pad):
        tables[r, :n_pages[r]] = perm[off:off + n_pages[r]]
        page_pos[r, :n_pages[r]] = np.arange(n_pages[r]) * tpp
        positions[r] = lens[r]
        if invalid:
            tables[r, 1], page_pos[r, 1] = -1, SENTINEL
        off += n_pages[r]
    q = rng.standard_normal((b, kvl, g, d)).astype(dtype)
    kv = rng.standard_normal((vp, 2, tpp, kvl, d)).astype(dtype)
    return q, kv, tables, page_pos, positions


def _plan_cases():
    """(name, case, window): the serve-like batch (pad and killed rows, an
    invalid entry, a row whose pages all lie in its future), a row split
    over many blocks (276 visible pages: pps 5 at B 2), and 64 rows whose
    longest are capped at max_splits(64) = 8 splits."""
    rng = np.random.default_rng(11)
    return [
        ("serve", _serve_like(), 0),
        ("serve", _serve_like(), 8),
        ("long row", _rows_case([1103, 37], 4, 300, seed=1), 0),
        ("long row", _rows_case([1103, 37], 4, 300, seed=1), 64),
        ("64 rows", _rows_case(list(rng.integers(1, 700, 62)), 16, 48,
                               seed=2, invalid=True, pad=2), 0),
        ("64 rows", _rows_case(list(rng.integers(1, 700, 62)), 16, 48,
                               seed=2, invalid=True, pad=2), 8),
    ]


def _plan_mirror(tables, page_pos, positions, tpp, window):
    """Brute force, per row: the table entries that hold a visible slot, in
    table order (all P entries when none does), and the pages each split
    takes: pps = max(PAGES_PER_SPLIT, ceil(n / max_splits(B)))."""
    b, p = tables.shape
    rows = []
    for r in range(b):
        qpos = int(positions[r])

        def visible(e):
            return any(int(page_pos[r, e]) + t <= qpos and
                       (not window or int(page_pos[r, e]) + t > qpos - window)
                       for t in range(tpp))

        ents = [e for e in range(p) if visible(e)] or list(range(p))
        pps = max(PAGES_PER_SPLIT, -(-len(ents) // max_splits(b)))
        rows.append((ents, [ents[i:i + pps]
                            for i in range(0, len(ents), pps)]))
    return rows


@pytest.mark.parametrize("name,case,window", _plan_cases())
def test_plan_matches_brute_force(name, case, window):
    """Every visible entry lands in exactly one split, in table order; a
    row with none takes all P entries; the work list holds each row's
    splits in order (with its first page's id and start), rows in order,
    then -1 items to its fixed length."""
    _, kv, tables, page_pos, positions = case
    tpp = kv.shape[2]
    plan = paged_decode_plan(t(tables), t(page_pos), t(positions), tpp,
                             window)
    b, p = tables.shape
    assert (plan.tpp, plan.window) == (tpp, window)
    work = plan.work.numpy()
    assert work.shape == (b * n_splits(b, p), 8)
    items = [w for w in work if w[0] >= 0]
    assert (work[len(items):] == (-1,) + (0,) * 7).all()
    for r, (ents, splits) in enumerate(_plan_mirror(tables, page_pos,
                                                    positions, tpp, window)):
        assert plan.count[r] == len(ents)
        pages = plan.pages[r, :len(ents)].numpy()
        np.testing.assert_array_equal(pages[:, 0],
                                      np.maximum(tables[r, ents], 0))
        np.testing.assert_array_equal(pages[:, 1], page_pos[r, ents])
        mine = [w for w in items if w[0] == r]
        assert [w[1] & 0xffff for w in mine] == list(range(len(splits)))
        assert all(w[1] >> 16 == len(splits) for w in mine)
        taken = [ents[i] for w in mine for i in range(w[2], w[2] + w[3])]
        assert taken == ents == [e for s in splits for e in s]
        for w in mine:
            e = ents[w[2]]
            assert (w[4], w[5]) == (max(tables[r, e], 0), page_pos[r, e])
        assert [w[3] for w in mine] == [len(s) for s in splits]
    assert [w[0] for w in items] == sorted(w[0] for w in items)
    if name == "long row" and not window:
        assert len([w for w in items if w[0] == 0]) > 32


def _emulate(q, kv, positions, plan, window, p_bf16):
    """The kernel's arithmetic in numpy on the plan's work list: per split
    and kv head, an online softmax in base 2 over the split's pages in
    16-slot tiles (masked scores -1e30, slots past the page -inf; p rounded
    to bf16 before P V when ``p_bf16``), fp32 partials (m, l, acc); a row
    of several splits combines them in split order."""
    b, kvl, g, d = q.shape
    tpp = kv.shape[2]
    scale = np.float32(1 / np.sqrt(d) * np.log2(np.e))
    pages, work = plan.pages.numpy(), plan.work.numpy()
    parts = {}
    for row, sp, first, n in work[:, :4]:
        if row < 0:
            continue
        qpos = int(positions[row])
        m = np.full((kvl, g), -1e30, np.float32)
        l = np.zeros((kvl, g), np.float32)
        acc = np.zeros((kvl, g, d), np.float32)
        for eid, ppos in pages[row, first:first + n]:
            for t0 in range(0, tpp, 16):
                ts = np.arange(t0, t0 + 16)
                live = ts < tpp
                k = kv[eid, 0, np.minimum(ts, tpp - 1)]          # (16,K,D)
                v = kv[eid, 1, np.minimum(ts, tpp - 1)]
                s = np.einsum("kgd,tkd->kgt", q[row], k).astype(
                    np.float32) * scale
                spos = ppos + ts
                vis = spos <= qpos
                if window:
                    vis &= spos > qpos - window
                s = np.where(vis, s, np.float32(-1e30))
                s = np.where(live, s, -np.inf).astype(np.float32)
                mn = np.maximum(m, s.max(-1))
                corr = np.exp2(m - mn)
                pr = np.exp2(s - mn[..., None]).astype(np.float32)
                l = l * corr + pr.sum(-1)
                if p_bf16:
                    pr = np.asarray(torch.from_numpy(pr).to(
                        torch.bfloat16).float())
                acc = acc * corr[..., None] + np.einsum("kgt,tkd->kgd",
                                                        pr, v)
                m = mn
        parts.setdefault(int(row), []).append((m, l, acc))
    out = np.zeros(q.shape, np.float32)
    for row, ps in parts.items():
        mm = np.max([x[0] for x in ps], axis=0)
        lt = sum(x[1] * np.exp2(x[0] - mm) for x in ps)
        at = sum(x[2] * np.exp2(x[0] - mm)[..., None] for x in ps)
        out[row] = at / np.maximum(lt, 1e-30)[..., None]
    return out


def _emulation_cases():
    """(name, case, window, tol): the shape sweep of
    ``test_plain_matches_jax_kernel_and_ref`` in bf16, the serve-like batch
    with and without a window, and rows of 15 and 4 splits (in bf16 with
    a window of 200: 13 and 4)."""
    cases = [(f"sweep {shape}", make_case(*shape, vp=shape[5] * shape[0] + 3,
                                          dtype=jnp.bfloat16), 0, 2e-2)
             for shape in ((2, 1, 4, 32, 8, 4), (3, 2, 2, 64, 16, 3),
                           (1, 4, 1, 128, 8, 6), (2, 2, 6, 16, 8, 4),
                           (2, 1, 16, 16, 8, 4))]
    cases += [("serve", _serve_like(), w, 2e-5) for w in (0, 8)]
    cases += [("many splits", _rows_case([239, 60], 4, 64, seed=5, kvl=2,
                                         g=3, d=32), 0, 2e-5),
              ("many splits bf16", _rows_case([239, 60], 4, 64, seed=5,
                                              dtype=jnp.bfloat16), 200, 2e-2)]
    return cases


@pytest.mark.parametrize("name,case,window,tol", _emulation_cases())
def test_split_emulation_matches_plain_jax_and_ref(name, case, window, tol):
    """The kernel's split partials and their fixed-order merge compute the
    contract's function: against the plain version, the JAX kernel in
    interpret mode and the ref."""
    q, kv, tables, page_pos, positions = case
    bf16 = np.asarray(q).dtype != np.float32
    qn, kvn = (np.asarray(jnp.asarray(a, jnp.float32)) for a in (q, kv))
    plan = paged_decode_plan(t(tables), t(page_pos), t(positions),
                             kvn.shape[2], window)
    if name.startswith("many splits"):
        assert (plan.work[:, 1] >> 16).max() > 1
    out = _emulate(qn, kvn, np.asarray(positions), plan, window, bf16)
    close(port(case, window=window), out, tol)
    close(out, jax_kernel(*case, window=window, interpret=True), tol)
    close(out, jax_ref(*case, window=window), tol)


@pytest.mark.parametrize("name,case,window", _plan_cases())
def test_plain_with_plan_equals_plain_without(name, case, window):
    """Reading only the plan's entries is the same function: the entries
    it drops have no visible slot in a row that sees one."""
    args = tuple(t(a) for a in case)
    plan = paged_decode_plan(*args[2:], args[1].shape[2], window)
    with_plan = paged_decode_attention_plain(*args, window=window, plan=plan)
    without = paged_decode_attention_plain(*args, window=window)
    torch.testing.assert_close(with_plan, without, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card: a strided
    layer of the pool, a window, invalid entries and pad rows (mean(V)),
    head dims 64 and 128, and a 4000-token row split over many blocks;
    two calls give the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    dev = torch.device("cuda")
    long_row = _rows_case([4000, 30, 700], 16, 260, seed=9, kvl=8)
    for d, g, window, base in ((64, 4, 0, None), (64, 4, 8, None),
                               (128, 5, 0, None), (64, 4, 0, long_row)):
        q, kv, tables, page_pos, positions = base or _serve_like()
        rng = np.random.default_rng(d + g)
        q = rng.standard_normal(q.shape[:2] + (g, d)).astype(np.float32)
        pool = rng.standard_normal((kv.shape[0], 3) + kv.shape[1:4] +
                                   (d,)).astype(np.float32)
        view = t(pool).to(dev, torch.bfloat16)[:, 1]
        args = (t(q).to(dev, torch.bfloat16), view) + tuple(
            t(a).to(dev) for a in (tables, page_pos, positions))
        before = paged_decode_attention.launches
        out = paged_decode_attention(*args, window=window)
        again = paged_decode_attention(*args, window=window)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 2
        assert torch.equal(out, again)              # byte-identical repeats
        ref = paged_decode_attention_plain(*args, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        assert err < 2e-2, (d, g, window, err)
