"""The port's packed ``serve_step`` against JAX ``DecoderLM.serve_step``.

Both packages get the same parameters (the JAX init, through the weight
bridge), the same buffer bytes and the same ``PreparedStep`` arrays, built
by the JAX runner from a real mid-run engine state (old pages, decodes and
prefill chunks in one step). The port always takes the varlen-kernel route
(plain version on the CPU); JAX runs both of its routes.

Tolerances:

* logits: 2e-2 abs in fp32 — the bf16 residual stream differs across the
  two packages by summation order only (about 1e-3 on these models);
* written K/V: layer 0 (same inputs on both sides) within 1 bf16 ulp of
  each JAX value; every layer within 1 bf16 ulp of the written pages'
  largest magnitude. Deeper layers read a residual stream that already
  differs by roundings, and a K/V value near zero is a cancellation of
  O(0.5) terms, so an elementwise ulp would be no bound there (measured:
  at most 2^-9 against |K/V| <= 0.64);
* every other byte of the buffer, the scratch page excepted: equal. The
  port sends dropped writes to the scratch page, JAX drops them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

import jax  # noqa: E402

from conftest import get_model, make_engine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import DecodeBatch, DecoderLM, params_from_numpy  # noqa: E402
from repro_torch.models.attention import view_offset  # noqa: E402
from repro_torch.models.params import tensor_from_numpy  # noqa: E402

ARCHS3 = ["granite-3-2b", "internlm2-1.8b", "qwen2.5-32b"]
_PORT = {}


def port_model(arch):
    """(DecoderLM, params) of the port, sharing the JAX init's weights."""
    if arch not in _PORT:
        _, _, jparams = get_model(arch)
        cfg = reduced(ARCHS[arch])
        model = DecoderLM(cfg)
        _PORT[arch] = (model, params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return _PORT[arch]


def to_batch(arrs):
    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: tensor_from_numpy(x) for k, x in v.items()}
        return tensor_from_numpy(v)
    return DecodeBatch(**{f: conv(v) for f, v in arrs.items()})


def written_units(prep, view_shape, total, layers):
    """Mask of buffer units the step's K/V writes (live eids) cover in
    the given layers."""
    vp, nl, _, tpp, kvl, d = view_shape
    mask = np.zeros(total, bool)
    eids = prep.arrs["write_eids"]["full_attn"].reshape(-1)
    slots = prep.arrs["positions"].reshape(-1) % tpp
    for eid, slot in zip(eids, slots):
        if eid < 0:
            continue
        for layer in layers:
            for sel in (0, 1):
                off = int(view_offset(view_shape, int(eid), layer, sel,
                                      int(slot)))
                mask[off:off + kvl * d] = True
    return mask


def bf16_ulp(x):
    x = np.maximum(np.abs(x), np.float32(1e-30))
    return np.exp2(np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("arch", ARCHS3)
def test_serve_step_matches_jax(arch, impl):
    eng, cfg = make_engine(arch, attention_impl=impl,
                           max_num_batched_tokens=24)
    for i, n in enumerate((13, 6, 45)):
        eng.submit(JRequest(rid=f"r{i}",
                            prompt=[(5 * i + 3 * j) % 97 for j in range(n)],
                            sampling=JSamplingParams(max_new_tokens=8)))
    for _ in range(2):          # leave old pages behind, mid-prefill too
        eng.step()
    plan = eng.scheduler.schedule()
    assert plan.decodes and plan.prefills, "want a mixed step"
    prep = eng.runner.prepare([(s.req, s.num_tokens, s.start)
                               for s in plan.scheduled])
    eng.runner.zero_pages(eng.mgr.drain_fresh_pages())
    buf0 = np.array(eng.runner.buffer).reshape(-1)
    jlogits = eng.runner.fetch(eng.runner.dispatch(eng.params, prep),
                               prep.n)
    jbuf = np.asarray(eng.runner.buffer).reshape(-1)

    model, params = port_model(arch)
    buf = tensor_from_numpy(buf0.copy())
    logits = model.serve_step(params, buf, to_batch(prep.arrs))[:prep.n]
    assert logits.dtype == torch.float32
    assert logits.shape == jlogits.shape
    diff = np.abs(logits.numpy() - jlogits)
    assert diff.max() < 2e-2, diff.max()

    ours = buf.float().numpy()
    ref = jbuf.astype(np.float32)
    view = model._layer_views(buf)["full_attn"]
    scratch = ours.shape[0] - view[1] * int(np.prod(view[2:]))
    w = written_units(prep, view, ours.shape[0], range(view[1]))
    assert w.any()
    untouched = ~w
    untouched[scratch:] = False
    assert np.array_equal(buf.view(torch.int16).numpy()[untouched],
                          buf0.view(np.int16)[untouched])
    assert np.array_equal(jbuf.view(np.int16)[untouched],
                          buf0.view(np.int16)[untouched])
    w0 = written_units(prep, view, ours.shape[0], [0])
    a, b = ours[w0], ref[w0]
    assert (np.abs(a - b) <= np.maximum(bf16_ulp(a), bf16_ulp(b))).all()
    a, b = ours[w], ref[w]
    assert np.abs(a - b).max() <= bf16_ulp(np.abs(b).max()), \
        (np.abs(a - b).max(), np.abs(b).max())
