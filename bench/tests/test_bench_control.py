"""The control: the fp32 reference computed with fp8 matmul operands, put
in the program's place, fails the limit, at a size a test run holds: at
every position of seeded sequences, the token the fp8 pass puts first lies
further below the fp32 reference's best than the limit allows, and a run
judges the control's tokens not correct. (On the card each cell's control
was read at the cell's own size with ``bench/calibrate.py``; ``PERF.md``
gives the readings.)"""
import pytest
import torch

from bench import harness, manifest, weights
from bench.tests.small import small_config
from bench.tests.test_bench_correct import FAMILIES, LIMIT, run


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp8_control_fails_the_limit(family):
    from repro_torch.models.params import MATRICES
    cfg = small_config(FAMILIES[family])
    model = harness.build_model_only(cfg)
    params = weights.make(model.param_shapes(), MATRICES, cfg["init"],
                          2**31 + 41, "cpu")
    ref = manifest.reference(cfg["family"])
    gen = torch.Generator().manual_seed(5)
    vocab = cfg["model"]["vocab_size"]
    widest = 0.0
    for length in (40, 57, 64):
        toks = torch.randint(0, vocab, (length,), generator=gen).tolist()
        rows = range(length)
        exact = ref.logits(params, cfg["model"], toks, rows)
        low = ref.logits(params, cfg["model"], toks, rows, quant="fp8")
        gaps = exact.max(-1).values - exact.gather(
            1, low.argmax(-1, keepdim=True))[:, 0]
        widest = max(widest, gaps.max().item())
    assert widest > 3 * LIMIT


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_control_in_the_programs_place_is_not_correct(family):
    """A run with the control (as ``bench/calibrate.py`` makes one): the
    fp8 reference's tokens at the served positions, judged by the same
    comparison as the program's, come out not correct; the program's
    tokens in the same run come out correct."""
    res = run(FAMILIES[family], control="fp8", seconds=3.0)
    assert res["correct"], res["checks"]
    ctrl = res["control"]
    assert not ctrl["correct"], ctrl["checks"]
    assert ctrl["checks"]["max_logit_gap"]["value"] == max(
        res["control_gaps"])
    assert ctrl["failed"] == sum(g > LIMIT for g in res["control_gaps"])
