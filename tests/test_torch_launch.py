"""The port's launch-side analysis (``repro_torch.launch``) on the CPU.

* The functions copied from the reference are pure arithmetic and equal
  the reference's on every arch and shape: ``buffer_units_for`` (at one
  card's rows and tokens, ``mesh.card_share``), ``default_micro_batches``,
  ``wants_fsdp``, ``model_flops_per_device`` at ``devices=1`` and
  ``loop_factor``.
* The reference's ``kv_bytes_per_device`` and ``analytic_terms`` fix a
  16 x 16 mesh inside; the port's one-card values are held to counts
  written out here, for granite-3-2b (one full-attention type) and
  h2o-danube-3-4b (full and sliding-window types, head dim 120).
* The planner's weight bytes equal the bytes of the port's ``init`` for
  every reduced family exactly, serving (bf16 matrices) and training (fp32
  masters): it reads the model's own ``param_shapes``. The reference's
  ``count_params`` is approximate (it leaves out norms, biases, the conv
  and the RWKV mixing vectors), so the planner does not use it for bytes.
* ``dryrun --all`` writes one record per (arch x shape) of ``shapes_for``
  with its fit, largest fitting depth and roofline terms, ``roofline``
  prints them as a table, and ``--measure`` raises without a card.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import input_specs as jspecs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.models.tp import single_device_dist  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES_BY_NAME, reduced,  # noqa: E402
                                 shapes_for)
from repro_torch.launch import dryrun, input_specs, roofline  # noqa: E402
from repro_torch.launch.mesh import CardShare, card_share  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CELLS = [(a, s.name) for a in sorted(ARCHS) for s in shapes_for(ARCHS[a])]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_copied_arithmetic_equals_the_reference(arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    model, jmodel = build_model(cfg), jbuild_model(jcfg, single_device_dist())
    assert input_specs.default_micro_batches(cfg) == \
        jspecs.default_micro_batches(jcfg)
    assert input_specs.wants_fsdp(cfg) == jspecs.wants_fsdp(jcfg)
    for shape in shapes_for(cfg):
        share = card_share(shape)
        enc = cfg.encoder_seq if cfg.family == "encdec" else 0
        assert input_specs.buffer_units_for(
            model, cfg, share.tokens, share.rows, enc) == \
            jspecs.buffer_units_for(jmodel, jcfg, share.tokens, share.rows,
                                    enc), shape.name
        assert roofline.model_flops_per_device(cfg, shape, 1) == \
            jroof.model_flops_per_device(jcfg, shape, 1)
        assert roofline.loop_factor(cfg, shape) == \
            jroof.loop_factor(jcfg, shape)


def test_card_share_folds_the_production_mesh():
    shares = {n: card_share(s) for n, s in SHAPES_BY_NAME.items()}
    assert shares == {
        "train_4k": CardShare(16, 4096, False, 16),
        "prefill_32k": CardShare(2, 32768, False, 16),
        "decode_32k": CardShare(8, 32768, False, 16),
        # sequence-parallel in the reference: the one card holds it whole
        "long_500k": CardShare(1, 524288, True, 1)}


# per token and layer: K and V of every KV head, bf16
GRANITE_KV = 2 * 8 * 64 * 2          # 8 KV heads of 64
DANUBE_KV = 2 * 8 * 120 * 2          # 8 KV heads of 120
GRANITE_N = 2_533_365_760            # count_params: 40 x 60,817,408 + embed
DANUBE_N = 3_961_651_200             # 24 x 154,828,800 + 2 x 32000 x 3840


@pytest.mark.parametrize("arch,shape,kv,flops,nbytes", [
    # 8 rows of 32,768 tokens over 40 full-attention layers
    ("granite-3-2b", "decode_32k", 8 * 32768 * 40 * GRANITE_KV,
     2 * GRANITE_N * 8 + 4 * 32768 * 512 * 40 * 8,
     2 * GRANITE_N + 8 * 32768 * 40 * GRANITE_KV),
    # 2 rows of 32,768 tokens: 2 * N * tokens + causal attention
    ("granite-3-2b", "prefill_32k", 2 * 32768 * 40 * GRANITE_KV,
     2 * GRANITE_N * 65536 + 2 * 2 * 32 * 64 * 32768 ** 2 / 2 * 2 * 40,
     2 * GRANITE_N + 2 * (2 * 32768 * 40 * GRANITE_KV)
     + 65536 * 2048 * 2 * 40),
    # 12 full layers hold all 32,768 tokens, 12 sliding-window layers
    # their 4096-token window
    ("h2o-danube-3-4b", "decode_32k", 8 * (32768 + 4096) * 12 * DANUBE_KV,
     2 * DANUBE_N * 8 + 4 * 32768 * 960 * 24 * 8,
     2 * DANUBE_N + 8 * (32768 + 4096) * 12 * DANUBE_KV),
    # 16 rows of 4096: 6 * N * tokens + 3x the causal attention forward;
    # bytes: fp32 params and grads read and written, activations
    ("h2o-danube-3-4b", "train_4k", 16 * 4096 * 24 * DANUBE_KV,
     6 * DANUBE_N * 65536 + 3 * 2 * 2 * 32 * 120 * 4096 ** 2 / 2 * 16 * 24,
     3 * 2 * DANUBE_N * 2 + 65536 * 3840 * 2 * 24 * 4),
])
def test_one_card_kv_bytes_and_analytic_terms(arch, shape, kv, flops,
                                              nbytes):
    cfg, sh = ARCHS[arch], SHAPES_BY_NAME[shape]
    assert roofline.count_params(cfg)["total"] == \
        (GRANITE_N if arch == "granite-3-2b" else DANUBE_N)
    assert roofline.kv_bytes_per_device(cfg, sh) == kv
    f, b = roofline.analytic_terms(cfg, sh)
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == pytest.approx(nbytes, rel=1e-12)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_weight_bytes_equal_init_bytes(arch):
    model = build_model(reduced(ARCHS[arch]))
    for master in (False, True):
        params = model.init(0, device="cpu", master=master)
        leaves = []

        def walk(t):
            for v in t.values():
                walk(v) if isinstance(v, dict) else leaves.append(v)

        walk(params)
        assert dryrun.weight_bytes(model, master) == sum(
            w.numel() * w.element_size() for w in leaves), master
    counts = dryrun.param_counts(model)
    assert counts["total"] == sum(w.numel() for w in leaves)
    assert counts["largest_stack"] <= counts["stacked"] < counts["total"]


def test_pool_bytes_is_the_engine_buffer():
    from repro_torch.serving import Engine, EngineConfig
    for arch in ("h2o-danube-3-4b", "zamba2-1.2b", "whisper-tiny"):
        model = build_model(reduced(ARCHS[arch]))
        eng = Engine(model, EngineConfig(kv_pool_bytes=3 << 20),
                     device="cpu")
        buf = eng.runner.buffer
        assert dryrun.pool_bytes(model, 3 << 20) == \
            buf.numel() * buf.element_size()


def test_dryrun_all_records_and_roofline_table(tmp_path, capsys):
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    recs = {(r["arch"], r["shape"]): r for r in (
        json.loads(p.read_text()) for p in tmp_path.glob("*.json"))}
    assert sorted(recs) == sorted(CELLS)
    for r in recs.values():
        assert r["fits"] == (r["peak_bytes"] <= dryrun.FIT_BYTES)
        assert r["fits"] == (r["max_depth"] == r["full_depth"])
        t = r["terms"]
        assert r["peak_bytes"] == t["weights"] + t["pool"] + \
            t["activations"] + t["batch"]
        f, b = roofline.analytic_terms(ARCHS[r["arch"]],
                                       SHAPES_BY_NAME[r["shape"]])
        assert r["roofline"] == dict(
            flops=f, bytes=b, t_compute_s=f / roofline.PEAK_FLOPS,
            t_memory_s=b / roofline.HBM_BW)
    # granite's 8 x 32k decode share fits (~21.5 GB of K/V beside 5 GB of
    # weights); qwen2.5-32b's (65.5 GB of weights, ~72 GB of K/V) does not
    g = recs["granite-3-2b", "decode_32k"]
    assert g["fits"] and g["terms"]["pool"] >= 8 * 32768 * 40 * GRANITE_KV
    q = recs["qwen2.5-32b", "decode_32k"]
    assert not q["fits"] and 0 < q["max_depth"] < 64
    # neither MoE fits whole; one card trains one qwen3-moe layer, not two
    assert recs["qwen3-moe-235b-a22b", "train_4k"]["max_depth"] == 1
    capsys.readouterr()
    assert roofline.main(["--dir", str(tmp_path)]) == 0
    table = capsys.readouterr().out.splitlines()
    assert len(table) == 2 + len(CELLS)
    assert (tmp_path / "roofline.json").exists()


def test_hand_cuts_within_the_planners_depth():
    """The cuts the full-width phases serve and train at fit the planner
    at the same batch and pool: qwen3-moe served at 10 of 94 layers and
    dbrx at 8 of 40 beside a 4 GiB pool, qwen3-moe trained at 1 layer in 4
    micro-batches of 1 x 2048."""
    def serve_fits(c):
        m = build_model(c)
        t = dryrun.serve_terms(m, dryrun.pool_bytes(m, 4 << 30), 2048, 8,
                               4096)
        return dryrun.peak(t) <= dryrun.FIT_BYTES

    assert dryrun.largest_depth(ARCHS["qwen3-moe-235b-a22b"],
                                serve_fits) >= 10
    assert dryrun.largest_depth(ARCHS["dbrx-132b"], serve_fits) >= 8
    assert dryrun.largest_depth(
        ARCHS["qwen3-moe-235b-a22b"],
        lambda c: dryrun.peak(dryrun.train_terms(build_model(c), 4, 2048,
                                                 4)) <= dryrun.FIT_BYTES) == 1


def test_measure_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rec = dryrun.plan("granite-3-2b", "decode_32k")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.measure(rec)
    with pytest.raises(RuntimeError, match="on the card"):
        dryrun.measure(rec, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                     "--measure", "--out", str(tmp_path)])
    assert np.isfinite(rec["peak_bytes"])


@pytest.mark.parametrize("kind,rows,kernel", [
    ("prefill", 2, "flash_attention_varlen"),
    ("decode", 4, "paged_decode_attention"),
    ("train", 4, None)])
def test_run_cell_takes_the_cells_path(monkeypatch, kind, rows, kernel):
    """``--measure``'s run of a cell, at reduced size on the CPU: a
    prefill is one packed dispatch (the varlen kernel once a layer), a
    decode one padded T == 1 dispatch (the paged kernel once a layer), a
    train cell one ``Trainer`` step; no CUDA-event time off the card."""
    from repro_torch.models import blocks_attn
    calls = {}
    for name in ("flash_attention_varlen", "paged_decode_attention"):
        real = getattr(blocks_attn, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(blocks_attn, name, spy)
    cfg = reduced(ARCHS["granite-3-2b"])
    pool = input_specs.buffer_units_for(build_model(cfg), cfg, 64, rows)
    out = dryrun.run_cell(cfg, kind, rows, 64, 2, pool, "cpu")
    assert out["finite"] and out["ms"] is None
    if kernel is None:
        assert np.isfinite(out["loss"])
    else:
        assert calls == {kernel: cfg.num_layers}, calls
        assert out["logits_shape"][0] == rows
