"""``BENCHMARK.json`` parses, keeps to the contract's shapes, and every name
in it is found as a file; a new cell, mix, metric and limit are picked up
from new files alone."""
import json
import re

import pytest

from bench import manifest
from bench.harness import Run, StepRecord

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
E2E = {"out_tok_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest()


def test_top_level_shape(man):
    assert set(man) == TOP_KEYS
    assert man["command"] == ["python3", "bench/run.py"]
    assert man["paths"] == ["bench"]
    assert isinstance(man["run_seconds"], int) and \
        1 <= man["run_seconds"] <= 51
    assert len(manifest.MANIFEST.read_bytes()) <= 64 << 10


def test_names_and_units(man):
    names = [c["name"] for c in man["configs"]] + \
        [w["name"] for w in man["workloads"]] + \
        [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_metrics_follow_the_contract(man):
    assert {m["name"] for m in man["end_to_end"]} == E2E
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in man["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] == "out_tok_s"
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("kind", ["config", "traffic", "limits", "metric",
                                  "reference"])
def test_every_name_is_found(man, kind):
    for w in man["workloads"]:
        cfg = manifest.config(w["config"])
        if kind == "config":
            assert cfg["name"] == w["config"]
            entry = next(c for c in man["configs"]
                         if c["name"] == w["config"])
            assert entry["file"] == f"bench/configs/{w['config']}.json"
            assert entry["reduced"] == cfg["reduced"]
        elif kind == "traffic":
            assert manifest.traffic(w["traffic"])["clients"] > 0
        elif kind == "limits":
            assert manifest.limits(w["name"])["max_logit_gap"]["limit"] > 0
        elif kind == "reference":
            assert callable(manifest.reference(cfg["family"]).logits)
        else:
            for m in manifest.cell_metrics(man, w["name"], "per_layer"):
                assert callable(manifest.metric_reader(m["name"]).read)


def test_additions_need_no_edit(tmp_path, man):
    """A cell, configuration, mix, limit and metric added as files in a
    directory of their own are found by name; no existing file changes."""
    root = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (root / sub).mkdir(parents=True)
    cfg = manifest.config("h2o-danube-3-4b")
    cfg["name"] = "extra-config"
    (root / "configs" / "extra-config.json").write_text(json.dumps(cfg))
    (root / "traffic" / "extra-mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 3, "block": 4,
         "prompt_tokens": {"dist": "uniform", "lo": 5, "hi": 9},
         "output_tokens": {"dist": "uniform", "lo": 2, "hi": 3}}))
    (root / "limits" / "extra.cell.json").write_text(json.dumps(
        {"max_logit_gap": {"limit": 0.5}}))
    (root / "metrics" / "extra.steps.py").write_text(
        "def read(run):\n    return len(run.steps) or None\n")
    extra = dict(man, workloads=man["workloads"] + [
        {"name": "extra.cell", "config": "extra-config",
         "traffic": "extra-mix", "chips": 1, "why": "a test"}],
        per_layer=man["per_layer"] + [
            {"name": "extra.steps", "unit": "steps", "better": "higher",
             "source": "program_counter", "layer": "engine ring",
             "moves": "out_tok_s", "workloads": ["extra.cell"]}])
    w = manifest.cell(extra, "extra.cell")
    assert manifest.config(w["config"], root)["name"] == "extra-config"
    assert manifest.traffic(w["traffic"], root)["clients"] == 3
    assert manifest.limits("extra.cell", root)["max_logit_gap"]["limit"] \
        == 0.5
    names = [m["name"] for m in
             manifest.cell_metrics(extra, "extra.cell", "per_layer")]
    assert "extra.steps" in names
    assert "extra.steps" not in [m["name"] for m in manifest.cell_metrics(
        extra, man["workloads"][0]["name"], "per_layer")]
    run = Run({}, 1.0, 1, [StepRecord(0.0, 1, 0, 0.0)] * 3, [])
    assert manifest.metric_reader("extra.steps", root).read(run) == 3
    with pytest.raises(FileNotFoundError):
        manifest.traffic("no-such-mix", root)


def test_cells_stay_under_the_varlen_slot_cap(man):
    """Every cell's clients, at their longest contexts, hold few enough
    pages of one type that a packed step's page stream (padded to a power
    of two by the runner) plus its token budget fits the varlen kernel's
    stream: past it the step raises (``PERF.md``, Open questions)."""
    from repro_torch.kernels.flash_attention.kernel import (KV_TILE,
                                                            MAX_KV_TILES)
    for w in man["workloads"]:
        cfg = manifest.config(w["config"])
        tr = manifest.traffic(w["traffic"])
        tpp = cfg["model"]["tokens_per_page"]
        longest = tr["prompt_tokens"]["hi"] + tr["output_tokens"]["hi"] + 1
        pages = tr["clients"] * -(-longest // tpp)
        stream = 1 << (pages - 1).bit_length()
        slots = stream * tpp + cfg["engine"]["max_num_batched_tokens"]
        assert slots <= KV_TILE * MAX_KV_TILES, (w["name"], pages, slots)


def test_pool_holds_every_cells_running_set(man):
    """Each configuration's pool holds the pages of its cells' clients at
    their longest contexts (so a cell never preempts for want of pages),
    and no more than one packed step's varlen launch can take: a pool
    past that would be a reservation no cell fills (``PERF.md``, §4)."""
    from repro_torch.kernels.flash_attention.kernel import (KV_TILE,
                                                            MAX_KV_TILES)
    from bench.harness import build_model_only
    for c in man["configs"]:
        cfg = manifest.config(c["name"])
        specs = build_model_only(cfg).kv_specs()
        pool_pages = cfg["engine"]["kv_pool_bytes"] // sum(
            s.page_bytes for s in specs)
        tpp = cfg["model"]["tokens_per_page"]
        cap = KV_TILE * MAX_KV_TILES - cfg["engine"][
            "max_num_batched_tokens"]
        assert pool_pages * tpp <= cap, c["name"]
        for w in man["workloads"]:
            if w["config"] != c["name"]:
                continue
            tr = manifest.traffic(w["traffic"])
            longest = tr["prompt_tokens"]["hi"] + tr["output_tokens"]["hi"]
            assert tr["clients"] * -(-longest // tpp) <= pool_pages, \
                w["name"]


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        e2e = {m["name"] for m in
               manifest.cell_metrics(man, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.cell_metrics(man, w["name"], "per_layer")
