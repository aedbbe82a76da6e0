"""What the benchmark runs stands apart from JAX and the JAX package
(top-level names compared whole, so ``repro_torch`` passes); the
reference stands apart from the port too; and without a card the
benchmark prints no result."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & FOREIGN, path


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_imports(path)) & (FOREIGN | {"repro_torch", "bench"}), \
        path


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_loaded_modules_of_a_run():
    """Everything a run imports, loaded in a fresh process: no module
    whose top-level name is JAX's or the JAX package's."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "import bench.harness, bench.trace, bench.manifest\n"
            "from bench import manifest\n"
            "import repro_torch.serving, repro_torch.models, "
            "repro_torch.models.params\n"
            "m = manifest.load_manifest()\n"
            "for c in m['configs']:\n"
            "    manifest.reference(manifest.config(c['name'])['family'])\n"
            "for x in m['per_layer']:\n"
            "    manifest.metric_reader(x['name'])\n"
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FOREIGN


def _run(cwd):
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell["name"],
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=_env(), timeout=120)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr, out.stderr
    assert not _has_result(out.stdout)


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files
    (no program) gives no result either."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
