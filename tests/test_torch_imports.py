"""The port stands alone: no module of ``src/repro_torch``, no example of
``examples/torch``, not ``scripts/run_lint_torch.py`` and not
``chip_smoke.py`` imports JAX or the JAX package (the machine with the card
has no JAX). Relative imports stay inside the port."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        sorted((ROOT / "examples" / "torch").glob("*.py")) + \
        [ROOT / "scripts" / "run_lint_torch.py", ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, (path, bad)


def test_scan_sees_the_port():
    names = {p.name for p in _files()}
    assert {"engine.py", "runner.py", "kernel.py", "lm.py",
            "spec_decode.py", "router.py", "dp_engine.py", "autotune.py",
            "roofline.py", "dryrun.py", "jengalint.py", "quickstart.py",
            "train_hybrid.py", "serve_heterogeneous.py",
            "spec_decode_demo.py", "run_lint_torch.py",
            "chip_smoke.py"} <= names
