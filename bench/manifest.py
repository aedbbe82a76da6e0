"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration file names its reference family. Each lives in a file of
its own, so adding one adds files and entries and edits none:

  bench/configs/<config>.json      sizes, engine settings, weight scales
  bench/traffic/<traffic>.json     parameters of the load generator
  bench/limits/<cell>.json         the limit of each number ``correct``
                                   compares, with the readings it came from
  bench/metrics/<metric>.py        a per-layer metric's reader
  bench/reference/<family>.py      the plain fp32 reference of a family
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Any, Dict

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path: pathlib.Path = MANIFEST) -> Dict[str, Any]:
    return json.loads(path.read_text())


def cell(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def _json(kind: str, name: str, root: pathlib.Path) -> Dict[str, Any]:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def config(name: str, root: pathlib.Path = BENCH) -> Dict[str, Any]:
    return _json("configs", name, root)


def traffic(name: str, root: pathlib.Path = BENCH) -> Dict[str, Any]:
    return _json("traffic", name, root)


def limits(cell_name: str, root: pathlib.Path = BENCH) -> Dict[str, Any]:
    return _json("limits", cell_name, root)


def _module(kind: str, name: str, root: pathlib.Path, modname: str):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: pathlib.Path = BENCH):
    """The module whose ``read(run)`` gives per-layer metric ``name``, or
    None where the run holds nothing to read."""
    return _module("metrics", name, root,
                   "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def reference(family: str, root: pathlib.Path = BENCH):
    """The plain fp32 reference module of a model family (a module of the
    ``bench.reference`` package, so it may import its ``common``)."""
    return _module("reference", family, root, f"bench.reference.{family}")


def cell_metrics(manifest: Dict[str, Any], cell_name: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]
