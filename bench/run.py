"""Run one cell of the port's serving benchmark on this machine's card(s).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; see ``bench/harness.py`` for what a run
does. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number ``correct`` compared,
beside its limit (also the last lines on standard error).

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 2 and prints no result: it never falls back to the CPU."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import manifest
    man = manifest.load_manifest()
    cell = manifest.cell(man, args.workload)

    # set before CUDA starts: the step's large transient gathers come and
    # go every step, and expandable segments keep them from fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"[bench] {args.workload} needs {cell['chips']} CUDA device(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no run")
        return 2

    from bench import harness
    cfg_file = manifest.config(cell["config"])
    per_layer = [m["name"] for m in
                 manifest.cell_metrics(man, cell["name"], "per_layer")]
    e2e = manifest.cell_metrics(man, cell["name"], "end_to_end")
    limit = manifest.limits(cell["name"])["max_logit_gap"]["limit"]
    try:
        res = harness.run_cell(
            cfg_file, manifest.traffic(cell["traffic"]), limit,
            args.seed, args.seconds, bool(args.trace), per_layer, T_START,
            log=log)
    except Exception:
        traceback.print_exc()
        return 1

    foreign = harness.foreign_modules()
    if foreign:
        log(f"[bench] modules of JAX or the JAX package are loaded: "
            f"{foreign}; no result")
        return 1

    units = {m["name"]: m["unit"] for m in man["end_to_end"] +
             man["per_layer"]}
    if args.trace:
        values = res["per_layer"]
    else:
        values = {m["name"]: res["e2e"][m["name"]] for m in e2e}
    missing = [n for n, v in values.items() if v is None]
    if missing and not args.trace:
        log(f"[bench] no value for {missing}: no result")
        return 1
    device = {"platform": "gpu", "kind": res["kind"],
              "count": cell["chips"], "memory_peak_bytes": res["peak"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"],
           "metrics": {n: {"value": v, "unit": units[n]}
                       for n, v in values.items() if v is not None},
           "device": device}
    if args.trace:
        device.update(res["device_extra"])
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    for name, c in res["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
