"""Readings for a cell's limit: on each seed, one run of the cell (a short
window at the cell's own load) and, over the same sampled requests, the
reference and its fp8 control. The control's tokens are put in the
program's place and judged by the same comparison (``harness.verdict``),
so its line shows ``correct`` false where the limit catches it. Prints
one JSON line per seed with the program's verdict and widest logit gap,
the control's, and the run's end-to-end metrics. With ``--fault`` a fault
of ``bench/faults.py`` is planted under the timed path and only the
program is judged. The benchmark's own runs do neither.

    python3 bench/calibrate.py --workload <cell> --seconds <s> --seeds 1,2,3 \
        [--fault state_unchanged]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    from bench import faults, harness, manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = manifest.load_manifest()
    cell = manifest.cell(man, args.workload)
    cfg_file = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limit = manifest.limits(cell["name"])["max_logit_gap"]["limit"]
    if args.fault:
        faults.FAULTS[args.fault](setattr, cfg_file["model"])
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        res = harness.run_cell(
            cfg_file, traffic, limit, seed, args.seconds, False, [],
            t0, control=None if args.fault else "fp8",
            log=lambda s: print(s, file=sys.stderr, flush=True))
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "correct": res["correct"],
                "failed": res["failed"], "checks": res["checks"]}
        if "control" in res:
            line.update(control=res["control"], gaps=res["gaps"],
                        control_gaps=res["control_gaps"])
        line.update(e2e=res["e2e"], peak=res["peak"],
                    attempted=res["attempted"])
        print(json.dumps(line), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
