#!/usr/bin/env python3
"""Show a fault of PyTorch's CPU build without this repository's code: the
first MKL vector-math call of a process (``torch.exp``, ``torch.sin``,
``torch.log`` ... on a float tensor large enough to be split over threads)
can return low-accuracy values (up to ~1.5e-4 relative, where the same call
made again is within 1.2e-7 of the float64 result) in one thread's share of
the tensor, when that call is also the process's first OpenMP parallel
region. A parallel op before it (``x + 1``) or a first vector-math call on
one thread, and every later call, give exact values; MKL's ``MKL_CBWR``,
``MKL_ENABLE_INSTRUCTIONS``, ``MKL_NUM_THREADS``, ``MKL_DYNAMIC`` and
``ATEN_CPU_CAPABILITY`` do not change it. Seen with torch 2.13.0+cpu (MKL
2024.2, GNU OpenMP) on a CPU with AVX-512 and AMX.

    python3 scripts/torch_cpu_first_vml_call.py [--procs 96] [--threads 8]

Runs ``--procs`` fresh processes, each calling ``torch.exp`` twice on the
same 720,000 floats with ``--threads`` intra-op threads, and counts the
processes whose first call differs from their second. With ``--threads 1``
the count is 0: the port's CPU tests run with one intra-op thread.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import os
import subprocess
import sys

CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(int(sys.argv[1]))
x = torch.from_numpy(-8 * np.random.default_rng(0).random(720000)
                     .astype(np.float32))
a = torch.exp(x)
b = torch.exp(x)
print(float(((a - b).abs() / b).max()))
"""


def one(threads: int) -> float:
    out = subprocess.run([sys.executable, "-c", CHILD, str(threads)],
                         check=True, capture_output=True, text=True)
    return float(out.stdout.split()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=96)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=max(1, (os.cpu_count() or 2)
                                                    - 1))
    args = ap.parse_args()
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        errs = list(pool.map(one, [args.threads] * args.procs))
    bad = [e for e in errs if e > 0]
    print(f"{len(bad)} of {args.procs} processes ({args.threads} intra-op "
          f"threads): first torch.exp differs from the second, max "
          f"relative {max(bad, default=0.0):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
