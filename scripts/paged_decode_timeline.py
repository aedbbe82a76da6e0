#!/usr/bin/env python3
"""Where a paged decode kernel block's time goes, on one GPU.

    python3 scripts/paged_decode_timeline.py

Builds a copy of ``paged_decode.cu`` whose blocks stamp ``%globaltimer``
(ns) at the boundaries of their phases into a device array, runs it on
every paged case of ``chip_smoke.py`` (inputs and the step's plan as
there), and prints, per case, the kernel's span from its first block's
start to its last stamp and the median over the blocks that had work of
each phase: reading the work item; setting up and issuing the first
pages' copies; waiting for the first page; the pages' math; combining
the warps in shared memory; writing out (or the split's partial); the
split counter; and, for the block that combines a row's splits, the
merge. The copy is built under ``build/kernels`` and the committed
kernel is left as it is; the stamps cost a few hundred ns a block.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MAX_BLOCKS = 1 << 14
PHASES = ("item", "issue", "first page", "pages", "warps", "out/partial",
          "counter", "merge")
# (source line, stamp index, stamp after the line rather than before it)
ANCHORS = (
    ("  const int4 item = p.work[2 * (blockIdx.x / p.n_units)];", 0, False),
    ("  if (b < 0) return;", 1, True),
    ("    for (int i = 1; i < min(n, p.stages); ++i) issue(i);\n  }", 2,
     True),
    ("    const int ppos = pos_s[s];", 3, True),
    ("  // each warp's partial to shared memory", 4, False),
    ("  // per (kv head, q head, 8 columns)", 5, False),
    ("  if (splits == 1) return;", 6, False),
    ("  if (!last) return;", 7, False),
)


def stamp(k, first_page=False):
    cond = "threadIdx.x == 0" + (" && i == 0" if first_page else "")
    return (f"if ({cond}) {{ unsigned long long t_; asm volatile("
            f"\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"if (blockIdx.x < {MAX_BLOCKS}) g_stamps[blockIdx.x][{k}] = t_; "
            f"}}\n")


def instrumented(src, header):
    for line, k, after in ANCHORS:
        if line not in src:
            raise RuntimeError(f"paged_decode.cu changed: no line {line!r}")
        s = stamp(k, first_page=k == 3)
        src = src.replace(line, line + "\n" + s if after else s + line, 1)
    end = src.index("// Launch one instance")
    close = src.rindex("}\n", 0, end)
    src = src[:close] + stamp(8) + src[close:]
    src = src.replace('#include "../../csrc/hopper.cuh"',
                      f'#include "{header}"')
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned "
                      f"long long g_stamps[{MAX_BLOCKS}][9];\n", 1)
    return src + (
        'extern "C" int stamps_read(void* host) { return (int)'
        "cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps)); }\n"
        'extern "C" int stamps_clear() { void* p = nullptr; '
        "cudaGetSymbolAddress(&p, g_stamps); return (int)cudaMemset(p, 0, "
        "sizeof(g_stamps)); }\n")


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as K

    if not torch.cuda.is_available():
        print("paged_decode_timeline: no CUDA device is available",
              file=sys.stderr)
        return 1
    source = build.SOURCES["paged_decode"]
    header = (source.parents[2] / "csrc" / "hopper.cuh").resolve()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "paged_decode_timeline.cu"
    lib_path = build.BUILD_DIR / "libpaged_decode_timeline.so"
    cu.write_text(instrumented(source.read_text(), header))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(cu)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.paged_decode_bf16.argtypes = K._bind().paged_decode_bf16.argtypes
    lib.paged_decode_bf16.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    lib.stamps_read.argtypes = [ctypes.c_void_p]
    K._bind.cache_clear()
    K.build.load = lambda name: lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; us, medians over the blocks with work (merge: "
          f"over the blocks that combined a row's splits)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(3)
    buf = np.zeros((MAX_BLOCKS, 9), np.uint64)
    for case in cs.paged_cases():
        w = case.get("window", 0)
        q, pool, meta, _ = cs.paged_inputs(case, gen, rng, dev)
        plan = K.paged_decode_plan(*meta, pool.shape[3], w)
        for rep in range(4):            # the last of a few calls counts
            torch.cuda.synchronize()
            if lib.stamps_clear():
                raise RuntimeError("clearing the stamps failed")
            K.paged_decode_attention(q, pool[:, rep % pool.shape[1]], *meta,
                                     window=w, plan=plan)
            torch.cuda.synchronize()
        if lib.stamps_read(buf.ctypes.data):
            raise RuntimeError("reading the stamps failed")
        t = buf.astype(np.int64)
        t = t[t[:, 0] > 0]
        rel = np.where(t > 0, t - t[:, 0].min(), -1)
        work = rel[:, 1] >= 0

        def med(a, b, rows):
            x = rel[rows & (rel[:, a] >= 0) & (rel[:, b] >= 0)]
            return np.median(x[:, b] - x[:, a]) / 1e3 if len(x) else np.nan

        merged = rel[:, 8] >= 0
        parts = [f"{PHASES[k]} {med(k, k + 1, work):.2f}" for k in range(7)]
        parts.append(f"merge {med(7, 8, merged):.2f}")
        print(f"[timeline] {case['name']}: span {rel.max() / 1e3:.2f}, "
              f"{int(work.sum())} blocks with work of {len(rel)}; "
              + ", ".join(parts), flush=True)
        del pool, plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
