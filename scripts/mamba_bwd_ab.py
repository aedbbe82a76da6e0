#!/usr/bin/env python3
"""A/B of the Mamba2 scan's backward kernel on one GPU: this checkout's
(``mamba_chunk_scan_bwd``, ``csrc/mamba_scan_bwd.cu``) against another
version's CUDA source, compiled into a library of its own, in turns (old,
new, new, old) in one process.

    mkdir -p build/ab
    git show <commit>:<path of csrc/mamba_scan_bwd.cu> > build/ab/old.cu
    python3 scripts/mamba_bwd_ab.py --old-source build/ab/old.cu \
        [--old-interface first|current] [--train]

``--old-source`` is a source with the first version's C interface
(``--old-interface first``, the default: ``mamba_scan_bwd`` taking the
states / dstates / dbp / dcp / da_part scratch, three launches, fp32
outputs) or with this checkout's (``current``: the old library takes the
place of the built one under this checkout's wrapper). ``compile_library``
builds it with the port's nvcc flags into ``build/ab/``. Each turn holds
both against the plain version on ``chip_smoke.py``'s phase-2c backward
cases (within MAMBA_BWD_TOL) and times them per call (CUDA events over
back-to-back calls); a kernel with this checkout's interface also each of
its two launches by ``torch.profiler``. With
``--train`` each turn also runs phase 5b's zamba2-1.2b training (full
width, 4 timed steps, exact launch counts) with that kernel in the
autograd Function. Prints the card's name and power limit beside the
numbers.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def compile_library(source, out_dir):
    """``source`` (a CUDA file with a plain C interface) built with the
    port's nvcc flags into ``out_dir``; returns the library's path (named
    by a hash of the source, reused when it exists)."""
    from repro_torch.kernels import build
    source = pathlib.Path(source).resolve()
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    out = pathlib.Path(out_dir) / f"lib{source.stem}_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        # its includes resolve as from the checkout's copy
        inc = build.SOURCES["mamba_scan_bwd"].parent
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                               str(inc), "-o", str(out), str(source)],
                              capture_output=True, text=True)
        print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source}")
    return out


def first_version(lib_path, counter):
    """The first version's wrapper around its library: zero-filled
    per-head dB/dC parts, dx and ddt, fp32 outputs cast to the inputs'
    dtypes (the plain version for CPU tensors, as the wrapper); counts its
    calls on ``counter.launches``."""
    import torch

    from repro_torch.kernels.mamba_scan.kernel import (
        CHUNK, check_bwd_inputs, mamba_chunk_scan_bwd_plain)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.mamba_scan_bwd
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ptr, i64, ptr, ptr, i64] + [ptr] * 15 + \
        [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int

    def bwd(x, bm, cm, dt, a_log, row_start, row_len, dy):
        if x.device.type == "cpu":      # as the wrapper: the plain version
            return mamba_chunk_scan_bwd_plain(x, bm, cm, dt, a_log,
                                              row_start, row_len, dy)
        tt, r, h, p, n = check_bwd_inputs(x, bm, cm, dt, a_log, row_start,
                                          row_len, dy)
        dev = x.device
        g = tt // CHUNK + r
        f32 = dict(dtype=torch.float32, device=dev)
        states = torch.empty((g, h, p, n), **f32)
        dstates = torch.empty((g, h, p, n), **f32)
        dx = torch.zeros((tt, h, p), **f32)
        dbp = torch.zeros((tt, h, n), **f32)
        dcp = torch.zeros((tt, h, n), **f32)
        ddt = torch.zeros((tt, h), **f32)
        da_part = torch.zeros((g, h), **f32)
        dbm = torch.empty((tt, n), **f32)
        dcm = torch.empty((tt, n), **f32)
        da_log = torch.empty((h,), **f32)
        rc = fn(x.data_ptr(), x.stride(0), bm.data_ptr(), cm.data_ptr(),
                bm.stride(0), dt.data_ptr(), a_log.data_ptr(),
                row_start.data_ptr(), row_len.data_ptr(), dy.data_ptr(),
                states.data_ptr(), dstates.data_ptr(), dx.data_ptr(),
                dbp.data_ptr(), dcp.data_ptr(), ddt.data_ptr(),
                da_part.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
                da_log.data_ptr(), tt, r, h, p, n, g,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"first version's launch failed ({rc})")
        counter.launches += 1
        return (dx.to(x.dtype), dbm.to(bm.dtype), dcm.to(cm.dtype), ddt,
                da_log)

    return bwd


def current_interface(lib_path):
    """A library with this checkout's C interface, bound as
    ``kernel._bind_bwd`` binds the built one."""
    from repro_torch.kernels.mamba_scan import kernel as K
    lib = ctypes.CDLL(str(lib_path))
    ref = K._bind_bwd()
    for name in ("mamba_scan_bwd", "mamba_scan_bwd_error_string"):
        getattr(lib, name).argtypes = getattr(ref, name).argtypes
        getattr(lib, name).restype = getattr(ref, name).restype
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", required=True,
                    help="CUDA source of the other version")
    ap.add_argument("--old-interface", choices=("first", "current"),
                    default="first",
                    help="its C interface: the first version's or this "
                    "checkout's")
    ap.add_argument("--train", action="store_true",
                    help="also time zamba2-1.2b's training step per turn")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                 # puts this checkout's src first

    import numpy as np
    import torch

    from repro_torch.kernels.mamba_scan import kernel as K

    if not torch.cuda.is_available():
        print("mamba_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[bwd ab] card: {cs.card()}", flush=True)
    new = K.mamba_chunk_scan_bwd
    lib_path = compile_library(args.old_source, ROOT / "build" / "ab")
    built = K._bind_bwd
    if args.old_interface == "first":
        old = first_version(lib_path, new)
    else:
        old_lib = current_interface(lib_path)
        old = new

    def use(label):
        """The turn's kernel: ``kernel._bind_bwd`` gives the old library
        in an old turn of the same interface, the built one otherwise."""
        if args.old_interface == "current" and label == "old":
            K._bind_bwd = lambda: old_lib
        else:
            K._bind_bwd = built
        return old if label == "old" else new

    dev = torch.device("cuda")
    cases = []
    for case in cs.mamba_bwd_cases():
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        x, bm, cm, dt, a_log, rs, rl, _ = cs.mamba_inputs(case, gen, dev)
        dy = torch.randn((case[3], case[4], case[5]), generator=gen,
                         device=dev)
        ins = (x, bm, cm, dt, a_log, rs, rl, dy)
        cases.append((case[0], ins, K.mamba_chunk_scan_bwd_plain(*ins)))
    fam = cs.FAMILY_TRAIN
    for turn, label in enumerate(("old", "new", "new", "old")):
        fn = use(label)
        for name, ins, want in cases:
            got = fn(*ins)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                tol = cs.MAMBA_BWD_TOL[str(g_.dtype).split(".")[-1]]
                e = (g_.float() - w_.float()).abs().max().item()
                scale = w_.float().abs().max().item()
                if not np.isfinite(e) or e > tol * scale:
                    raise AssertionError(f"{label} {name}: error {e}")
            ms = cs.cuda_time_ms(lambda: fn(*ins), iters=10)
            extra = ""
            if fn is new:
                try:
                    a = cs.device_ms(lambda: fn(*ins),
                                     "mamba_bwd_states_kernel")
                    b = cs.device_ms(lambda: fn(*ins),
                                     "mamba_bwd_chunk_kernel")
                    extra = f" device_ms A={a:.4f} B={b:.4f}"
                except AssertionError as e:   # windows short of events
                    extra = f" device_ms not measured ({e})"
            print(f"[bwd ab] turn {turn} {label} {name}: ms={ms:.4f} (per "
                  f"call){extra}", flush=True)
        if args.train:
            K.mamba_chunk_scan_bwd = fn
            cs.FAMILY_TRAIN = fam[:1]
            try:
                print(f"[bwd ab] turn {turn} {label}: phase 5b zamba2-1.2b",
                      flush=True)
                cs.phase_train_families()
            finally:
                K.mamba_chunk_scan_bwd = new
                cs.FAMILY_TRAIN = fam
    K._bind_bwd = built
    print(f"[bwd ab] card: {cs.card()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
