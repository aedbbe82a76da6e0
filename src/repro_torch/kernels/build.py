"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under a ``csrc/`` directory exports plain C functions (device
pointers and the stream passed as ``void*``). It is compiled for
``sm_90a`` into a shared library at first use, under ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``); the library's name
carries a hash of its source and of every header it includes with
``#include "..."``, so an edited source or header is rebuilt. A failed
build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

# kernel library name -> CUDA source
SOURCES: Dict[str, pathlib.Path] = {
    "varlen_flash": _PKG / "flash_attention" / "csrc" / "varlen_flash.cu",
    "paged_decode": _PKG / "paged_attention" / "csrc" / "paged_decode.cu",
    "dense_flash": _PKG / "flash_attention" / "csrc" / "dense_flash.cu",
    "mamba_scan": _PKG / "mamba_scan" / "csrc" / "mamba_scan.cu",
    "mamba_scan_bwd": _PKG / "mamba_scan" / "csrc" / "mamba_scan_bwd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: pathlib.Path, seen=None) -> list:
    """``path`` and the local headers it includes, recursively (each
    resolved next to the file that includes it), in the order found."""
    seen = [] if seen is None else seen
    path = path.resolve()
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(SOURCES[name]):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together. Returns each library's compiler log
    (register and shared-memory use from ``-Xptxas -v``); raises if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
