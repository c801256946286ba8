"""Build the port's CUDA sources (``dtlr_tpu_torch/csrc/*.cu``) with nvcc
for sm_90a into shared libraries with a plain C interface, loaded with
ctypes. Each source gets one library under ``dtlr_tpu_torch/build/``,
named by the source's hash, so an edited source is rebuilt and an
unchanged one is not. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str) -> str:
    """``build/lib<name>_<hash of the source>.so``."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(sources: Sequence[str]) -> List[Dict]:
    """Compile every source with its own nvcc, all started together.
    Returns per source the library's path, the seconds nvcc took and what
    ptxas reported (registers, shared memory, spills); raises if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        so = library_path(src)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((src, so, tmp, proc, time.perf_counter()))
    results, failed = [], []
    for src, so, tmp, proc, t0 in jobs:
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {os.path.basename(src)} failed ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, so)
        results.append({"source": src, "path": so, "seconds": seconds, "ptxas": err})
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The source's library, built first if it is not there."""
    so = library_path(source)
    if not os.path.exists(so):
        build([source])
    return ctypes.CDLL(so)
