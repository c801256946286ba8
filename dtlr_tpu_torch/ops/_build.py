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


def _tool(name: str) -> str:
    """A CUDA toolkit program: $CUDA_HOME/bin (default /usr/local/cuda),
    else the PATH."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", name)
    if os.path.exists(path):
        return path
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: set CUDA_HOME or put it on PATH")
    return found


def _nvcc() -> str:
    return _tool("nvcc")


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


def sass_counts(library: str, opcodes: Sequence[str] = ("HMMA", "HGMMA")) -> Dict[str, Dict[str, int]]:
    """Per kernel of a built library (mangled name), how many of its SASS
    instructions start with each opcode, read with ``cuobjdump -sass``:
    HMMA for mma.sync on the tensor cores, HGMMA for wgmma."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = counts.setdefault(line.split("Function :", 1)[1].strip(),
                                        dict.fromkeys(opcodes, 0))
        elif current is not None and "*/" in line:
            # "/*0130*/   HMMA.16816.F32.BF16 R8, R4, R2, RZ ;  /* ... */"
            text = line.split("*/", 1)[1].strip()
            op = text.split()[0] if text else ""
            if op.startswith("@"):  # predicated: the opcode follows the guard
                op = text.split()[1] if len(text.split()) > 1 else ""
            base = op.split(".")[0]
            if base in current:
                current[base] += 1
    return counts


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The source's library, built first if it is not there."""
    so = library_path(source)
    if not os.path.exists(so):
        build([source])
    return ctypes.CDLL(so)
