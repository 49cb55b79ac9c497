"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` into ``i2v_adapter_tpu_torch/build/``
(git-ignored) at first use.  Libraries are keyed by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one loads at once.
Sources that need building are compiled in parallel, one nvcc each.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("flash_attention", "flash_attention_bwd", "temporal_attention", "conv3x3",
           "int8_matmul", "int8_conv3x3", "group_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.join(BUILD, f"{name}-{digest}")
    return src, stem + ".so", stem + ".log"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named source not yet built; returns per-source
    ``{"path", "seconds", "cached", "ptxas"}`` (ptxas = nvcc's register and
    shared-memory report).  Raises on a failed compile."""
    names = tuple(names or SOURCES)
    os.makedirs(BUILD, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        src, so, log = _paths(name)
        if os.path.exists(so):
            text = open(log).read() if os.path.exists(log) else ""
            report[name] = {"path": so, "seconds": 0.0, "cached": True, "ptxas": text}
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), time.perf_counter(), tmp, so, log)
    for name, (proc, t0, tmp, so, log) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        with open(log, "w") as f:
            f.write(out)
        os.replace(tmp, so)
        report[name] = {"path": so, "seconds": seconds, "cached": False, "ptxas": out}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name]["path"])
        _LIBS[name] = lib
    return lib


def entry(name: str, fn: str, argtypes):
    """The C entry point ``fn`` of ``csrc/<name>.cu`` with its argument
    types set (ctypes would otherwise pass each pointer as a 32-bit int);
    every entry point returns an int."""
    func = getattr(load(name), fn)
    if func.argtypes is None:
        func.argtypes = argtypes
        func.restype = ctypes.c_int
    return func
