"""ctypes binding of the native frame-preprocessing library.

The library is the repository's ``csrc/preprocess.cpp`` (uint8 -> float32
conversion, aspect-preserving bilinear resize, center crop, [-1, 1] or
CLIP normalisation, horizontal flip; threaded across frames).  It is
compiled at first use with ``g++`` and the flags of ``csrc/Makefile`` into
``i2v_adapter_tpu_torch/build/`` (git-ignored), under a name keyed by a
hash of the source, the flags and the host's CPU model (``-march=native``
code runs only where it was built), so an edited source rebuilds and an
unchanged one loads at once; ``csrc/`` itself is only read.

This is host preprocessing, not a device kernel: when no compiler is
found (or the build fails) every entry point returns None and
``available()`` is False, and the dataset takes its numpy path, as the
JAX package's module does without its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from i2v_adapter_tpu_torch.utils.image import CLIP_MEAN, CLIP_STD

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "csrc", "preprocess.cpp")
BUILD = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
LD_FLAGS = ("-shared", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_lock = threading.Lock()


def _cpu() -> str:
    """The host's CPU model (``-march=native`` builds for it)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + " " + platform.processor()


def library_path() -> str:
    """Where the library for the current source, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS + (_cpu(),)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD, f"libi2vpre-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path.  Raises
    when no ``g++`` is found or the compile fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native preprocessing library needs a C++ compiler")
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at first use; None when it cannot be."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError) as e:
            logger.warning("native preprocessing unavailable, using numpy: %s", e)
            _load_failed = True
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ci = ctypes.c_int
        lib.preprocess_frames_pm1.argtypes = [u8p, ci, ci, ci, ci, f32p, ci, ci, ci]
        lib.preprocess_frames_clip.argtypes = [u8p, ci, ci, ci, ci, f32p, ci, ci, f32p, f32p, ci]
        lib.hflip_frames.argtypes = [f32p, ci, ci, ci, ci, ci]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _num_threads() -> int:
    return max(1, os.cpu_count() or 1)


def preprocess_frames_pm1(frames: np.ndarray, size: int) -> Optional[np.ndarray]:
    """(N, H, W, C) uint8 -> (N, size, size, C) float32 in [-1, 1]; None
    when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames)
    n, h, w, c = frames.shape
    out = np.empty((n, size, size, c), np.float32)
    lib.preprocess_frames_pm1(frames, n, h, w, c, out, size, size, _num_threads())
    return out


def preprocess_frames_clip(frames: np.ndarray, size: int = 224) -> Optional[np.ndarray]:
    """(N, H, W, C) uint8 -> (N, size, size, C) float32, CLIP-normalised."""
    lib = load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames)
    n, h, w, c = frames.shape
    out = np.empty((n, size, size, c), np.float32)
    lib.preprocess_frames_clip(frames, n, h, w, c, out, size, size,
                               np.ascontiguousarray(CLIP_MEAN), np.ascontiguousarray(CLIP_STD),
                               _num_threads())
    return out


def hflip_frames(frames: np.ndarray) -> Optional[np.ndarray]:
    """Flip (N, H, W, C) float32 frames left-right, in place when they are
    already float32 and contiguous."""
    lib = load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, np.float32)
    n, h, w, c = frames.shape
    lib.hflip_frames(frames, n, h, w, c, _num_threads())
    return frames


if __name__ == "__main__":
    print("available:", available(), library_path())
