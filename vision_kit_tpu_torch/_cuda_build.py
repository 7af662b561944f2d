"""Build-at-first-use of the port's CUDA sources into shared libraries.

Each csrc/<name>.cu has a plain C interface. It is compiled with nvcc for
sm_90a into vision_kit_tpu_torch/_build/<name>-<hash>.so, where the hash
covers the source, the headers beside it (csrc/*.cuh) and the flags, so a
change to any of them rebuilds. The library is loaded with ctypes. Nothing
is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # exactness: no FMA contraction, no fast math (see the sources)
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(src: str, tag: str) -> str:
    """Where the library of `src` is built: _build/<tag>-<hash>.so."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(os.path.dirname(src),
                                                      "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{tag}-{digest.hexdigest()[:16]}.so")


def build(name: str, src: str | None = None) -> str:
    """Compile csrc/<name>.cu (or `src`, built under the tag `name`) unless
    its library exists. Returns the library path; nvcc's output (registers,
    shared memory and spills per kernel) goes to <library>.log."""
    src = src or source_path(name)
    out = library_path(src, name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
