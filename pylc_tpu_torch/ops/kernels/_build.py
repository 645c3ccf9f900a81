"""Build and load the port's native code: one ``ctypes`` library per
source under ``csrc/``.

Each ``csrc/<name>.cu`` (a CUDA kernel) has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` (no fast math); each
``csrc/<name>.cpp`` (host code) by ``g++``.  Libraries go into the
git-ignored ``pylc_tpu_torch/_build/`` on first use, from the checkout's
own source.  A library is rebuilt when its source is newer, and written
under a temporary name and renamed, so no process ever loads a
half-written file.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def source_path(name: str) -> str:
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cpp``."""
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR,
                                                      f"{name}.cpp")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit's nvcc (set PATH or CUDA_HOME)")


def gxx() -> str:
    """Path of ``g++``, or "" where the host has none."""
    return shutil.which("g++") or ""


def build(name: str, force: bool = False) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++) if
    its library is missing or older than the source.  Returns (library
    path, the compiler's output: for nvcc the ``-Xptxas -v`` register and
    shared-memory report; empty when nothing was built)."""
    source, library = source_path(name), library_path(name)
    if (not force and os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    if source.endswith(".cu"):
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    else:
        if not gxx():
            raise RuntimeError(f"g++ not found: cannot build {source}")
        cmd = [gxx(), *GXX_FLAGS, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed on "
                           f"{source}:\n{proc.stderr}")
    os.replace(tmp, library)  # atomic: no process loads a half-written file
    return library, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>``, built first if needed.
    The caller declares each function's ``argtypes`` and ``restype``."""
    path, _ = build(name)
    return ctypes.CDLL(path)
