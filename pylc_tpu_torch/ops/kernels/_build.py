"""Build and load the port's CUDA kernels: ``nvcc`` into a ``ctypes``
library, one library per source.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled for
``sm_90a`` (no fast math) into the git-ignored ``pylc_tpu_torch/_build/``
on first use, from the checkout's own source.  A library is rebuilt when
its source is newer, and written under a temporary name and renamed, so
no process ever loads a half-written file.  Nothing here runs at import.
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


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


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


def build(name: str, force: bool = False) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` if its library is missing or older than
    the source.  Returns (library path, nvcc's output: the ``-Xptxas -v``
    register and shared-memory report; empty when nothing was built)."""
    source, library = source_path(name), library_path(name)
    if (not force and os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, library)  # atomic: no process loads a half-written file
    return library, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built first if needed.
    The caller declares each function's ``argtypes`` and ``restype``."""
    path, _ = build(name)
    return ctypes.CDLL(path)
