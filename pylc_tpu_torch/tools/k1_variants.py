"""Time build-time variants of K1's tiled kernel against each other.

    python -m pylc_tpu_torch.tools.k1_variants [--rounds N]

``csrc/crf_iteration.cu`` takes its tile (``PYLC_K1_TX`` x ``PYLC_K1_TY``
pixels per block), the resident blocks it asks of the compiler
(``PYLC_K1_MIN_BLOCKS``) and the exp of the bilateral weight
(``PYLC_K1_WEIGHT_EXP``) from ``-D`` flags.  This builds the default and
the variants of ``VARIANTS`` side by side into ``pylc_tpu_torch/_build/``,
checks each against the plain version at the serving shape (C=9, G=3,
1024x1792, r=3), and times them in turns on CUDA device 0, ``--rounds``
times over.  Per variant it prints the registers and spills of the
serving shape's instantiation and, per round, the time and the error;
last the card's ``name, power.limit``.  The numbers in the source's
header come from here.  It needs a card and nvcc and fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from pylc_tpu_torch.ops.kernels import _build
from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration_reference

SHAPE = (9, 3, 1024, 1792, 3)   # C, G, H, W, r
SIGMAS = (3.0, 13.0, 1.5)       # spatial (appearance), colour, spatial (smooth)
WEIGHTS = (3.0, 1.0, 1e-8)      # w_app, w_sm, eps
VARIANTS = {
    "default": [],
    "min_blocks_2": ["-DPYLC_K1_MIN_BLOCKS=2"],
    "min_blocks_4": ["-DPYLC_K1_MIN_BLOCKS=4"],
    "tile_64x4": ["-DPYLC_K1_TY=4", "-DPYLC_K1_MIN_BLOCKS=6"],
    "tile_64x16": ["-DPYLC_K1_TY=16", "-DPYLC_K1_MIN_BLOCKS=1"],
    "tile_128x4": ["-DPYLC_K1_TX=128", "-DPYLC_K1_TY=4"],
    "fast_exp": ["-DPYLC_K1_WEIGHT_EXP=__expf"],
}


def build_variant(name: str, flags):
    """nvcc with ``flags``; returns (library, the ptxas lines of the
    serving shape's tiled instantiation)."""
    so = os.path.join(_build.BUILD_DIR, f"libcrf_iteration_{name}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so,
         _build.source_path("crf_iteration")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    C, G, _, _, r = SHAPE
    tag = f"crf_tiled_kernelILi{C}ELi{G}ELi{r}E"
    report = [" ".join(l.strip() for l in lines[i + 1:i + 3])
              for i, l in enumerate(lines)
              if tag in l and "Function properties" in l]
    lib = ctypes.CDLL(so)
    vp, ci, cf, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_double
    lib.crf_iteration_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      cd, cf, cd, cf, cf, cf, ci, vp]
    lib.crf_iteration_f32.restype = ci
    return lib, " ".join(report)


def cuda_ms(fn, n: int = 100, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    C, G, H, W, r = SHAPE
    rng = np.random.default_rng(0)
    q = rng.random((C, H, W)).astype(np.float32)
    q /= q.sum(0, keepdims=True)
    g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
    u = np.log(q + 1e-8)
    q, g, u = (torch.from_numpy(a).to(dev) for a in (q, g, u))
    want = crf_iteration_reference(q, g, u, r, *SIGMAS, *WEIGHTS)
    out = torch.empty_like(q)
    inv2 = [1.0 / (2.0 * s * s) for s in SIGMAS]

    def launch(lib):
        err = lib.crf_iteration_f32(
            q.data_ptr(), g.data_ptr(), u.data_ptr(), out.data_ptr(), C, G,
            H, W, r, *inv2, *WEIGHTS, 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    libs = {}
    for name, flags in VARIANTS.items():
        libs[name], report = build_variant(name, flags)
        print(f"{name} ({' '.join(flags) or 'no flags'}): {report}",
              flush=True)
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            print(f"round {rnd} {name}: {cuda_ms(lambda: launch(lib)):.4f} "
                  f"ms, max_abs_err {err:.3e}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
