"""Time build-time variants of K1's kernels against each other.

    python -m pylc_tpu_torch.tools.k1_variants [--wide] [--rounds N]

``csrc/crf_iteration.cu`` takes its tiled kernel's tile (``PYLC_K1_TX`` x
``PYLC_K1_TY`` pixels per block), the resident blocks it asks of the
compiler (``PYLC_K1_MIN_BLOCKS``) and the exp of the bilateral weight
(``PYLC_K1_WEIGHT_EXP``) from ``-D`` flags.  This builds the default and
the variants of ``VARIANTS`` side by side into ``pylc_tpu_torch/_build/``,
checks each against the plain version at the serving shape (C=9, G=3,
1024x1792, r=3), and times them in turns on CUDA device 0, ``--rounds``
times over.  With ``--wide`` it does the same for the wide kernel's
choices (``WIDE_VARIANTS``: copies of the source with one constant or
condition rewritten) at ``WIDE_SHAPES``: a pair of window rows a thread
against one up to r = 5, and past it the tile's halving and the threads
an instantiation is compiled for.  Per variant it prints the registers
and spills of the instantiations it builds and, per round and shape, the
time and the error; last the card's ``name, power.limit``.  The numbers
in the source's header come from here.  It needs a card and nvcc and
fails without them.
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

SHAPES = [(9, 3, 1024, 1792, 3)]  # C, G, H, W, r
SIGMAS = (3.0, 13.0, 1.5)       # spatial (appearance), colour, spatial (smooth)
WEIGHTS = (3.0, 1.0, 1e-8)      # w_app, w_sm, eps
VARIANTS = {                    # name: (-D flags, source rewrites)
    "default": ([], {}),
    "min_blocks_2": (["-DPYLC_K1_MIN_BLOCKS=2"], {}),
    "min_blocks_4": (["-DPYLC_K1_MIN_BLOCKS=4"], {}),
    "tile_64x4": (["-DPYLC_K1_TY=4", "-DPYLC_K1_MIN_BLOCKS=6"], {}),
    "tile_64x16": (["-DPYLC_K1_TY=16", "-DPYLC_K1_MIN_BLOCKS=1"], {}),
    "tile_128x4": (["-DPYLC_K1_TX=128", "-DPYLC_K1_TY=4"], {}),
    "fast_exp": (["-DPYLC_K1_WEIGHT_EXP=__expf"], {}),
}
# the wide kernel's instantiations (narrow<R> at C <= 16, wide<R> above) on
# the shapes chip_smoke.py's [k1] times them at
WIDE_SHAPES = [(9, 3, 1024, 1792, 2), (16, 3, 1024, 1792, 3),
               (6, 3, 1024, 1792, 3), (20, 3, 1024, 1792, 3),
               (128, 3, 512, 512, 3), (9, 3, 1024, 1792, 4),
               (9, 3, 1024, 1792, 5), (11, 1, 1024, 1792, 5),
               (9, 3, 1024, 1792, 6), (9, 3, 1024, 1792, 7),
               (9, 3, 1024, 1792, 8), (20, 3, 1024, 1792, 8),
               (128, 3, 512, 512, 8)]
WIDE_VARIANTS = {
    "default": ([], {}),
    # one window row a thread at every radius from 1 (the form past r = 5)
    "one_row": ([], {"constexpr int kWidePairMaxR = 5;":
                     "constexpr int kWidePairMaxR = 0;"}),
    # past r = 5, the tile never halved for two blocks an SM
    "no_halving": ([], {"  if (R > kWidePairMaxR &&":
                        "  if (false && R > kWidePairMaxR &&"}),
    # r = 7 compiled for its own threads; r = 6 for r = 8's
    "bound_own": ([], {"R == 7 ? kWideThreads<8>": "R == 7 ? kWideThreads<7>"}),
    "bound_largest": ([], {"R == 7 ? kWideThreads<8>":
                           "R >= 6 ? kWideThreads<8>"}),
}


def start_build(name: str, flags, rewrites):
    """Start nvcc on the source with ``rewrites`` made (each must match
    once) and ``flags``; returns (its process, the library's path)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    source = _build.source_path("crf_iteration")
    if rewrites:
        with open(source) as f:
            text = f.read()
        for old, new in rewrites.items():
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   "source exactly once")
            text = text.replace(old, new)
        source = os.path.join(_build.BUILD_DIR, f"crf_iteration_{name}.cu")
        with open(source, "w") as f:
            f.write(text)
    so = os.path.join(_build.BUILD_DIR, f"libcrf_iteration_{name}.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so, source],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish_build(name: str, proc, so: str, kernel: str):
    """Wait for ``proc``; returns (library, the ptxas lines of the
    instantiations of ``kernel``, by mangled name)."""
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
    lines = out.splitlines()
    mangled = f"{len(kernel.split('I')[0])}{kernel}"  # <length><name>...
    report = [f"[{l.split()[-1]}] "
              + " ".join(x.strip() for x in lines[i + 1:i + 3])
              for i, l in enumerate(lines)
              if "Function properties" in l and mangled in l]
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
    ap.add_argument("--wide", action="store_true",
                    help="the wide kernel's choices at WIDE_SHAPES")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    if args.wide:
        shapes, variants, kernel = WIDE_SHAPES, WIDE_VARIANTS, \
            "crf_wide_kernel"
    else:
        C, G, _, _, r = SHAPES[0]
        shapes, variants, kernel = SHAPES, VARIANTS, \
            f"crf_tiled_kernelILi{C}ELi{G}ELi{r}E"
    inv2 = [1.0 / (2.0 * s * s) for s in SIGMAS]
    cases = []
    for C, G, H, W, r in shapes:
        rng = np.random.default_rng(0)
        q = rng.random((C, H, W)).astype(np.float32)
        q /= q.sum(0, keepdims=True)
        g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
        u = np.log(q + 1e-8)
        q, g, u = (torch.from_numpy(a).to(dev) for a in (q, g, u))
        want = crf_iteration_reference(q, g, u, r, *SIGMAS, *WEIGHTS)
        cases.append(((C, G, H, W, r), q, g, u, want, torch.empty_like(q)))

    def launch(lib, case):
        (C, G, H, W, r), q, g, u, _, out = case
        err = lib.crf_iteration_f32(
            q.data_ptr(), g.data_ptr(), u.data_ptr(), out.data_ptr(), C, G,
            H, W, r, *inv2, *WEIGHTS, 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    builds = {name: start_build(name, *spec) for name, spec in
              variants.items()}
    libs = {}
    for name, (proc, so) in builds.items():
        libs[name], report = finish_build(name, proc, so, kernel)
        flags, rewrites = variants[name]
        what = " ".join(flags + [f"{o!r} -> {n!r}" for o, n in
                                 rewrites.items()]) or "as committed"
        print(f"{name} ({what}): {report}", flush=True)
    for rnd in range(args.rounds):
        for case in cases:
            for name, lib in libs.items():
                launch(lib, case)
                torch.cuda.synchronize()
                err = (case[5] - case[4]).abs().max().item()
                ms = cuda_ms(lambda: launch(lib, case))
                print(f"round {rnd} {case[0]} {name}: {ms:.4f} ms, "
                      f"max_abs_err {err:.3e}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
