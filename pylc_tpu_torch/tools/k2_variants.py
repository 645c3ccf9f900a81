"""Time build-time variants of K2's narrow kernels against each other.

    python -m pylc_tpu_torch.tools.k2_variants [--rounds N]

``csrc/fused_loss.cu`` stages K2b's span of 256 pixels x C floats in
shared memory, where a pixel's floats lie C words from its neighbour's,
and each thread walks its row word by word.  This builds copies of the
source with one choice rewritten (``VARIANTS``) side by side into
``pylc_tpu_torch/_build/``: the row read and written in 16- or 8-byte
pieces where C allows; word by word from a lane-skewed class (the wide
staged kernel's way round the banks that lanes C words apart meet in at
an even C); word by word in a row padded to C + 1 words at an even C (the
span copied in and out with 4-byte accesses through registers, since a
16-byte chunk no longer lands on one row); five resident blocks for the
staged kernel above 11 classes; and K2b's and K2a's direct kernels with
no resident blocks asked of the compiler.  Each variant's K2a, staged K2b
and direct K2b are checked against the plain versions and timed in turns,
from CUDA graphs of 50 launches, at ``SHAPES`` on CUDA device 0,
``--rounds`` times over.  Per variant it prints the staged kernel's
registers by class count and every instantiation that spills; per round,
shape and kernel the time and the error; last the card's ``name,
power.limit``.  It needs a card and nvcc and fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from pylc_tpu_torch.ops.kernels import _build
from pylc_tpu_torch.ops.kernels.fused_loss import (fused_backward_reference,
                                                   fused_forward_reference)
from pylc_tpu_torch.ops.losses import LossWeights

# [8, C, 512, 512] channels_last: the train step's logits at users' class
# counts (10 and 13: where the compiler left to itself spills in K2a) and
# both schemas'
SHAPES = [(8, C, 512, 512) for C in (6, 8, 10, 12, 13, 16, 9, 11)]

ROW_ACCESS = """#pragma unroll
    for (int c = 0; c < CT; ++c) v[c] = span[tid * CT + c];
    backward_pixel<CT>(v, target, stats, P);
#pragma unroll
    for (int c = 0; c < CT; ++c) span[tid * CT + c] = v[c];"""
PIXEL_HEAD = """template <int CT>
__device__ __forceinline__ void backward_pixel(float (&v)[CT], int target,
                                               const BwdStats& s,
                                               const BwdParams& P) {"""
VARIANTS = {  # name: source rewrites, applied in order, each of a text
    "default": {},  # found exactly once when it is applied
    # the row in 16-byte pieces where C % 4 == 0, 8-byte ones where C is
    # even: lanes C words apart then meet in no bank (twice at 16 classes)
    "pieces": {ROW_ACCESS: """    float* px = span + tid * CT;
    if constexpr (CT % 4 == 0) {
#pragma unroll
      for (int k = 0; k < CT / 4; ++k) {
        const float4 f = reinterpret_cast<const float4*>(px)[k];
        v[4 * k] = f.x;
        v[4 * k + 1] = f.y;
        v[4 * k + 2] = f.z;
        v[4 * k + 3] = f.w;
      }
    } else if constexpr (CT % 2 == 0) {
#pragma unroll
      for (int k = 0; k < CT / 2; ++k) {
        const float2 f = reinterpret_cast<const float2*>(px)[k];
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c) v[c] = px[c];
    }
    backward_pixel<CT>(v, target, stats, P);
    if constexpr (CT % 4 == 0) {
#pragma unroll
      for (int k = 0; k < CT / 4; ++k) {
        reinterpret_cast<float4*>(px)[k] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      }
    } else if constexpr (CT % 2 == 0) {
#pragma unroll
      for (int k = 0; k < CT / 2; ++k) {
        reinterpret_cast<float2*>(px)[k] = make_float2(v[2 * k], v[2 * k + 1]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c) px[c] = v[c];
    }"""},
    # lane l's walk starting at class (l g / 32) mod C, g the largest power
    # of two dividing C: the lanes meet in no bank
    "skewed": {
        ROW_ACCESS: """    constexpr int kG = CT & -CT;
    const int first = kG == 1 ? 0 : ((tid & 31) * kG) >> 5;
#pragma unroll
    for (int i = 0; i < CT; ++i) {
      const int c = i + first < CT ? i + first : i + first - CT;
      v[i] = span[tid * CT + c];
    }
    backward_pixel<CT>(v, target, stats, P, first);
#pragma unroll
    for (int i = 0; i < CT; ++i) {
      const int c = i + first < CT ? i + first : i + first - CT;
      span[tid * CT + c] = v[i];
    }""",
        PIXEL_HEAD: """template <int CT>
__device__ __forceinline__ void backward_pixel(float (&v)[CT], int target,
                                               const BwdStats& s,
                                               const BwdParams& P,
                                               int first = 0) {""",
        """  for (int c = 0; c < CT; ++c) {
    v[c] *= inv_se;
    if (c == target) {
      y = c;
      py = v[c];
    }
  }""": """  for (int i = 0; i < CT; ++i) {
    v[i] *= inv_se;
    if ((i + first < CT ? i + first : i + first - CT) == target) {
      y = target;
      py = v[i];
    }
  }""",
        """  for (int c = 0; c < CT; ++c) {
    gp += (c == y ? s.g_target[c] : s.g_other[c]) * v[c];
  }""": """  for (int i = 0; i < CT; ++i) {
    const int c = i + first < CT ? i + first : i + first - CT;
    gp += (c == y ? s.g_target[c] : s.g_other[c]) * v[i];
  }""",
        """  for (int c = 0; c < CT; ++c) {
    const float oh = (c == y) ? 1.f : 0.f;
    const float g = c == y ? s.g_target[c] : s.g_other[c];
    const float d = P.w_ce * (a_ce * (v[c] - oh)) +
                    P.w_focal * (a_focal * (oh - v[c])) +
                    P.w_dice * (v[c] * (g - gp));
    v[c] = d * s.ct;
  }""": """  for (int i = 0; i < CT; ++i) {
    const int c = i + first < CT ? i + first : i + first - CT;
    const float oh = (c == y) ? 1.f : 0.f;
    const float g = c == y ? s.g_target[c] : s.g_other[c];
    const float d = P.w_ce * (a_ce * (v[i] - oh)) +
                    P.w_focal * (a_focal * (oh - v[i])) +
                    P.w_dice * (v[i] * (g - gp));
    v[i] = d * s.ct;
  }""",
    },
    # an even class count's rows padded to C + 1 words, read word by word;
    # the span copied in and out with 4-byte accesses through registers
    "padded": {
        """  __shared__ __align__(16) float span[kThreads * CT];
  __shared__ BwdStats stats;
  const int tid = threadIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * kThreads;""":
        """  constexpr int kRow = CT % 2 == 0 ? CT + 1 : CT;
  __shared__ __align__(16) float span[kThreads * kRow];
  __shared__ BwdStats stats;
  const int tid = threadIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * kThreads;""",
        """  for (int i = tid; i < n_vec; i += kThreads) {
    cp_async_16(span + 4 * i, src + 4 * i);
  }
  for (int i = 4 * n_vec + tid; i < n_fl; i += kThreads) span[i] = src[i];
  load_stats(stats, acc, cw, cotangent, CT, P);
  const int target = tid < n_px ? t[n0 + tid] : 0;
  cp_async_wait_all();
  __syncthreads();""": """  for (int i = tid; i < n_fl; i += kThreads) {
    span[(i / CT) * kRow + i % CT] = src[i];
  }
  load_stats(stats, acc, cw, cotangent, CT, P);
  const int target = tid < n_px ? t[n0 + tid] : 0;
  __syncthreads();""",
        ROW_ACCESS: """#pragma unroll
    for (int c = 0; c < CT; ++c) v[c] = span[tid * kRow + c];
    backward_pixel<CT>(v, target, stats, P);
#pragma unroll
    for (int c = 0; c < CT; ++c) span[tid * kRow + c] = v[c];""",
        """  for (int i = tid; i < n_vec; i += kThreads) {
    *reinterpret_cast<float4*>(dst + 4 * i) =
        *reinterpret_cast<const float4*>(span + 4 * i);
  }
  for (int i = 4 * n_vec + tid; i < n_fl; i += kThreads) dst[i] = span[i];
}

// K2b, any accepted layout, CT classes""": """  for (int i = tid; i < n_fl; i += kThreads) {
    dst[i] = span[(i / CT) * kRow + i % CT];
  }
  static_cast<void>(n_vec);
}

// K2b, any accepted layout, CT classes""",
    },
    # above 11 classes five resident blocks (48 registers) instead of four
    "blocks_5": {"kStagedBlocks = CT <= 11 ? 6 : 4;":
                 "kStagedBlocks = CT <= 11 ? 6 : 5;"},
    # K2b's and K2a's direct kernels with no resident blocks asked for
    "direct_free": {"""__global__ void __launch_bounds__(kThreads, 4)
fused_loss_backward_direct_kernel(""": """__global__ void __launch_bounds__(kThreads)
fused_loss_backward_direct_kernel("""},
    "forward_free": {"__launch_bounds__(kThreads, kFwdBlocks<CT>)":
                     "__launch_bounds__(kThreads)"},
}




def start_build(name: str, rewrites):
    """Start nvcc on the source with ``rewrites`` made (each must match
    once); returns (its process, the library's path)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(_build.source_path("fused_loss")) as f:
        text = f.read()
    for old, new in rewrites.items():  # in order
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source exactly once")
        text = text.replace(old, new)
    source = os.path.join(_build.BUILD_DIR, f"fused_loss_{name}.cu")
    with open(source, "w") as f:
        f.write(text)
    so = os.path.join(_build.BUILD_DIR, f"libfused_loss_{name}.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, source],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def ptxas_report(out: str):
    """(the staged K2b's registers by class count, every instantiation
    that spills) from nvcc's ``-Xptxas -v`` output."""
    staged, spills, name = {}, [], None
    for line in out.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif name and "bytes spill stores" in line:
            if re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                         line) is None:
                spills.append(f"{name}: {line.split('   ')[-1].strip()}")
        elif name and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            if name.startswith("fused_loss_backward_staged_kernel<"):
                staged[int(name.split("<")[1][:-1])] = regs
            name = None
    return dict(sorted(staged.items())), spills


def finish_build(name: str, proc, so: str):
    """Wait for ``proc``; returns (library, its ptxas report)."""
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
    staged, spills = ptxas_report(out)
    lib = ctypes.CDLL(so)
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.fused_loss_backward_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, cl,
                                            cl, cl, cl, cl, ci, cf, cf, cf,
                                            cf, cf, cf, cf, ci, vp]
    lib.fused_loss_backward_f32.restype = ci
    lib.fused_loss_forward_f32.argtypes = [vp, vp, vp, vp, vp, ci, cl, cl,
                                           cl, cl, cl, ci, cf, cf, cf, ci,
                                           vp]
    lib.fused_loss_forward_f32.restype = ci
    lib.fused_loss_workspace.argtypes = [cl, cl, ci]
    lib.fused_loss_workspace.restype = cl
    return lib, (f"staged registers by C {staged}; spills: "
                 f"{'; '.join(spills) or 'none'}")


def graph_ms(fn, n: int = 50) -> float:
    """Mean device ms of ``fn`` over ``n`` calls replayed from one CUDA
    graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    w = LossWeights()
    cases = []
    for B, C, H, W in SHAPES:
        rng = np.random.default_rng(C)
        x = torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(
            np.float32) * 3).to(dev).contiguous(
                memory_format=torch.channels_last)
        t = torch.from_numpy(rng.integers(0, C, (B, H, W)).astype(
            np.uint8)).to(dev)
        cw = torch.ones(C, device=dev)
        ct = torch.tensor([0.75], device=dev)
        acc = fused_forward_reference(x, t, cw, w)
        cases.append({"shape": (B, C, H, W), "x": x, "t": t, "cw": cw,
                      "ct": ct, "acc": acc,
                      "dx": fused_backward_reference(x, t, cw, acc, ct, w)})

    def launch(lib, case, kernel, out):
        """One launch of ``kernel`` (K2a, K2b or K2b-direct) into out."""
        (B, C, H, W), x = case["shape"], case["x"]
        stream = torch.cuda.current_stream().cuda_stream
        common = (C, B * H * W, H * W, x.stride(0), x.stride(1),
                  x.stride(3), int(w.weighted), w.fl_alpha, w.fl_gamma,
                  w.eps)
        if kernel == "K2a":
            ws, acc = out
            err = lib.fused_loss_forward_f32(
                x.data_ptr(), case["t"].data_ptr(), case["cw"].data_ptr(),
                ws.data_ptr(), acc.data_ptr(), *common, 0, stream)
        else:
            err = lib.fused_loss_backward_f32(
                x.data_ptr(), case["t"].data_ptr(), case["cw"].data_ptr(),
                case["acc"].data_ptr(), case["ct"].data_ptr(),
                out.data_ptr(), *common, w.dice_smooth, w.ce, w.dice,
                w.focal, int(kernel == "K2b-direct"), stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def error(case, kernel, out):
        """Largest error against the plain version: relative per
        statistic for K2a, over the largest dlogit for K2b."""
        if kernel == "K2a":
            want = case["acc"]
            return ((out[1] - want).abs() / want.abs()).nan_to_num(0.0
                                                                ).max().item()
        want = case["dx"]
        return ((out - want).abs().max() / want.abs().max()).item()

    builds = {name: start_build(name, rw) for name, rw in VARIANTS.items()}
    libs = {}
    for name, (proc, so) in builds.items():
        libs[name], report = finish_build(name, proc, so)
        print(f"{name}: {report}", flush=True)
    for rnd in range(args.rounds):
        for case in cases:
            B, C, H, W = case["shape"]
            ws = torch.empty(libs["default"].fused_loss_workspace(
                B * H * W, H * W, C), device=dev)
            outs = {"K2a": (ws, torch.empty(3 * C + 4, device=dev)),
                    "K2b": torch.empty_like(case["x"]),
                    "K2b-direct": torch.empty_like(case["x"])}
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for kernel, out in outs.items():
                for name in order:
                    launch(libs[name], case, kernel, out)
                    torch.cuda.synchronize()
                    err = error(case, kernel, out)
                    ms = graph_ms(lambda: launch(libs[name], case, kernel,
                                                 out))
                    print(f"round {rnd} {list(case['shape'])} {kernel} "
                          f"{name}: {ms:.4f} ms, max_err {err:.3e}",
                          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
