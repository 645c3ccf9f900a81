// Fused CE + Dice + Focal multi-loss: forward partials (K2a) and the
// analytic backward (K2b), sm_90a.
//
// Replaces the TPU kernels of pylc_tpu/ops/pallas/fused_loss.py:
//   K2a  _fwd_kernel (launched by _fused_forward): one streaming pass over
//        the logits that reduces everything the three losses need;
//   K2b  _bwd_kernel (launched by _fused_bwd): d(total)/d(logits) per pixel
//        from K2a's reduced statistics, times the upstream cotangent.
//
// Logits are [B, C, H, W] f32 with any class stride and a pixel stride
// over the merged (H, W) index: contiguous NCHW (class stride H*W, pixel
// stride 1) and channels_last (class stride 1, pixel stride C) both read
// with no copy.  Targets are uint8 [B, H, W], contiguous.  A target outside
// [0, C) has no one-hot: it adds nothing to the CE sum or to the Dice
// intersection and count, it counts in N, and its focal term uses
// p_y = eps, as in the Pallas kernel.  Class weights are never indexed by
// a target: a pixel's weight is selected by comparing the target with each
// class in turn.
//
// K2a, per pixel (one thread each): softmax over C in registers, then
//   inter_c += p_c [y == c],  sump_c += p_c,  cnt_c += [y == c],
//   nll_sum += w_y * -log p_y,  wsum += w_y,
//   focal_sum += -alpha (1 - p_y - eps)^gamma log(p_y + eps),  count += 1.
// The 3C + 4 values are reduced per block (warp shuffles, then the block's
// warps through shared memory, in a fixed order) into one row of
// partials[n_blocks][3C + 4]; a second kernel of one block sums the rows
// in double, in a fixed order.  No atomics: the loss is the same from run
// to run.  The losses themselves (_losses_from_acc) are computed from the
// reduced vector by the caller.
//
// K2b, per pixel: recompute the softmax (no probabilities are stored),
// read the reduced statistics and the cotangent from device memory (no
// host sync), and write
//   dx = ct * ( w_ce (w_y / W)(p - onehot)
//             + w_focal f'(p_y + eps) p_y (onehot - p) / N
//             + w_dice p (g - <g, p>) ),
//   g_c = [(2 I_c + s) - 2 onehot_c (U_c + s)] / (C (U_c + s)^2),
// the formulas of fused_loss.py:199-221, at the logits' own strides.
//
// What bounds them on an H100: at the training slice ([8, 9, 512, 512]
// logits, 75.5 MB, plus 2.1 MB of targets) K2a must read 77.6 MB (23 us at
// 3.35 TB/s) and K2b must read that and write 75.5 MB (46 us); each does
// ~10 exps and a few dozen flops per pixel (K2b ~150 instructions, 0.02 ms
// of issue), far below the compute line, so device memory bounds both.
//
// K2a: one thread per pixel keeps a pixel's C logits in registers (bounded
// by kMaxC) and reads them at the logits' strides, one class at a time.
//
// K2b has two kernels.  The train step's logits are channels_last, so a
// pixel's C classes are C consecutive floats and thread n's reads of
// x[n C + c] touch a 32-byte sector for 4 bytes of it, C times over, and
// its writes reach L2 as partial sectors.  What the design does:
//   - fused_loss_backward_staged_kernel<C>, for dense channels_last logits
//     with C = 9 or 11 (both schemas; compile-time, so the class loops
//     unroll with no predicated slots): a block copies its contiguous span
//     of 256 pixels x C floats into shared memory with 16-byte cp.async
//     chunks, each thread takes its pixel's C values from there (stride C
//     words: C is odd, so the 32 lanes hit 32 banks), writes its dlogits
//     back into the same slots, and the block stores the span with 16-byte
//     coalesced writes.  Device memory sees only full sectors, each once.
//     Blocks are not persistent: six resident blocks per SM in different
//     phases overlap one's loads with another's arithmetic.
//   - fused_loss_backward_direct_kernel<C>, for every other case
//     (contiguous NCHW, where a warp's accesses are coalesced as they are;
//     an even or other class count; unaligned pointers): one thread per
//     pixel at the logits' strides.  The grid's y index is the image, so
//     no thread divides by H*W.
//   Both: the per-class dice terms g_c take two values (target or not), so
//   the first C threads compute them once per block, with a_ce per class;
//   p = e * (1 / sum) instead of C divisions; pow(1-q, gamma) is
//   (1-q) * pow(1-q, gamma-1) with one powf, and none at gamma = 2.  No
//   intrinsic and no fast math.
//   Measured at [8, 9, 512, 512] channels_last on an H100 80GB HBM3 at
//   700 W (chip_smoke.py's [k2] phase, the two kernels in turns): staged
//   0.057 ms (40 registers, 9,420 B of shared memory, no spills), direct
//   0.116 ms on the same tensor; the one kernel this file had before
//   (run-time C, a division per thread, two powf) took 0.204 ms
//   (pylc_tpu_torch/tools/time_kernels.py, the two checkouts in turns).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxC = 16;                 // most classes a thread holds
constexpr int kThreads = 256;             // pixels per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxV = 3 * kMaxC + 4;      // partials per block
constexpr int kReduceThreads = 1024;      // the one block of the final sum

struct Layout {
  long long N;   // pixels, B * H * W
  long long HW;  // pixels per image
  long long sB;  // batch stride (elements)
  long long sC;  // class stride
  long long sP;  // stride of the merged (H, W) pixel index
};

__device__ __forceinline__ long long offset(const Layout& L, long long n) {
  const long long b = n / L.HW;
  return b * L.sB + (n - b * L.HW) * L.sP;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Softmax of one pixel's logits into p[]; returns log(sum exp(x - max)) and
// the max through its arguments.
__device__ __forceinline__ void softmax(const float* __restrict__ x,
                                        long long base, long long sC, int C,
                                        float (&p)[kMaxC], float& mx,
                                        float& lse) {
  mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      p[c] = x[base + c * sC];
      mx = fmaxf(mx, p[c]);
    }
  }
  float se = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      p[c] = expf(p[c] - mx);
      se += p[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) p[c] = p[c] / se;
  }
  lse = logf(se);
}

// K2a, stage 1: one row of partials per block.
__global__ void __launch_bounds__(kThreads)
fused_loss_partials_kernel(const float* __restrict__ x,
                           const uint8_t* __restrict__ t,
                           const float* __restrict__ cw,
                           float* __restrict__ partials, int C, Layout L,
                           int weighted, float alpha, float gamma,
                           float eps) {
  __shared__ float warp_rows[kWarps][kMaxV];
  const int V = 3 * C + 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;

  float p[kMaxC];
  int y = -1;  // -1: no pixel, or a target outside [0, C)
  float nll = 0.f, px_w = 0.f, focal = 0.f, valid = 0.f;
  if (n < L.N) {
    valid = 1.f;
    const long long base = offset(L, n);
    const int target = t[n];
    float mx, lse;
    softmax(x, base, L.sC, C, p, mx, lse);
    float xy = 0.f, py = 0.f, wy = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C && c == target) {
        y = c;
        xy = x[base + c * L.sC];
        py = p[c];
        wy = weighted ? cw[c] : 1.f;
      }
    }
    if (y >= 0) nll = -((xy - mx) - lse);
    px_w = weighted ? wy : 1.f;
    const float q = py + eps;
    focal = -alpha * powf(1.f - q, gamma) * logf(q);
  } else {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) p[c] = 0.f;
  }

#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const float oh = (c == y) ? 1.f : 0.f;
      const float inter = warp_sum(p[c] * oh);
      const float sump = warp_sum(p[c]);
      const float cnt = warp_sum(oh);
      if (lane == 0) {
        warp_rows[warp][c] = inter;
        warp_rows[warp][C + c] = sump;
        warp_rows[warp][2 * C + c] = cnt;
      }
    }
  }
  const float s_nll = warp_sum(nll * px_w);
  const float s_w = warp_sum(px_w);
  const float s_focal = warp_sum(focal * valid);
  const float s_count = warp_sum(valid);
  if (lane == 0) {
    warp_rows[warp][3 * C + 0] = s_nll;
    warp_rows[warp][3 * C + 1] = s_w;
    warp_rows[warp][3 * C + 2] = s_focal;
    warp_rows[warp][3 * C + 3] = s_count;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_rows[w][threadIdx.x];
    partials[static_cast<long long>(blockIdx.x) * V + threadIdx.x] = s;
  }
}

// K2a, stage 2: one block sums the rows, warp w taking values w, w + 32, ...
__global__ void __launch_bounds__(kReduceThreads)
fused_loss_reduce_kernel(const float* __restrict__ partials,
                         float* __restrict__ out, int n_rows, int V) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int v = warp; v < V; v += kReduceThreads / 32) {
    double s = 0.0;
    for (int r = lane; r < n_rows; r += 32) {
      s += static_cast<double>(partials[static_cast<long long>(r) * V + v]);
    }
    s = warp_sum(s);
    if (lane == 0) out[v] = static_cast<float>(s);
  }
}

// ------------------------------------------------------------------- //
// K2b
// ------------------------------------------------------------------- //

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct BwdParams {
  int weighted;
  float alpha, gamma, eps, smooth, w_ce, w_dice, w_focal;
};

// What every pixel of a block shares, from K2a's statistics.
struct BwdStats {
  float g_other[kMaxC];   // dice term g_c where c is not the target
  float g_target[kMaxC];  // g_c where c is the target
  float a_ce[kMaxC + 1];  // w_y / wsum by target class; [C]: no class
  float count;
  float ct;
};

// The first C threads fill `s`; the caller synchronizes.
__device__ __forceinline__ void load_stats(BwdStats& s,
                                           const float* __restrict__ acc,
                                           const float* __restrict__ cw,
                                           const float* __restrict__ cotangent,
                                           int C, const BwdParams& P) {
  const int c = threadIdx.x;
  if (c < C) {
    const float num = 2.f * acc[c] + P.smooth;
    const float den = acc[C + c] + acc[2 * C + c] + P.smooth;
    const float scale = static_cast<float>(C) * (den * den);
    s.g_other[c] = num / scale;
    s.g_target[c] = (num - 2.f * den) / scale;
    s.a_ce[c] = (P.weighted ? cw[c] : 1.f) / acc[3 * C + 1];
  }
  if (c == 0) {
    s.a_ce[C] = (P.weighted ? 0.f : 1.f) / acc[3 * C + 1];
    s.count = acc[3 * C + 3];
    s.ct = *cotangent;
  }
}

// One pixel: v[] holds its logits on entry and its dlogits on return.
// CT > 0 is a compile-time class count; CT == 0 takes C <= kMaxC at run
// time, with the loops unrolled to kMaxC under a test.
template <int CT>
__device__ __forceinline__ void backward_pixel(
    float (&v)[CT > 0 ? CT : kMaxC], int C, int target, const BwdStats& s,
    const BwdParams& P) {
  constexpr int kN = CT > 0 ? CT : kMaxC;
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (CT > 0 || c < C) mx = fmaxf(mx, v[c]);
  }
  float se = 0.f;
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (CT > 0 || c < C) {
      v[c] = expf(v[c] - mx);
      se += v[c];
    }
  }
  const float inv_se = 1.f / se;
  int y = C;  // C: a target outside [0, C) has no class
  float py = 0.f;
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (CT > 0 || c < C) {
      v[c] *= inv_se;
      if (c == target) {
        y = c;
        py = v[c];
      }
    }
  }
  const float a_ce = s.a_ce[y];

  const float q = py + P.eps;
  const float b = 1.f - q;
  const float pw1 = P.gamma == 2.f ? b : powf(b, P.gamma - 1.f);
  const float fprime =
      -P.alpha * (-P.gamma * pw1 * logf(q) + (pw1 * b) / q);
  const float a_focal = (fprime / s.count) * py;

  float gp = 0.f;
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (CT > 0 || c < C) {
      gp += (c == y ? s.g_target[c] : s.g_other[c]) * v[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (CT > 0 || c < C) {
      const float oh = (c == y) ? 1.f : 0.f;
      const float g = c == y ? s.g_target[c] : s.g_other[c];
      const float d = P.w_ce * (a_ce * (v[c] - oh)) +
                      P.w_focal * (a_focal * (oh - v[c])) +
                      P.w_dice * (v[c] * (g - gp));
      v[c] = d * s.ct;
    }
  }
}

// K2b, dense channels_last: x and dx are flat [N][CT], 16-byte aligned.
template <int CT>
__global__ void __launch_bounds__(kThreads, 6)
fused_loss_backward_staged_kernel(const float* __restrict__ x,
                                  const uint8_t* __restrict__ t,
                                  const float* __restrict__ cw,
                                  const float* __restrict__ acc,
                                  const float* __restrict__ cotangent,
                                  float* __restrict__ dx, long long N,
                                  BwdParams P) {
  static_assert(CT % 2 == 1, "an even stride would hit shared-memory banks "
                             "twice");
  __shared__ __align__(16) float span[kThreads * CT];
  __shared__ BwdStats stats;
  const int tid = threadIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = N - n0;
  const int n_px = left < kThreads ? static_cast<int>(left) : kThreads;
  const int n_fl = n_px * CT;         // floats of this span
  const int n_vec = n_fl >> 2;        // whole 16-byte chunks
  const float* src = x + n0 * CT;     // 16-byte aligned: kThreads * CT * 4
  float* dst = dx + n0 * CT;

  for (int i = tid; i < n_vec; i += kThreads) {
    cp_async_16(span + 4 * i, src + 4 * i);
  }
  for (int i = 4 * n_vec + tid; i < n_fl; i += kThreads) span[i] = src[i];
  load_stats(stats, acc, cw, cotangent, CT, P);
  const int target = tid < n_px ? t[n0 + tid] : 0;
  cp_async_wait_all();
  __syncthreads();

  if (tid < n_px) {
    float v[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) v[c] = span[tid * CT + c];
    backward_pixel<CT>(v, CT, target, stats, P);
#pragma unroll
    for (int c = 0; c < CT; ++c) span[tid * CT + c] = v[c];
  }
  __syncthreads();

  for (int i = tid; i < n_vec; i += kThreads) {
    *reinterpret_cast<float4*>(dst + 4 * i) =
        *reinterpret_cast<const float4*>(span + 4 * i);
  }
  for (int i = 4 * n_vec + tid; i < n_fl; i += kThreads) dst[i] = span[i];
}

// K2b, any accepted layout: one thread per pixel at the logits' strides;
// blockIdx.y is the image.
template <int CT>
__global__ void __launch_bounds__(kThreads)
fused_loss_backward_direct_kernel(const float* __restrict__ x,
                                  const uint8_t* __restrict__ t,
                                  const float* __restrict__ cw,
                                  const float* __restrict__ acc,
                                  const float* __restrict__ cotangent,
                                  float* __restrict__ dx, int C, Layout L,
                                  BwdParams P) {
  constexpr int kN = CT > 0 ? CT : kMaxC;
  __shared__ BwdStats stats;
  load_stats(stats, acc, cw, cotangent, C, P);
  __syncthreads();

  const long long hw = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (hw >= L.HW) return;
  const long long b = blockIdx.y;
  const long long base = b * L.sB + hw * L.sP;
  const int target = t[b * L.HW + hw];
  float v[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (CT > 0 || c < C) v[c] = x[base + c * L.sC];
  }
  backward_pixel<CT>(v, C, target, stats, P);
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (CT > 0 || c < C) dx[base + c * L.sC] = v[c];
  }
}

bool layout_ok(int C, long long N, long long HW) {
  return C >= 1 && C <= kMaxC && N >= 1 && HW >= 1 && N % HW == 0;
}

long long n_blocks(long long N) { return (N + kThreads - 1) / kThreads; }

}  // namespace

// C entries for ctypes.  Each returns a cudaError_t: the launch's own error
// (a refused configuration never runs, and a later synchronize would not
// report it), or cudaErrorInvalidValue for sizes outside the bounds above.

// Floats of workspace K2a needs for N pixels and C classes.
extern "C" long long fused_loss_workspace(long long N, int C) {
  return n_blocks(N) * (3LL * C + 4);
}

extern "C" int fused_loss_max_classes() { return kMaxC; }

// K2a: out[3C + 4] = (inter[C], sump[C], cnt[C], nll_sum, wsum, focal_sum,
// count) over all N pixels.  workspace holds fused_loss_workspace(N, C)
// floats.
extern "C" int fused_loss_forward_f32(const float* x, const uint8_t* t,
                                      const float* cw, float* workspace,
                                      float* out, int C, long long N,
                                      long long HW, long long sB,
                                      long long sC, long long sP,
                                      int weighted, float alpha, float gamma,
                                      float eps, void* stream) {
  if (!layout_ok(C, N, HW)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{N, HW, sB, sC, sP};
  const long long blocks = n_blocks(N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_loss_partials_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(x, t, cw, workspace, C, L, weighted,
                                    alpha, gamma, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_loss_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      workspace, out, static_cast<int>(blocks), 3 * C + 4);
  return static_cast<int>(cudaGetLastError());
}

// Which K2b kernel the layout gets: 2 staged (dense channels_last, C = 9
// or 11, 16-byte aligned), 1 direct with a compile-time C, 0 direct with a
// run-time C.
extern "C" int fused_loss_backward_variant(const float* x, const float* dx,
                                           int C, long long HW, long long sB,
                                           long long sC, long long sP) {
  const bool known = C == 9 || C == 11;
  const bool flat = sC == 1 && sP == C && sB == HW * C;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  return known ? (flat && aligned ? 2 : 1) : 0;
}

// K2b: dx (at the logits' strides) from K2a's out vector `acc` and the
// upstream cotangent of the total, both read on the device.  direct != 0
// takes the direct kernel whatever the layout (to time one against the
// other).
extern "C" int fused_loss_backward_f32(const float* x, const uint8_t* t,
                                       const float* cw, const float* acc,
                                       const float* cotangent, float* dx,
                                       int C, long long N, long long HW,
                                       long long sB, long long sC,
                                       long long sP, int weighted,
                                       float alpha, float gamma, float eps,
                                       float smooth, float w_ce,
                                       float w_dice, float w_focal,
                                       int direct, void* stream) {
  if (!layout_ok(C, N, HW) || N / HW > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L{N, HW, sB, sC, sP};
  const BwdParams P{weighted, alpha, gamma, eps, smooth, w_ce, w_dice,
                    w_focal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = fused_loss_backward_variant(x, dx, C, HW, sB, sC, sP);
  if (variant == 2 && !direct) {
    const unsigned blocks = static_cast<unsigned>(n_blocks(N));
    if (C == 9) {
      fused_loss_backward_staged_kernel<9><<<blocks, kThreads, 0, s>>>(
          x, t, cw, acc, cotangent, dx, N, P);
    } else {
      fused_loss_backward_staged_kernel<11><<<blocks, kThreads, 0, s>>>(
          x, t, cw, acc, cotangent, dx, N, P);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(n_blocks(HW)),
                  static_cast<unsigned>(N / HW));
  if (C == 9) {
    fused_loss_backward_direct_kernel<9><<<grid, kThreads, 0, s>>>(
        x, t, cw, acc, cotangent, dx, C, L, P);
  } else if (C == 11) {
    fused_loss_backward_direct_kernel<11><<<grid, kThreads, 0, s>>>(
        x, t, cw, acc, cotangent, dx, C, L, P);
  } else {
    fused_loss_backward_direct_kernel<0><<<grid, kThreads, 0, s>>>(
        x, t, cw, acc, cotangent, dx, C, L, P);
  }
  return static_cast<int>(cudaGetLastError());
}
