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
// ~10 exps and a few dozen flops per pixel, far below the compute line, so
// device memory bounds both.  One thread per pixel keeps a pixel's C
// logits in registers (bounded by kMaxC); in channels_last a warp reads
// 32 consecutive pixels' classes, 32 x C x 4 contiguous bytes.  No TMA or
// tensor-core work: that is for a later, tuned form.

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

// K2b: dlogits at the logits' strides.
__global__ void __launch_bounds__(kThreads)
fused_loss_backward_kernel(const float* __restrict__ x,
                           const uint8_t* __restrict__ t,
                           const float* __restrict__ cw,
                           const float* __restrict__ acc,
                           const float* __restrict__ cotangent,
                           float* __restrict__ dx, int C, Layout L,
                           int weighted, float alpha, float gamma, float eps,
                           float smooth, float w_ce, float w_dice,
                           float w_focal) {
  __shared__ float s_num[kMaxC];
  __shared__ float s_den[kMaxC];
  __shared__ float s_scalar[3];  // wsum, count, cotangent
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    s_num[c] = 2.f * acc[c] + smooth;
    s_den[c] = acc[C + c] + acc[2 * C + c] + smooth;
  }
  if (threadIdx.x == 0) {
    s_scalar[0] = acc[3 * C + 1];
    s_scalar[1] = acc[3 * C + 3];
    s_scalar[2] = *cotangent;
  }
  __syncthreads();

  const long long n = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (n >= L.N) return;
  const long long base = offset(L, n);
  const int target = t[n];
  float p[kMaxC];
  float mx, lse;
  softmax(x, base, L.sC, C, p, mx, lse);

  int y = -1;
  float py = 0.f, wy = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C && c == target) {
      y = c;
      py = p[c];
      wy = weighted ? cw[c] : 1.f;
    }
  }
  const float px_w = weighted ? wy : 1.f;
  const float wsum = s_scalar[0];
  const float count = s_scalar[1];
  const float ct = s_scalar[2];
  const float a_ce = px_w / wsum;

  const float q = py + eps;
  const float fprime = -alpha * (-gamma * powf(1.f - q, gamma - 1.f) *
                                     logf(q) +
                                 powf(1.f - q, gamma) / q);
  const float a_focal = (fprime / count) * py;

  const float n_classes = static_cast<float>(C);
  float g[kMaxC];
  float gp = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const float oh = (c == y) ? 1.f : 0.f;
      const float den = s_den[c];
      g[c] = (s_num[c] - 2.f * oh * den) / (n_classes * (den * den));
      gp += g[c] * p[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const float oh = (c == y) ? 1.f : 0.f;
      const float d = w_ce * (a_ce * (p[c] - oh)) +
                      w_focal * (a_focal * (oh - p[c])) +
                      w_dice * (p[c] * (g[c] - gp));
      dx[base + c * L.sC] = d * ct;
    }
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

// K2b: dx (at the logits' strides) from K2a's out vector `acc` and the
// upstream cotangent of the total, both read on the device.
extern "C" int fused_loss_backward_f32(const float* x, const uint8_t* t,
                                       const float* cw, const float* acc,
                                       const float* cotangent, float* dx,
                                       int C, long long N, long long HW,
                                       long long sB, long long sC,
                                       long long sP, int weighted,
                                       float alpha, float gamma, float eps,
                                       float smooth, float w_ce,
                                       float w_dice, float w_focal,
                                       void* stream) {
  if (!layout_ok(C, N, HW)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{N, HW, sB, sC, sP};
  fused_loss_backward_kernel<<<static_cast<unsigned>(n_blocks(N)), kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
      x, t, cw, acc, cotangent, dx, C, L, weighted, alpha, gamma, eps,
      smooth, w_ce, w_dice, w_focal);
  return static_cast<int>(cudaGetLastError());
}
