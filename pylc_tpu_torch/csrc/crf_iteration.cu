// One dense-CRF mean-field iteration (local-window ConvCRF form), sm_90a.
//
// Replaces the TPU kernel pylc_tpu/ops/pallas/crf_kernel.py::crf_iteration
// (body _iter_kernel).  Same math, channel-major f32 tensors:
//
//   for each pixel x and each offset d != 0 in the (2r+1)^2 window, with
//   edge-replicated neighbours:
//     a      = exp(-|d|^2 / 2s_app^2) * exp(-|g(x) - g(x+d)|^2 / 2s_col^2)
//     m_app += a * q(x+d);  m_sm += exp(-|d|^2 / 2s_sm^2) * q(x+d);  wsum += a
//   out(x)  = softmax_C(u + w_app * m_app / (wsum + eps) + w_sm * m_sm)
//
// The bilateral weight is the product of two exps, as in the Pallas kernel
// (the XLA form in pylc_tpu/ops/crf.py takes the exp of the sum; the two
// differ at the ulp level).  The spatial factors are computed in double and
// rounded to float once per block, as Python computes them for the Pallas
// kernel.
//
// What bounds it on an H100: at the serving shape (C=9, G=3, a 1024x1792
// grid, r=3) one iteration must move (9 + 3 + 9 read, 9 written) x 1024 x
// 1792 x 4 B ~= 0.22 GB, 66 us at 3.35 TB/s, and does ~48 exps and
// ~48 x (2C + 9) flops per pixel (~1 GFLOP): far below the tensor cores'
// line, so memory and latency bound it.  The naive form (the plain torch
// version beside this kernel) re-reads the whole distribution from device
// memory once per offset, ~48 passes.  Here each block stages its
// (8 + 2r) x (32 + 2r) halo window of q and g in shared memory once, with
// clamped indices for the edge replication, and all 48 offsets read from
// there: device memory sees each byte about (1 + halo share) times.  One
// thread per output pixel keeps its m_app / m_sm accumulators in registers
// (bounded by kMaxC); a warp spans 32 consecutive columns, so the halo
// loads and the output stores are coalesced.  No tensor-core or TMA work:
// that is for a later, tuned form.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;  // threads per block along W: one warp per row
constexpr int kTileY = 8;   // threads per block along H
constexpr int kMaxC = 16;   // most classes a thread accumulates in registers
constexpr int kMaxG = 4;    // most guide channels
constexpr int kMaxR = 8;    // largest window radius
constexpr int kMaxWin = (2 * kMaxR + 1) * (2 * kMaxR + 1);

__global__ void __launch_bounds__(kTileX * kTileY)
crf_iteration_kernel(const float* __restrict__ q, const float* __restrict__ g,
                     const float* __restrict__ u, float* __restrict__ out,
                     int C, int G, int H, int W, int r, double inv2_sp_app,
                     float inv2_col, double inv2_sp_sm, float w_app,
                     float w_sm, float eps) {
  extern __shared__ float smem[];  // q window [C][SH][SW], then g [G][SH][SW]
  __shared__ float sp_app[kMaxWin];
  __shared__ float sp_sm[kMaxWin];

  const int side = 2 * r + 1;
  const int SW = kTileX + 2 * r;
  const int plane = (kTileY + 2 * r) * SW;
  const float* sq = smem;
  const float* sg = smem + C * plane;

  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int n_threads = kTileX * kTileY;
  const int y0 = blockIdx.y * kTileY - r;
  const int x0 = blockIdx.x * kTileX - r;
  const size_t HW = static_cast<size_t>(H) * W;

  for (int k = tid; k < side * side; k += n_threads) {
    const int dy = k / side - r;
    const int dx = k % side - r;
    const double d2 = static_cast<double>(dy * dy + dx * dx);
    sp_app[k] = static_cast<float>(exp(-d2 * inv2_sp_app));
    sp_sm[k] = static_cast<float>(exp(-d2 * inv2_sp_sm));
  }
  // halo window; clamped indices replicate the edge rows and columns
  for (int i = tid; i < (C + G) * plane; i += n_threads) {
    const int ch = i / plane;
    const int rem = i - ch * plane;
    const int sy = rem / SW;
    const int sx = rem - sy * SW;
    const int gy = min(max(y0 + sy, 0), H - 1);
    const int gx = min(max(x0 + sx, 0), W - 1);
    const size_t off = static_cast<size_t>(gy) * W + gx;
    smem[i] = ch < C ? q[ch * HW + off] : g[(ch - C) * HW + off];
  }
  __syncthreads();

  const int y = blockIdx.y * kTileY + threadIdx.y;
  const int x = blockIdx.x * kTileX + threadIdx.x;
  if (y >= H || x >= W) return;
  const int centre = (threadIdx.y + r) * SW + threadIdx.x + r;

  float gc[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) gc[j] = j < G ? sg[j * plane + centre] : 0.f;

  float m_app[kMaxC];
  float m_sm[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    m_app[c] = 0.f;
    m_sm[c] = 0.f;
  }
  float wsum = 0.f;

  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int s = centre + dy * SW + dx;
      float col = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        if (j < G) {
          const float d = gc[j] - sg[j * plane + s];
          col += d * d;
        }
      }
      const int k = (dy + r) * side + dx + r;
      const float aw = sp_app[k] * expf(-col * inv2_col);
      const float sw = sp_sm[k];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          const float qs = sq[c * plane + s];
          m_app[c] += aw * qs;
          m_sm[c] += sw * qs;
        }
      }
      wsum += aw;
    }
  }

  // logits overwrite m_app; softmax over the channel axis
  const size_t off = static_cast<size_t>(y) * W + x;
  const float denom = wsum + eps;
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      m_app[c] = u[c * HW + off] + w_app * m_app[c] / denom + w_sm * m_sm[c];
      mx = fmaxf(mx, m_app[c]);
    }
  }
  float total = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      m_app[c] = expf(m_app[c] - mx);
      total += m_app[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) out[c * HW + off] = m_app[c] / total;
  }
}

}  // namespace

// C entry for ctypes.  Returns a cudaError_t: the launch's own error (a
// refused configuration never runs, and a later synchronize would not
// report it), or cudaErrorInvalidValue for sizes outside the bounds above.
extern "C" int crf_iteration_f32(const float* q, const float* g,
                                 const float* u, float* out, int C, int G,
                                 int H, int W, int r, double inv2_sp_app,
                                 float inv2_col, double inv2_sp_sm,
                                 float w_app, float w_sm, float eps,
                                 void* stream) {
  if (C < 1 || C > kMaxC || G < 1 || G > kMaxG || r < 0 || r > kMaxR ||
      H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(C + G) * (kTileY + 2 * r) *
                      (kTileX + 2 * r) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        crf_iteration_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  crf_iteration_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, g, u, out, C, G, H, W, r, inv2_sp_app, inv2_col, inv2_sp_sm, w_app,
      w_sm, eps);
  return static_cast<int>(cudaGetLastError());
}
