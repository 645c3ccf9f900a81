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
// rounded to float once, as Python computes them for the Pallas kernel.
// No fast math and no intrinsic: expf is the full-precision one.
//
// What bounds it on an H100.  At the serving shape (C=9, G=3, a 1024x1792
// grid, r=3) one iteration must move (9 + 3 + 9 read, 9 written) x 1024 x
// 1792 x 4 B ~= 0.22 GB, 66 us at 3.35 TB/s, and does about
// 48 x (4C + 3G + 8) = 2,544 flop per pixel, 4.67 GFLOP, 70 us at the
// 67 TFLOP/s of fp32 outside the tensor cores: the two sides are level and
// the operations bind by a little.  Tensor cores do not serve it: every
// pixel has its own 48 weights, so there is no operand shared between
// pixels to make a matrix product of.  In practice the kernel is bound by
// instruction issue: ~33 arithmetic instructions per pixel and offset
// (2C FFMA, the guide distance, expf), ~1,600 per pixel, 0.10 ms at one
// instruction per scheduler and clock.
//
// Two kernels:
//
// crf_tiled_kernel<C, G, R>, for the sizes the package uses (the list is
// in crf_iteration_f32 below).  C, G and R are compile-time, so the class
// and offset loops unroll with no predicated slots.  What its design does:
//   - register tiling: a thread owns a strip of 4 pixels along x.  Per
//     window row and channel it reads the 12 neighbours x-4..x+7 from
//     shared memory with three 16-byte loads and uses them for all
//     4 x (2R+1) pixel-offset pairs: 9 shared-memory loads per pixel, row
//     and 12 channels where one thread per pixel made 84.  The 4 x (2C+1)
//     accumulators and the row's 4 x (2R+1) weights stay in registers.
//   - the spatial factors arrive as a kernel argument (constant bank,
//     indexed by |dy|, |dx|), with the centre's set to 0 so that the
//     window needs no branch: the centre adds exactly 0.
//   - a 64x8 pixel tile per block of 128 threads; the halo is staged by
//     rows as 16-byte cp.async chunks (no integer division by a runtime
//     value, row clamp for the top and bottom edge), and only the chunks
//     that cross the left or right image edge, or a grid whose width is
//     not a multiple of 4, take clamped scalar loads.  One wait for the
//     whole window: with three blocks resident per SM, another block's
//     arithmetic covers this one's staging.
//   - only the row loop stays rolled (the body is ~1,000 instructions;
//     unrolled seven times it would overflow the instruction cache).
//
// Measured at the serving shape on an H100 80GB HBM3 at 700 W (variants
// of this source built side by side with -D and timed in turns by
// pylc_tpu_torch/tools/k1_variants.py, 100 launches each): this form
// 0.227 ms, 168 registers, no spills, against 0.733 ms for the generic
// kernel.  The choices beside it:
//   - __launch_bounds__(128, 2) instead of 3: 0.226 ms (the same; 168
//     registers already fit three blocks); (128, 4): 128 registers with
//     200 B of spills, 0.240 ms.
//   - a 64x4 tile: 0.259 ms; 64x16: 0.280 ms; 128x4: 0.239 ms.  A lower
//     tile re-stages more halo rows, a taller one leaves one block per SM.
//   - __expf for the bilateral weight: 0.219 ms, error against the plain
//     version 2.1e-7 where expf has 1.8e-7; 3% did not pay for leaving
//     the full-precision expf, so it is not taken.
// What is left between 0.227 ms and the 0.10 ms of issue is latency: 12
// warps per SM (the registers' limit) do not cover expf's and the shared
// loads' latencies in a ~1,000-instruction loop body.
//
// crf_generic_kernel, for every other size within C <= 16, G <= 4,
// r <= 8: one thread per pixel, runtime sizes, the form this kernel had
// before the tiled one (0.73 ms at the serving shape against the tiled
// kernel's time in PERF.md).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxC = 16;   // most classes
constexpr int kMaxG = 4;    // most guide channels
constexpr int kMaxR = 8;    // largest window radius
constexpr int kMaxWin = (2 * kMaxR + 1) * (2 * kMaxR + 1);

// --------------------------------------------------------------------- //
// tiled kernel: compile-time sizes, 4 pixels per thread
// --------------------------------------------------------------------- //

// The tile, the resident blocks asked of the compiler and the weight's exp
// can be set at build time (-D), which is how the variants in the header
// were timed (pylc_tpu_torch/tools/k1_variants.py); the defaults are the
// kernel the package runs.
#ifndef PYLC_K1_TX
#define PYLC_K1_TX 64
#endif
#ifndef PYLC_K1_TY
#define PYLC_K1_TY 8
#endif
#ifndef PYLC_K1_MIN_BLOCKS
#define PYLC_K1_MIN_BLOCKS 3
#endif
#ifndef PYLC_K1_WEIGHT_EXP
#define PYLC_K1_WEIGHT_EXP expf
#endif

constexpr int kPX = 4;                 // pixels per thread along x
constexpr int kTX = PYLC_K1_TX;        // pixels per block along x
constexpr int kTY = PYLC_K1_TY;        // pixels per block along y
constexpr int kThreadsX = kTX / kPX;   // 16 at the default tile
constexpr int kTiledThreads = kThreadsX * kTY;  // 128 at the default tile
constexpr int kPad = 4;                // x halo, rounded up to one float4
constexpr int kSW = kTX + 2 * kPad;    // shared-memory row, floats
constexpr int kChunks = kSW / 4;       // 16-byte chunks per row
constexpr int kTabR = 4;               // table side: |d| in 0..kPad

// exp(-(dy^2 + dx^2) / 2 sigma^2) by |dy|, |dx|; the centre's entries are 0
struct SpatialTable {
  float app[(kTabR + 1) * (kTabR + 1)];
  float sm[(kTabR + 1) * (kTabR + 1)];
};

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

// Stage the halo window of `n_ch` channel planes of `src` into `dst`
// ([n_ch][SH][kSW]).  `vec`: rows are 16-byte aligned in device memory.
template <int SH>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int n_ch, int tid, int y0, int x0,
                                      int H, int W, size_t HW, bool vec) {
  const int total = n_ch * SH * kChunks;
  for (int i = tid; i < total; i += kTiledThreads) {
    const int row = i / kChunks;        // compile-time divisors
    const int cx = i - row * kChunks;
    const int ch = row / SH;
    const int sy = row - ch * SH;
    const int gy = min(max(y0 + sy, 0), H - 1);
    const int gx = x0 + 4 * cx;
    const float* s = src + ch * HW + static_cast<size_t>(gy) * W;
    float* d = dst + row * kSW + 4 * cx;
    if (vec && gx >= 0 && gx + 3 < W) {
      cp_async_16(d, s + gx);
    } else {  // image edge or unaligned rows: replicate by clamping
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = s[min(max(gx + k, 0), W - 1)];
    }
  }
}

template <int C, int G, int R>
__global__ void __launch_bounds__(kTiledThreads, PYLC_K1_MIN_BLOCKS)
crf_tiled_kernel(const float* __restrict__ q, const float* __restrict__ g,
                 const float* __restrict__ u, float* __restrict__ out, int H,
                 int W, const SpatialTable tab, float neg_inv2_col,
                 float w_app, float w_sm, float eps, int vec) {
  static_assert(R >= 1 && R <= kPad, "the x halo is one float4 wide");
  static_assert(C >= 1 && C <= kMaxC && G >= 1 && G <= kMaxG, "sizes");
  constexpr int SH = kTY + 2 * R;
  constexpr int kPlane = SH * kSW;
  constexpr int kSide = 2 * R + 1;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                  // [C][SH][kSW]
  float* sg = smem + C * kPlane;     // [G][SH][kSW]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int bx0 = blockIdx.x * kTX, by0 = blockIdx.y * kTY;
  const size_t HW = static_cast<size_t>(H) * W;

  stage<SH>(sg, g, G, tid, by0 - R, bx0 - kPad, H, W, HW, vec != 0);
  stage<SH>(sq, q, C, tid, by0 - R, bx0 - kPad, H, W, HW, vec != 0);
  cp_async_wait_all();
  __syncthreads();

  // this thread's strip: pixels (y, x .. x + 3); its float4-aligned row
  // segment in shared memory starts kPad floats to the left
  const int y = by0 + ty, x = bx0 + kPX * tx;
  const int seg = kPX * tx;          // column of x - kPad in the window

  float gc[G][kPX];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(
        sg + j * kPlane + (ty + R) * kSW + seg + kPad);
    gc[j][0] = v.x; gc[j][1] = v.y; gc[j][2] = v.z; gc[j][3] = v.w;
  }

  float m_app[kPX][C], m_sm[kPX][C], wsum[kPX];
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    wsum[p] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      m_app[p][c] = 0.f;
      m_sm[p][c] = 0.f;
    }
  }

#pragma unroll 1
  for (int wy = 0; wy < kSide; ++wy) {
    const int ady = wy < R ? R - wy : wy - R;
    const int row = (ty + wy) * kSW + seg;
    float spa[R + 1], sps[R + 1];
#pragma unroll
    for (int k = 0; k <= R; ++k) {
      spa[k] = tab.app[ady * (kTabR + 1) + k];
      sps[k] = tab.sm[ady * (kTabR + 1) + k];
    }

    // the row's 4 x (2R+1) bilateral weights, from the guide alone
    float aw[kPX][kSide];
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
#pragma unroll
      for (int k = 0; k < kSide; ++k) aw[p][k] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float v[12];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 t = *reinterpret_cast<const float4*>(
            sg + j * kPlane + row + 4 * k);
        v[4 * k] = t.x; v[4 * k + 1] = t.y; v[4 * k + 2] = t.z;
        v[4 * k + 3] = t.w;
      }
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
#pragma unroll
        for (int k = 0; k < kSide; ++k) {
          const float d = gc[j][p] - v[kPad + p + k - R];
          aw[p][k] += d * d;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
#pragma unroll
      for (int k = 0; k < kSide; ++k) {
        const int adx = k < R ? R - k : k - R;
        aw[p][k] = spa[adx] * PYLC_K1_WEIGHT_EXP(aw[p][k] * neg_inv2_col);
        wsum[p] += aw[p][k];
      }
    }

    // message passing: each class's 12 neighbours serve all 4 x (2R+1) pairs
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v[12];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 t = *reinterpret_cast<const float4*>(
            sq + c * kPlane + row + 4 * k);
        v[4 * k] = t.x; v[4 * k + 1] = t.y; v[4 * k + 2] = t.z;
        v[4 * k + 3] = t.w;
      }
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
#pragma unroll
        for (int k = 0; k < kSide; ++k) {
          const int adx = k < R ? R - k : k - R;
          const float qs = v[kPad + p + k - R];
          m_app[p][c] += aw[p][k] * qs;
          m_sm[p][c] += sps[adx] * qs;
        }
      }
    }
  }

  if (y >= H || x >= W) return;
  const size_t off = static_cast<size_t>(y) * W + x;
  const bool full = vec != 0 && x + kPX <= W;

  // logits overwrite m_app; softmax over the class axis, pixel by pixel
  float total_p[kPX];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float uu[kPX];
    if (full) {
      const float4 t = *reinterpret_cast<const float4*>(u + c * HW + off);
      uu[0] = t.x; uu[1] = t.y; uu[2] = t.z; uu[3] = t.w;
    } else {
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        uu[p] = x + p < W ? u[c * HW + off + p] : 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      m_app[p][c] = uu[p] + w_app * m_app[p][c] / (wsum[p] + eps) +
                    w_sm * m_sm[p][c];
    }
  }
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) mx = fmaxf(mx, m_app[p][c]);
    float total = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      m_app[p][c] = expf(m_app[p][c] - mx);
      total += m_app[p][c];
    }
    total_p[p] = total;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float o[kPX];
#pragma unroll
    for (int p = 0; p < kPX; ++p) o[p] = m_app[p][c] / total_p[p];
    if (full) {
      *reinterpret_cast<float4*>(out + c * HW + off) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        if (x + p < W) out[c * HW + off + p] = o[p];
      }
    }
  }
}

struct Args {
  const float* q;
  const float* g;
  const float* u;
  float* out;
  int H, W;
  double inv2_sp_app;
  float inv2_col;
  double inv2_sp_sm;
  float w_app, w_sm, eps;
  cudaStream_t stream;
};

template <int C, int G, int R>
int launch_tiled(const Args& a) {
  SpatialTable tab;
  for (int dy = 0; dy <= kTabR; ++dy) {
    for (int dx = 0; dx <= kTabR; ++dx) {
      const double d2 = static_cast<double>(dy * dy + dx * dx);
      const bool centre = dy == 0 && dx == 0;
      tab.app[dy * (kTabR + 1) + dx] =
          centre ? 0.f : static_cast<float>(std::exp(-d2 * a.inv2_sp_app));
      tab.sm[dy * (kTabR + 1) + dx] =
          centre ? 0.f : static_cast<float>(std::exp(-d2 * a.inv2_sp_sm));
    }
  }
  constexpr size_t smem =
      static_cast<size_t>(C + G) * (kTY + 2 * R) * kSW * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      crf_tiled_kernel<C, G, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = a.W % 4 == 0 && aligned(a.q) && aligned(a.g) &&
                  aligned(a.u) && aligned(a.out);
  const dim3 block(kThreadsX, kTY);
  const dim3 grid((a.W + kTX - 1) / kTX, (a.H + kTY - 1) / kTY);
  crf_tiled_kernel<C, G, R><<<grid, block, smem, a.stream>>>(
      a.q, a.g, a.u, a.out, a.H, a.W, tab, -a.inv2_col, a.w_app, a.w_sm,
      a.eps, vec);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------- //
// generic kernel: runtime sizes, one thread per pixel
// --------------------------------------------------------------------- //

constexpr int kGenX = 32;  // threads per block along W: one warp per row
constexpr int kGenY = 8;   // threads per block along H

__global__ void __launch_bounds__(kGenX * kGenY)
crf_generic_kernel(const float* __restrict__ q, const float* __restrict__ g,
                   const float* __restrict__ u, float* __restrict__ out,
                   int C, int G, int H, int W, int r, double inv2_sp_app,
                   float inv2_col, double inv2_sp_sm, float w_app,
                   float w_sm, float eps) {
  extern __shared__ float smem[];  // q window [C][SH][SW], then g [G][SH][SW]
  __shared__ float sp_app[kMaxWin];
  __shared__ float sp_sm[kMaxWin];

  const int side = 2 * r + 1;
  const int SW = kGenX + 2 * r;
  const int plane = (kGenY + 2 * r) * SW;
  const float* sq = smem;
  const float* sg = smem + C * plane;

  const int tid = threadIdx.y * kGenX + threadIdx.x;
  const int n_threads = kGenX * kGenY;
  const int y0 = blockIdx.y * kGenY - r;
  const int x0 = blockIdx.x * kGenX - r;
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

  const int y = blockIdx.y * kGenY + threadIdx.y;
  const int x = blockIdx.x * kGenX + threadIdx.x;
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

int launch_generic(const Args& a, int C, int G, int r) {
  const size_t smem = static_cast<size_t>(C + G) * (kGenY + 2 * r) *
                      (kGenX + 2 * r) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        crf_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kGenX, kGenY);
  const dim3 grid((a.W + kGenX - 1) / kGenX, (a.H + kGenY - 1) / kGenY);
  crf_generic_kernel<<<grid, block, smem, a.stream>>>(
      a.q, a.g, a.u, a.out, C, G, a.H, a.W, r, a.inv2_sp_app, a.inv2_col,
      a.inv2_sp_sm, a.w_app, a.w_sm, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// The sizes with a tiled instantiation: both schemas' class counts, an RGB
// or a grayscale guide, the default radius.
#define PYLC_K1_TILED_SIZES(X) X(9, 3, 3) X(11, 3, 3) X(9, 1, 3) X(11, 1, 3)

}  // namespace

// 1 if (C, G, r) has a tiled instantiation, else 0 (the generic kernel).
extern "C" int crf_iteration_is_tiled(int C, int G, int r) {
#define PYLC_K1_IS(C_, G_, R_) \
  if (C == C_ && G == G_ && r == R_) return 1;
  PYLC_K1_TILED_SIZES(PYLC_K1_IS)
#undef PYLC_K1_IS
  return 0;
}

// C entry for ctypes.  Returns a cudaError_t: the launch's own error (a
// refused configuration never runs, and a later synchronize would not
// report it), or cudaErrorInvalidValue for sizes outside the bounds above.
// generic != 0 takes the generic kernel whatever the sizes (to time one
// against the other).
extern "C" int crf_iteration_f32(const float* q, const float* g,
                                 const float* u, float* out, int C, int G,
                                 int H, int W, int r, double inv2_sp_app,
                                 float inv2_col, double inv2_sp_sm,
                                 float w_app, float w_sm, float eps,
                                 int generic, void* stream) {
  if (C < 1 || C > kMaxC || G < 1 || G > kMaxG || r < 0 || r > kMaxR ||
      H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, g, u, out, H, W, inv2_sp_app, inv2_col, inv2_sp_sm,
               w_app, w_sm, eps, static_cast<cudaStream_t>(stream)};
  if (!generic) {
#define PYLC_K1_LAUNCH(C_, G_, R_) \
  if (C == C_ && G == G_ && r == R_) return launch_tiled<C_, G_, R_>(a);
    PYLC_K1_TILED_SIZES(PYLC_K1_LAUNCH)
#undef PYLC_K1_LAUNCH
  }
  return launch_generic(a, C, G, r);
}
