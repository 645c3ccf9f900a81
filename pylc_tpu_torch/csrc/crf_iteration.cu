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
// Up to 16 classes, three forms:
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
// narrow<R>, for every other size within C <= 16, G <= 4 at
// 1 <= r <= kWideMaxR = 5 (another --crf_radius, a schema of another class
// count): the wide kernel below, crf_wide_kernel<R>, with 1 to 4 chunks of
// kWideK classes and zero planes past C.  What the generic kernel spends
// and it does not: run-time C, G and r (the window loops do not unroll;
// the class loops run to kGenericC under a test whatever C), two FMAs and
// a 4-byte shared load per class and offset, and the (2r+1)^2 - 1 weights
// of every pixel made by every pass over its classes.  Measured on an
// H100 80GB HBM3 at 700 W (chip_smoke.py's [k1], a CUDA graph of 50
// launches, the generic kernel in turns) at C = 9, G = 3 on 1024x1792:
// r = 2 0.229 ms against 0.450, r = 4 0.633 against 1.109, r = 5 0.744
// against 1.574; 1.75x to 2.20x at the six narrow shapes of PERF.md.
// Tried on the same card and not kept: a narrow template beside it (every
// chunk staged at once with one wait, no ring, the parts' sums added once
// at the end, 4-row tiles at r >= 4), a build of each timed in turns
// (host loops of 100 launches): 0.296, 0.609 and 0.690 ms against the wide
// kernel's 0.229, 0.634 and 0.745 at r = 2, 4 and 5; 29% over it at r = 2
// and at most 7% under it elsewhere, for a second kernel of ~200 lines.
//
// crf_generic_kernel, for r = 6 to 8 within C <= 16, G <= 4 (a thread
// cannot hold those radii's coefficients), and at r = 0 (no window: the
// iteration is the softmax of u, and the wide kernel's staging of q and
// the guide is wasted; 0.0037 ms against its 0.0043 on 37x70 at C = 1, in
// turns in [k1]): one thread per pixel, runtime sizes, the form this
// kernel had before the tiled one (0.73 ms at the serving shape against
// the tiled kernel's time in PERF.md; 58 registers, no stack); every
// size's yardstick (crf_iteration_generic).
//
// For 17 to 128 classes (the JAX package's Pallas kernel takes any C; its
// fused loss stops at 128, and so does this source), G <= 4, two kernels.
// The first, crf_wide_kernel<R>, also runs the narrow sizes above.
// Neither can hold a pixel's 2C accumulators in registers or the q window
// of every class in shared memory (272 KB at C = 128, r = 3), so both walk
// the classes in chunks.
//
// crf_wide_kernel<R>, for r <= kWideMaxR = 5 (R compile-time, C and G at
// run time).  At C = 20 on the slice's grid one iteration must move
// (3C + G) H W 4 B = 0.46 GB (0.138 ms at 3.35 TB/s); its work is 48
// products per pixel and class.  What its design does:
//   - the window's weights once per launch, in registers: thread (part,
//     strip) holds a strip of 4 pixels and a pair of window rows (the
//     parts of a block cover the window), and turns its 2 x 7 x 4 bilateral
//     weights into the coefficients w_app a / (wsum + eps) + w_sm s of
//     q(x + d) in the logit once wsum is summed over the parts.  A message
//     is then one FMA per pixel, offset and class, and the exps are made
//     once whatever C is (the simple form made them once per chunk).
//   - the classes in chunks of kWideK = 4 with compile-time width: a chunk
//     past C is zero-filled in shared memory, so the class loop unrolls
//     with no predicate.  The q windows of kWideStages = 4 chunks are in
//     flight at a time (cp.async, a ring of slots; 16-byte chunks, clamped
//     scalar loads only at the image's edge), one barrier per chunk.
//   - the tile's logits stay in shared memory: u arrives by cp.async into
//     the logits' rows with its chunk, part 0 adds its sums and the other
//     parts' (written to shared memory by parity of the chunk) onto it,
//     and the softmax is taken there; `out` is written once, each class's
//     tile row one coalesced store per warp, and u is read once.
//   - a 32 x 8 tile (4 rows on a grid of fewer blocks than the card has
//     SMs), 64 strips x 4 parts = 256 threads at r = 3: 128 registers, two
//     blocks an SM (__launch_bounds__), 80,896 B of shared memory at C = 20.
// Measured at C = 20, G = 3, 1024x1792, r = 3 on an H100 80GB HBM3 at
// 700 W (chip_smoke.py's [k1], 50 launches replayed from a CUDA graph):
// 0.533 ms against 1.47 ms for the simple form on the same tensors in
// turns; 0.68 ms against 1.25 at C = 128 on 512x512.  Tried on the same
// card and not kept: the weights in shared memory (48 KB at r = 3) with two
// FMAs per term, 0.745 ms (shared-memory loads bound it); the same at
// 128 threads, 1.18 ms.
//
// crf_wide_simple_kernel, for r > kWideMaxR (its coefficients would not
// fit in registers): one thread per pixel, the form the wide kernel had
// first.  Per chunk of kChunk = 16 classes it stages that chunk's q window
// beside the guide's (staged once), recomputes the pixel's weights, writes
// the chunk's logits to `out` and keeps a running max; a second pass over
// `out` turns the logits into the softmax in place.  Its shared memory is
// (16 + G)(8 + 2r)(32 + 2r) floats whatever C is (92 KB at G = 4, r = 8).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxC = 128;  // most classes (the JAX package's limit)
constexpr int kGenericC = 16;  // most classes the generic kernel holds
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

// exp(-(dy^2 + dx^2) / 2 sigma^2) for the appearance and smoothness
// kernels by |dy|, |dx| < N, computed in double and rounded once, as Python
// computes them for the Pallas kernel; the centre's entries are 0.
template <int N, class Table>
Table spatial_table(const Args& a) {
  Table tab;
  for (int dy = 0; dy < N; ++dy) {
    for (int dx = 0; dx < N; ++dx) {
      const double d2 = static_cast<double>(dy * dy + dx * dx);
      const bool centre = dy == 0 && dx == 0;
      tab.app[dy * N + dx] =
          centre ? 0.f : static_cast<float>(std::exp(-d2 * a.inv2_sp_app));
      tab.sm[dy * N + dx] =
          centre ? 0.f : static_cast<float>(std::exp(-d2 * a.inv2_sp_sm));
    }
  }
  return tab;
}

// 1 if every row of every operand is whole 16-byte chunks: W a multiple of
// 4 and the pointers 16-byte aligned.
int rows_vectorize(const Args& a) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return a.W % 4 == 0 && aligned(a.q) && aligned(a.g) && aligned(a.u) &&
         aligned(a.out);
}

template <int C, int G, int R>
int launch_tiled(const Args& a) {
  const auto tab = spatial_table<kTabR + 1, SpatialTable>(a);
  constexpr size_t smem =
      static_cast<size_t>(C + G) * (kTY + 2 * R) * kSW * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      crf_tiled_kernel<C, G, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(kThreadsX, kTY);
  const dim3 grid((a.W + kTX - 1) / kTX, (a.H + kTY - 1) / kTY);
  crf_tiled_kernel<C, G, R><<<grid, block, smem, a.stream>>>(
      a.q, a.g, a.u, a.out, a.H, a.W, tab, -a.inv2_col, a.w_app, a.w_sm,
      a.eps, rows_vectorize(a));
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

  float m_app[kGenericC];
  float m_sm[kGenericC];
#pragma unroll
  for (int c = 0; c < kGenericC; ++c) {
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
      for (int c = 0; c < kGenericC; ++c) {
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
  for (int c = 0; c < kGenericC; ++c) {
    if (c < C) {
      m_app[c] = u[c * HW + off] + w_app * m_app[c] / denom + w_sm * m_sm[c];
      mx = fmaxf(mx, m_app[c]);
    }
  }
  float total = 0.f;
#pragma unroll
  for (int c = 0; c < kGenericC; ++c) {
    if (c < C) {
      m_app[c] = expf(m_app[c] - mx);
      total += m_app[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kGenericC; ++c) {
    if (c < C) out[c * HW + off] = m_app[c] / total;
  }
}

// Static shared memory of the generic and simple wide kernels (their
// spatial tables): a launch above 48 KB in all must opt in.
constexpr size_t kTablesBytes = 2 * kMaxWin * sizeof(float);

int launch_generic(const Args& a, int C, int G, int r) {
  const size_t smem = static_cast<size_t>(C + G) * (kGenY + 2 * r) *
                      (kGenX + 2 * r) * sizeof(float);
  if (smem + kTablesBytes > 48 * 1024) {
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

// --------------------------------------------------------------------- //
// simple wide kernel: runtime sizes, classes in chunks, one thread per
// pixel, the window's weights once per chunk
// --------------------------------------------------------------------- //

constexpr int kChunk = kGenericC;  // classes staged and held at a time

__global__ void __launch_bounds__(kGenX * kGenY)
crf_wide_simple_kernel(const float* __restrict__ q, const float* __restrict__ g,
                const float* __restrict__ u, float* __restrict__ out, int C,
                int G, int H, int W, int r, double inv2_sp_app,
                float inv2_col, double inv2_sp_sm, float w_app, float w_sm,
                float eps) {
  extern __shared__ float smem[];  // g window [G][SH][SW], then q [kChunk]..
  __shared__ float sp_app[kMaxWin];
  __shared__ float sp_sm[kMaxWin];

  const int side = 2 * r + 1;
  const int SW = kGenX + 2 * r;
  const int plane = (kGenY + 2 * r) * SW;
  float* sg = smem;
  float* sq = smem + G * plane;

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
  // the guide's halo window, once; clamped indices replicate the edges
  for (int i = tid; i < G * plane; i += n_threads) {
    const int ch = i / plane;
    const int rem = i - ch * plane;
    const int sy = rem / SW;
    const int sx = rem - sy * SW;
    const int gy = min(max(y0 + sy, 0), H - 1);
    const int gx = min(max(x0 + sx, 0), W - 1);
    sg[i] = g[ch * HW + static_cast<size_t>(gy) * W + gx];
  }

  __syncthreads();

  const int y = blockIdx.y * kGenY + threadIdx.y;
  const int x = blockIdx.x * kGenX + threadIdx.x;
  const bool live = y < H && x < W;  // no early return: the block syncs
  const size_t off = live ? static_cast<size_t>(y) * W + x : 0;
  const int centre = (threadIdx.y + r) * SW + threadIdx.x + r;
  float gc[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) gc[j] = j < G ? sg[j * plane + centre] : 0.f;
  float mx = -INFINITY;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    if (c0 > 0) __syncthreads();  // the last chunk's reads are done
    for (int i = tid; i < nc * plane; i += n_threads) {
      const int ch = i / plane;
      const int rem = i - ch * plane;
      const int sy = rem / SW;
      const int sx = rem - sy * SW;
      const int gy = min(max(y0 + sy, 0), H - 1);
      const int gx = min(max(x0 + sx, 0), W - 1);
      sq[i] = q[(c0 + ch) * HW + static_cast<size_t>(gy) * W + gx];
    }
    __syncthreads();
    if (!live) continue;

    float m_app[kChunk];
    float m_sm[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
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
        for (int c = 0; c < kChunk; ++c) {
          if (c < nc) {
            const float qs = sq[c * plane + s];
            m_app[c] += aw * qs;
            m_sm[c] += sw * qs;
          }
        }
        wsum += aw;
      }
    }
    // the chunk's logits go to `out`, the running max stays here
    const float denom = wsum + eps;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < nc) {
        const size_t o = (c0 + c) * HW + off;
        const float logit = u[o] + w_app * m_app[c] / denom + w_sm * m_sm[c];
        out[o] = logit;
        mx = fmaxf(mx, logit);
      }
    }
  }
  if (!live) return;

  // softmax over the classes, in place: every logit is this thread's own
  float total = 0.f;
  for (int c = 0; c < C; ++c) total += expf(out[c * HW + off] - mx);
  for (int c = 0; c < C; ++c) {
    const size_t o = c * HW + off;
    out[o] = expf(out[o] - mx) / total;
  }
}

int launch_wide_simple(const Args& a, int C, int G, int r) {
  const size_t smem = static_cast<size_t>(kChunk + G) * (kGenY + 2 * r) *
                      (kGenX + 2 * r) * sizeof(float);
  if (smem + kTablesBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        crf_wide_simple_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kGenX, kGenY);
  const dim3 grid((a.W + kGenX - 1) / kGenX, (a.H + kGenY - 1) / kGenY);
  crf_wide_simple_kernel<<<grid, block, smem, a.stream>>>(
      a.q, a.g, a.u, a.out, C, G, a.H, a.W, r, a.inv2_sp_app, a.inv2_col,
      a.inv2_sp_sm, a.w_app, a.w_sm, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------- //
// wide kernel: 17 to 128 classes, the weights once, the logits on chip
// --------------------------------------------------------------------- //

constexpr int kWideTX = 32;                  // tile columns
constexpr int kWideStripsX = kWideTX / kPX;  // strips of kPX pixels a row
constexpr int kWideK = 4;                    // classes per staged chunk
constexpr int kWideStages = 4;               // chunks staged at a time
constexpr int kWideRows = 2;                 // window rows per thread
constexpr int kWideMaxR = 5;                 // largest radius it takes
constexpr int kWideTY = 8;                   // tile rows (kWideSmallTY on a
constexpr int kWideSmallTY = 4;              // grid of fewer blocks than SMs)

// exp(-(dy^2 + dx^2) / 2 sigma^2) by |dy|, |dx| <= kWideMaxR; the centre's
// entries are 0
struct WideTable {
  float app[(kWideMaxR + 1) * (kWideMaxR + 1)];
  float sm[(kWideMaxR + 1) * (kWideMaxR + 1)];
};

template <int R>
constexpr int kWidePad = (R + 3) / 4 * 4;     // x halo, whole float4s
template <int R>
constexpr int kWideSW = kWideTX + 2 * kWidePad<R>;  // staged row, floats
template <int R>
constexpr int kWideParts = (2 * R + 1 + 1) / kWideRows;  // row pairs
// threads of a full-height tile: a strip of kPX pixels by a row pair
template <int R>
constexpr int kWideThreads = kWideStripsX * kWideTY * kWideParts<R>;
// blocks an SM should hold: two up to r = 3 (at most 128 registers)
template <int R>
constexpr int kWideMinBlocks = R <= 3 ? 2 : 1;
// floats of the parts' sums: two chunks' of parts 1.., or first the wsums
template <int R>
constexpr int kWideSums = 2 * (kWideParts<R> - 1) * kWideK > kWideParts<R>
                              ? 2 * (kWideParts<R> - 1) * kWideK
                              : kWideParts<R>;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [y0, y0 + SH) and columns [x0, x0 + SW) of the first n_live
// of n_ch channel planes of `src` into dst ([n_ch][SH][SW]), replicating
// the edges by clamping; planes n_live .. n_ch - 1 are zero-filled.  Whole
// 16-byte chunks inside the image go by cp.async (the caller commits).
template <int SW>
__device__ __forceinline__ void stage_planes(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             int n_ch, int n_live, int SH,
                                             int y0, int x0, int H, int W,
                                             size_t HW, bool vec) {
  constexpr int kRowChunks = SW / 4;
  const int per_plane = SH * kRowChunks;
  for (int ch = 0; ch < n_ch; ++ch) {
    float* plane = dst + ch * SH * SW;
    for (int i = threadIdx.x; i < per_plane; i += blockDim.x) {
      const int sy = i / kRowChunks;  // a compile-time divisor
      const int cx = i - sy * kRowChunks;
      float* d = plane + sy * SW + 4 * cx;
      if (ch >= n_live) {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const int gy = min(max(y0 + sy, 0), H - 1);
      const int gx = x0 + 4 * cx;
      const float* s = src + ch * HW + static_cast<size_t>(gy) * W;
      if (vec && gx >= 0 && gx + 3 < W) {
        cp_async_16(d, s + gx);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) d[k] = s[min(max(gx + k, 0), W - 1)];
      }
    }
  }
}

// Chunk kc's q window into `buf` and its u tile into its rows of the
// logits (the messages are added onto u there).
template <int SW>
__device__ __forceinline__ void stage_chunk(float* __restrict__ buf,
                                            float* __restrict__ sl,
                                            const float* __restrict__ q,
                                            const float* __restrict__ u,
                                            int kc, int C, int TY, int SH,
                                            int y0, int x0, int by0, int bx0,
                                            int H, int W, size_t HW,
                                            bool vec) {
  const int c0 = kc * kWideK;
  const int live = min(C - c0, kWideK);
  stage_planes<SW>(buf, q + c0 * HW, kWideK, live, SH, y0, x0, H, W, HW,
                   vec);
  stage_planes<kWideTX>(sl + c0 * kWideTX * TY, u + c0 * HW, live, live, TY,
                        by0, bx0, H, W, HW, vec);
}

// Part 0 of the block: the logits of chunk kc for its strip, its own sums
// (acc) and the other parts' (sums of that chunk's parity) added onto u.
template <int R>
__device__ __forceinline__ void wide_finalize(
    const float (&acc)[kPX][kWideK], float* __restrict__ sl,
    const float* __restrict__ sums, int kc, int C, int P, int spx) {
#pragma unroll
  for (int c = 0; c < kWideK; ++c) {
    const int cls = kc * kWideK + c;
    if (cls < C) {
      float o[kPX] = {acc[0][c], acc[1][c], acc[2][c], acc[3][c]};
#pragma unroll
      for (int j = 1; j < kWideParts<R>; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(
            sums + ((j - 1) * kWideK + c) * P + spx);
        o[0] += t.x; o[1] += t.y; o[2] += t.z; o[3] += t.w;
      }
      float4* slot = reinterpret_cast<float4*>(sl + cls * P + spx);
      const float4 l = *slot;  // u
      *slot = make_float4(l.x + o[0], l.y + o[1], l.z + o[2], l.w + o[3]);
    }
  }
}

// The tile is kWideTX x TY pixels (TY = kWideTY, or kWideSmallTY when the
// grid would have fewer blocks than the card has SMs).  Thread (part,
// strip) holds kPX pixels of one row of the tile and window rows
// [kWideRows part, kWideRows (part + 1)).  Shared memory, floats: the
// logits [classes rounded up to kWideK][P]; the parts' sums, kWideSums<R>
// rows of P (first each part's wsums, then the sums of parts 1.. for two
// chunks, by parity); then kWideStages q chunks [kWideK][SH][SW] in a
// ring, chunk k in slot k % kWideStages (the guide's window [G][SH][SW] in
// the last slot until the coefficients are made); P = kWideTX TY,
// SH = TY + 2R.
template <int R>
__global__ void __launch_bounds__(kWideThreads<R>, kWideMinBlocks<R>)
crf_wide_kernel(const float* __restrict__ q, const float* __restrict__ g,
                const float* __restrict__ u, float* __restrict__ out, int C,
                int G, int H, int W, int TY, const WideTable tab,
                float neg_inv2_col, float w_app, float w_sm, float eps,
                int vec) {
  constexpr int kSide = 2 * R + 1;
  constexpr int kPadW = kWidePad<R>;
  constexpr int SW = kWideSW<R>;
  constexpr int kNV = kPX + 2 * kPadW;     // floats a strip reads per row
  constexpr int kParts = kWideParts<R>;
  constexpr int kTab = kWideMaxR + 1;
  const int P = kWideTX * TY;
  const int SH = TY + 2 * R;
  const int plane = SH * SW;
  const int n_chunks = (C + kWideK - 1) / kWideK;
  extern __shared__ __align__(16) float smem[];
  float* sl = smem;                              // [n_chunks kWideK][P]
  float* sums = sl + n_chunks * kWideK * P;      // [kWideSums<R>][P]
  float* ring = sums + kWideSums<R> * P;         // [kWideStages][kWideK]..
  const int slot_floats = kWideK * plane;

  const int tid = threadIdx.x;
  const int bx0 = blockIdx.x * kWideTX, by0 = blockIdx.y * TY;
  const int y0 = by0 - R, x0 = bx0 - kPadW;
  const size_t HW = static_cast<size_t>(H) * W;
  const bool vecb = vec != 0;
  const int strips = kWideStripsX * TY;   // whole warps
  const int part = tid / strips;
  const int st = tid - part * strips;
  const int sy = st / kWideStripsX, sx = st - sy * kWideStripsX;
  const int spx = sy * kWideTX + kPX * sx;   // the strip's first pixel

  // the guide's window into the last slot, chunks 0 .. kWideStages - 2
  // into the others: they stay in flight while the coefficients are made
  float* gw = ring + (kWideStages - 1) * slot_floats;
  stage_planes<SW>(gw, g, G, G, SH, y0, x0, H, W, HW, vecb);
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < kWideStages - 1; ++k) {
    if (k < n_chunks) {
      stage_chunk<SW>(ring + k * slot_floats, sl, q, u, k, C, TY, SH, y0, x0,
                      by0, bx0, H, W, HW, vecb);
    }
    cp_async_commit();
  }
  cp_async_wait<kWideStages - 1>();
  __syncthreads();

  // each pixel's bilateral weights of this part's window rows, once, in
  // registers: gc the strip's guide, aw the weights
  float gc[kMaxG][kPX];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    if (j < G) {
      const float4 t = *reinterpret_cast<const float4*>(
          gw + j * plane + (sy + R) * SW + kPadW + kPX * sx);
      gc[j][0] = t.x; gc[j][1] = t.y; gc[j][2] = t.z; gc[j][3] = t.w;
    }
  }
  float aw[kWideRows][kPX][kSide];
  float wsum[kPX] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r2 = 0; r2 < kWideRows; ++r2) {
    const int wy = kWideRows * part + r2;
    const int ady = wy < R ? R - wy : wy - R;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
#pragma unroll
      for (int k = 0; k < kSide; ++k) aw[r2][p][k] = 0.f;
    }
    if (wy < kSide) {  // the last part of an odd window has one row
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        if (j < G) {
          float v[kNV];
          const float* row = gw + j * plane + (sy + wy) * SW + kPX * sx;
#pragma unroll
          for (int i = 0; i < kNV / 4; ++i) {
            const float4 t = *reinterpret_cast<const float4*>(row + 4 * i);
            v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z;
            v[4 * i + 3] = t.w;
          }
#pragma unroll
          for (int p = 0; p < kPX; ++p) {
#pragma unroll
            for (int k = 0; k < kSide; ++k) {
              const float d = gc[j][p] - v[kPadW + p + k - R];
              aw[r2][p][k] += d * d;
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
#pragma unroll
        for (int k = 0; k < kSide; ++k) {
          const int adx = k < R ? R - k : k - R;
          aw[r2][p][k] = tab.app[ady * kTab + adx] *
                         expf(aw[r2][p][k] * neg_inv2_col);
          wsum[p] += aw[r2][p][k];
        }
      }
    }
  }
  *reinterpret_cast<float4*>(sums + part * P + spx) =
      make_float4(wsum[0], wsum[1], wsum[2], wsum[3]);
  __syncthreads();  // the wsums are in

  // coefficient of q(x + d) in the logit: w_app a / (wsum + eps) + w_sm s
  {
    float den[kPX] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kParts; ++k) {  // the parts' wsums, in row order
      const float4 t = *reinterpret_cast<const float4*>(sums + k * P + spx);
      den[0] += t.x; den[1] += t.y; den[2] += t.z; den[3] += t.w;
    }
#pragma unroll
    for (int p = 0; p < kPX; ++p) den[p] = w_app / (den[p] + eps);
#pragma unroll
    for (int r2 = 0; r2 < kWideRows; ++r2) {
      const int wy = kWideRows * part + r2;
      const int ady = wy < R ? R - wy : wy - R;
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
#pragma unroll
        for (int k = 0; k < kSide; ++k) {
          const int adx = k < R ? R - k : k - R;
          aw[r2][p][k] = aw[r2][p][k] * den[p] +
                         w_sm * tab.sm[ady * kTab + adx];
        }
      }
    }
  }

  // the messages: one FMA per pixel, offset and class
  float acc[kPX][kWideK];
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<kWideStages - 2>();  // chunk k has landed
    // every thread is past chunk k - 1 (its slot is free) and past the
    // wsums; the other parts' sums of chunk k - 1 are in
    __syncthreads();
    const int next = k + kWideStages - 1;
    if (next < n_chunks) {
      stage_chunk<SW>(ring + (next % kWideStages) * slot_floats, sl, q, u,
                      next, C, TY, SH, y0, x0, by0, bx0, H, W, HW, vecb);
    }
    cp_async_commit();
    if (part == 0 && k > 0) {
      wide_finalize<R>(acc, sl, sums + ((k - 1) & 1) * (kParts - 1) *
                                          kWideK * P,
                       k - 1, C, P, spx);
    }
    const float* cur = ring + (k % kWideStages) * slot_floats;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
#pragma unroll
      for (int c = 0; c < kWideK; ++c) acc[p][c] = 0.f;
    }
#pragma unroll
    for (int r2 = 0; r2 < kWideRows; ++r2) {
      const int wy = kWideRows * part + r2;
      if (wy < kSide) {
        const float* row = cur + (sy + wy) * SW + kPX * sx;
#pragma unroll
        for (int c = 0; c < kWideK; ++c) {
          float v[kNV];
#pragma unroll
          for (int i = 0; i < kNV / 4; ++i) {
            const float4 t = *reinterpret_cast<const float4*>(
                row + c * plane + 4 * i);
            v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z;
            v[4 * i + 3] = t.w;
          }
#pragma unroll
          for (int p = 0; p < kPX; ++p) {
#pragma unroll
            for (int k2 = 0; k2 < kSide; ++k2) {
              acc[p][c] += aw[r2][p][k2] * v[kPadW + p + k2 - R];
            }
          }
        }
      }
    }
    if (part > 0) {  // this part's sums, for part 0
      float* mine = sums + ((k & 1) * (kParts - 1) + part - 1) * kWideK * P;
#pragma unroll
      for (int c = 0; c < kWideK; ++c) {
        *reinterpret_cast<float4*>(mine + c * P + spx) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
      }
    }
  }
  __syncthreads();
  if (part == 0) {
    wide_finalize<R>(acc, sl, sums + ((n_chunks - 1) & 1) * (kParts - 1) *
                                         kWideK * P,
                     n_chunks - 1, C, P, spx);
  }
  __syncthreads();

  // softmax over the classes, a pixel per thread; each class's row of the
  // tile goes out as one coalesced store per warp
  for (int px = tid; px < P; px += blockDim.x) {
    float mx = -INFINITY;
    for (int c = 0; c < C; ++c) mx = fmaxf(mx, sl[c * P + px]);
    float total = 0.f;
    for (int c = 0; c < C; ++c) {
      const float e = expf(sl[c * P + px] - mx);
      sl[c * P + px] = e;
      total += e;
    }
    const int py = by0 + px / kWideTX, pxx = bx0 + px % kWideTX;
    if (py < H && pxx < W) {
      float* o = out + static_cast<size_t>(py) * W + pxx;
      for (int c = 0; c < C; ++c) o[c * HW] = sl[c * P + px] / total;
    }
  }
}

// Bytes of shared memory crf_wide_kernel takes at C classes, radius r and
// ty tile rows.
constexpr size_t wide_smem_bytes(int C, int r, int ty) {
  return sizeof(float) *
         (static_cast<size_t>(
              (C + kWideK - 1) / kWideK * kWideK +
              ((2 * r + 2) / kWideRows > 1
                   ? 2 * ((2 * r + 2) / kWideRows - 1) * kWideK
                   : 1)) *
              kWideTX * ty +
          static_cast<size_t>(kWideStages * kWideK) * (ty + 2 * r) *
              (kWideTX + 2 * ((r + 3) / 4 * 4)));
}
static_assert(wide_smem_bytes(kMaxC, kWideMaxR, kWideTY) <= 232448,
              "the largest sizes must fit a block's shared memory");

// Whether radius r is one crf_wide_kernel is built for (its coefficients
// fit a thread's registers); past it the simple forms run: the simple wide
// kernel above kGenericC classes, the generic kernel within.
bool wide_fits(int r) { return r <= kWideMaxR; }

// Whether a size of at most kGenericC classes at radius r runs on
// crf_wide_kernel (at r = 0 the generic kernel is the faster).
bool narrow_fits(int r) { return r >= 1 && wide_fits(r); }

template <int R>
int launch_wide(const Args& a, int C, int G) {
  const auto tab = spatial_table<kWideMaxR + 1, WideTable>(a);
  static int n_sm = 0;  // the card's SMs, read once
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int cols = (a.W + kWideTX - 1) / kWideTX;
  const int ty = cols * ((a.H + kWideTY - 1) / kWideTY) < n_sm
                     ? kWideSmallTY : kWideTY;
  const size_t smem = wide_smem_bytes(C, R, ty);
  cudaError_t e = cudaFuncSetAttribute(
      crf_wide_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) {  // the most shared memory: two blocks an SM fit
    e = cudaFuncSetAttribute(crf_wide_kernel<R>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(cols, (a.H + ty - 1) / ty);
  crf_wide_kernel<R><<<grid, kWideStripsX * ty * kWideParts<R>, smem,
                       a.stream>>>(
      a.q, a.g, a.u, a.out, C, G, a.H, a.W, ty, tab, -a.inv2_col, a.w_app,
      a.w_sm, a.eps, rows_vectorize(a));
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

extern "C" int crf_iteration_max_classes() { return kMaxC; }

// 1 if C > kGenericC classes at radius r run on crf_wide_kernel, 0 if on
// the simple wide kernel (no room for the weights and logits).
extern "C" int crf_iteration_wide_fits(int C, int r) {
  return C > kGenericC && wide_fits(r) ? 1 : 0;
}

// 1 if (C, G, r) is a narrow size: at most kGenericC classes, no tiled
// instantiation, narrow_fits(r) (crf_wide_kernel runs it).
extern "C" int crf_iteration_is_narrow(int C, int G, int r) {
  return C <= kGenericC && !crf_iteration_is_tiled(C, G, r) && narrow_fits(r)
             ? 1 : 0;
}

// C entry for ctypes.  Returns a cudaError_t: the launch's own error (a
// refused configuration never runs, and a later synchronize would not
// report it), or cudaErrorInvalidValue for sizes outside the bounds above.
// A size with a tiled instantiation runs on it; every other size runs on
// crf_wide_kernel where wide_fits (more than kGenericC classes) or
// narrow_fits (the narrow sizes) says so, else on the simple forms.
// generic != 0 takes the simple form whatever the sizes (the generic
// kernel, or the simple wide kernel above kGenericC classes), to time one
// against the other.
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
    switch ((C > kGenericC ? wide_fits(r) : narrow_fits(r)) ? r : -1) {
      case 0: return launch_wide<0>(a, C, G);
      case 1: return launch_wide<1>(a, C, G);
      case 2: return launch_wide<2>(a, C, G);
      case 3: return launch_wide<3>(a, C, G);
      case 4: return launch_wide<4>(a, C, G);
      case 5: return launch_wide<5>(a, C, G);
      default: break;  // the simple forms
    }
  }
  return C > kGenericC ? launch_wide_simple(a, C, G, r)
                       : launch_generic(a, C, G, r);
}
