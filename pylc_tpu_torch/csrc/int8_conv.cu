// int8 post-training quantization on Hopper (sm_90a): two kernels.
//
// Replaces no Pallas kernel.  The JAX package's int8 inference path
// (pylc_tpu/quant.py::_quantized_conv) quantizes each calibrated
// convolution's input and computes the convolution with XLA's
// lax.conv_general_dilated(..., preferred_element_type=int32) (quant.py:133);
// PyTorch has no int8 x int8 -> int32 convolution (F.conv2d on int8 returns
// int8, torch._int_mm has no window and no groups), so the port computes it
// here by hand.
//
// Q, quantize_int8: a channels_last f32 or bf16 activation (NHWC in memory)
//   -> int8 NHWC,  q = clamp(round_half_even(float(x) * inv_s), -127, 127).
//   inv_s = 1.0f / float(s_x), made once on the host in float32: XLA on the
//   CPU rewrites the JAX package's division by the constant s_x into this
//   multiplication (checked against JAX 0.9 on the CPU at ties), and
//   __fmul_rn keeps the product unfused.  Bound by bytes: 4 (or 2) bytes
//   read and 1 written per element, 1 multiply.  Four elements a thread,
//   one 16-byte (8-byte for bf16) load and one 4-byte store where the
//   tensor allows.
//
// KQ, int8_conv2d: y[b, oy, ox, o] = epilogue(sum over (ky, kx, c) of
//   x[b, oy*sh - ph + ky*dh, ox*sw - pw + kx*dw, g*Cg + c] * w[o, ky, kx, c])
//   with zero padding, int8 NHWC x and int8 w packed [O, kh, kw, I/groups],
//   an int32 accumulator (exact: |sum| <= 127^2 * K < 2^31 for K < 133,000),
//   and the fused epilogue
//     y = float(acc) * (w_scale[o] * s_x)  [+ bias[o]]  -> f32 or bf16,
//   each operation rounded on its own (__fmul_rn, __fadd_rn: no FMA), in
//   the JAX package's order, so that the result is bit-equal to the plain
//   torch version.  Output channels_last (NHWC in memory).
//
// What bounds KQ on an H100.  The flagship (DeepLabV3+/ResNet101, OS16,
// 512 px tiles) does 88.6 G multiply-adds per tile in 114 convolutions:
// 1.42 T per batch of 16 tiles, 1.43 ms at the 1,979 TOPS of the int8
// tensor cores, while its int8 activations and weights are ~1 GB per
// batch (0.3 ms at 3.35 TB/s): the operations bind.  This first form does
// not reach the tensor cores: it runs __dp4a (four int8 products and their
// sum into an int32, one instruction) on the CUDA cores, whose peak is
// about 64 x 4 x 132 multiply-adds per clock, ~60 T/s at 1.75 GHz,
// ~24 ms per batch of 16 tiles.  The redesign on mma.sync / wgmma .s8 with
// Q fused into its loads is queued (ROADMAP).
//
// Three forms, chosen by conv2d below:
//   - tiled<aligned> (groups == 1, I % 4 == 0): a 64-pixel x 64-channel
//     output tile per block of 256 threads, each thread a 4 x 4 register
//     tile.  The reduction over K = kh*kw*I runs in chunks of 32 bytes
//     staged through shared memory as int32 words (4 int8 of one tap's
//     consecutive channels each, one 4-byte load), k-major so that a
//     thread reads its 4 pixels' and 4 channels' words with two 16-byte
//     shared loads and issues 16 dp4a per word pair.
//   - tiled<bytes> (groups == 1, I % 4 != 0: the stem's 3 channels): the
//     same tile; each staged word is packed from 4 single-byte loads,
//     each with its own tap, so that no word straddles a tap unseen.
//   - grouped (groups > 1: Xception's and MobileNetV2's depthwise 3x3):
//     one output per thread, output channels fastest so that neighbouring
//     threads read neighbouring bytes, a scalar int32 multiply-add per
//     product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;          // output pixels per block
constexpr int kBN = 64;          // output channels per block
constexpr int kWords = 8;        // int32 words of K per chunk: 32 bytes
constexpr int kPad = 4;          // words of padding per staged row
constexpr int kQuantThreads = 256;

struct Geom {
  int B, H, W, C, O, kh, kw, sh, sw, ph, pw, dh, dw, groups, Ho, Wo;
};

template <typename Out>
__device__ __forceinline__ Out to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The epilogue: float(acc) * (w_scale[o] * s_x), then + bias[o].
template <typename Out>
__device__ __forceinline__ Out epilogue(int acc, int o,
                                        const float* __restrict__ w_scale,
                                        const float* __restrict__ bias,
                                        float s_x) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(w_scale[o], s_x));
  if (bias != nullptr) v = __fadd_rn(v, bias[o]);
  return to_out<Out>(v);
}

// Word k/4 of pixel (b, iy0, ix0)'s patch: 4 int8 of K = kh*kw*C packed
// little-endian (byte e is K index k + e), zero outside the image or K.
template <bool kAligned>
__device__ __forceinline__ int patch_word(const int8_t* __restrict__ x,
                                          const Geom& g, int b, int iy0,
                                          int ix0, int k, int K) {
  if (kAligned) {  // C % 4 == 0: the 4 bytes are one tap's channels
    if (k >= K) return 0;
    const int tap = k / g.C;
    const int c = k - tap * g.C;
    const int ky = tap / g.kw;
    const int iy = iy0 + ky * g.dh;
    const int ix = ix0 + (tap - ky * g.kw) * g.dw;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return 0;
    return *reinterpret_cast<const int*>(
        x + ((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.C + c);
  }
  unsigned word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kk = k + e;
    if (kk >= K) break;
    const int tap = kk / g.C;
    const int c = kk - tap * g.C;
    const int ky = tap / g.kw;
    const int iy = iy0 + ky * g.dh;
    const int ix = ix0 + (tap - ky * g.kw) * g.dw;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
    const unsigned byte = static_cast<uint8_t>(
        x[((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.C + c]);
    word |= byte << (8 * e);
  }
  return static_cast<int>(word);
}

// Word k/4 of output channel n's weights [kh, kw, C], zero past K.
template <bool kAligned>
__device__ __forceinline__ int weight_word(const int8_t* __restrict__ w,
                                           int n, int k, int K) {
  const int8_t* row = w + static_cast<long long>(n) * K;
  if (kAligned) return k < K ? *reinterpret_cast<const int*>(row + k) : 0;
  unsigned word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (k + e < K) word |= static_cast<unsigned>(
        static_cast<uint8_t>(row[k + e])) << (8 * e);
  }
  return static_cast<int>(word);
}

template <typename Out, bool kAligned>
__global__ void __launch_bounds__(kThreads)
int8_conv_tiled_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, float s_x,
                       Out* __restrict__ y, Geom g) {
  __shared__ __align__(16) int As[kWords][kBM + kPad];
  __shared__ __align__(16) int Bs[kWords][kBN + kPad];
  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const int K = g.kh * g.kw * g.C;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // staging: this thread fills word lw of rows lr and lr + 32 of both tiles
  const int lw = tid % kWords;
  const int lr = tid / kWords;
  int pb[2], piy[2], pix[2];
  bool pok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + lr + 32 * i;
    pok[i] = m < M;
    const long long mm = pok[i] ? m : 0;
    const int ox = static_cast<int>(mm % g.Wo);
    const long long t = mm / g.Wo;
    const int oy = static_cast<int>(t % g.Ho);
    pb[i] = static_cast<int>(t / g.Ho);
    piy[i] = oy * g.sh - g.ph;
    pix[i] = ox * g.sw - g.pw;
  }

  // compute: this thread's 4 pixels ty*4.. and 4 channels tx*4..
  const int ty = tid / 16;
  const int tx = tid % 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * kWords) {
    const int k = k0 + 4 * lw;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 32 * i;
      As[lw][r] = pok[i] ? patch_word<kAligned>(x, g, pb[i], piy[i], pix[i],
                                                k, K)
                         : 0;
      const int n = n0 + r;
      Bs[lw][r] = n < g.O ? weight_word<kAligned>(w, n, k, K) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk) {
      const int4 av = *reinterpret_cast<const int4*>(&As[kk][ty * 4]);
      const int4 bv = *reinterpret_cast<const int4*>(&Bs[kk][tx * 4]);
      const int a[4] = {av.x, av.y, av.z, av.w};
      const int b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.O) {
        y[m * g.O + n] = epilogue<Out>(acc[i][j], n, w_scale, bias, s_x);
      }
    }
  }
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
int8_conv_grouped_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ w_scale,
                         const float* __restrict__ bias, float s_x,
                         Out* __restrict__ y, Geom g) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  if (idx >= M * g.O) return;
  const int o = static_cast<int>(idx % g.O);
  const long long m = idx / g.O;
  const int ox = static_cast<int>(m % g.Wo);
  const long long t = m / g.Wo;
  const int oy = static_cast<int>(t % g.Ho);
  const int b = static_cast<int>(t / g.Ho);
  const int Cg = g.C / g.groups;
  const int grp = o / (g.O / g.groups);
  const int8_t* wo = w + static_cast<long long>(o) * g.kh * g.kw * Cg;
  int acc = 0;
  for (int ky = 0; ky < g.kh; ++ky) {
    const int iy = oy * g.sh - g.ph + ky * g.dh;
    if (iy < 0 || iy >= g.H) continue;
    for (int kx = 0; kx < g.kw; ++kx) {
      const int ix = ox * g.sw - g.pw + kx * g.dw;
      if (ix < 0 || ix >= g.W) continue;
      const int8_t* xp =
          x + ((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.C +
          static_cast<long long>(grp) * Cg;
      const int8_t* wp = wo + (ky * g.kw + kx) * Cg;
      for (int c = 0; c < Cg; ++c) {
        acc += static_cast<int>(xp[c]) * static_cast<int>(wp[c]);
      }
    }
  }
  y[idx] = epilogue<Out>(acc, o, w_scale, bias, s_x);
}

__device__ __forceinline__ int quantize_one(float v, float inv_s) {
  const int q = __float2int_rn(__fmul_rn(v, inv_s));
  return min(max(q, -127), 127);
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Four elements from 4 * i on: one vector load where `vec`, else scalars.
template <typename In>
__global__ void __launch_bounds__(kQuantThreads)
quantize_int8_kernel(const In* __restrict__ x, int8_t* __restrict__ q,
                     long long n, float inv_s, bool vec) {
  const long long base =
      4 * (static_cast<long long>(blockIdx.x) * kQuantThreads + threadIdx.x);
  if (base >= n) return;
  if (vec && base + 4 <= n) {
    float v[4];
    if constexpr (sizeof(In) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(x + base);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(x + base);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      v[0] = __low2float(lo); v[1] = __high2float(lo);
      v[2] = __low2float(hi); v[3] = __high2float(hi);
    }
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      word |= static_cast<unsigned>(static_cast<uint8_t>(
                  static_cast<int8_t>(quantize_one(v[e], inv_s))))
              << (8 * e);
    }
    *reinterpret_cast<unsigned*>(q + base) = word;
    return;
  }
  for (long long i = base; i < n && i < base + 4; ++i) {
    q[i] = static_cast<int8_t>(quantize_one(load_f(x + i), inv_s));
  }
}

template <typename Out>
int launch_conv(const int8_t* x, const int8_t* w, const float* w_scale,
                const float* bias, float s_x, void* y, const Geom& g,
                bool aligned, cudaStream_t stream) {
  Out* out = static_cast<Out*>(y);
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  if (g.groups == 1) {
    const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                    static_cast<unsigned>((g.O + kBN - 1) / kBN));
    if (aligned) {
      int8_conv_tiled_kernel<Out, true><<<grid, kThreads, 0, stream>>>(
          x, w, w_scale, bias, s_x, out, g);
    } else {
      int8_conv_tiled_kernel<Out, false><<<grid, kThreads, 0, stream>>>(
          x, w, w_scale, bias, s_x, out, g);
    }
  } else {
    const long long total = M * g.O;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    int8_conv_grouped_kernel<Out><<<blocks, kThreads, 0, stream>>>(
        x, w, w_scale, bias, s_x, out, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which form conv2d runs: 0 tiled<aligned>, 1 tiled<bytes>, 2 grouped.
// aligned needs I % 4 == 0 and both int8 operands on 4-byte boundaries.
extern "C" int int8_conv2d_form(int C, int groups, int ptrs_aligned) {
  if (groups > 1) return 2;
  return (C % 4 == 0 && ptrs_aligned) ? 0 : 1;
}

// C entries for ctypes.  Each returns a cudaError_t: the launch's own error
// (a refused configuration never runs, and a later synchronize would not
// report it), or cudaErrorInvalidValue for arguments outside the bounds.
extern "C" int int8_conv2d(const void* x, const void* w, const void* w_scale,
                           const void* bias, float s_x, void* y, int out_bf16,
                           int B, int H, int W, int C, int O, int kh, int kw,
                           int sh, int sw, int ph, int pw, int dh, int dw,
                           int groups, int Ho, int Wo, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || O < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || ph < 0 || pw < 0 || dh < 1 || dw < 1 ||
      groups < 1 || C % groups != 0 || O % groups != 0 || Ho < 1 ||
      Wo < 1 || static_cast<long long>(kh) * kw * (C / groups) > 133000) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g{B, H, W, C, O, kh, kw, sh, sw, ph, pw, dh, dw, groups, Ho, Wo};
  const bool aligned =
      int8_conv2d_form(C, groups,
                       (reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 4 == 0)) == 0;
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* bs = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_conv<__nv_bfloat16>(xq, wq, ws, bs, s_x, y, g,
                                               aligned, st)
                  : launch_conv<float>(xq, wq, ws, bs, s_x, y, g, aligned,
                                       st);
}

extern "C" int quantize_int8(const void* x, int x_bf16, void* q, long long n,
                             float inv_s, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = (n + 3) / 4;
  const unsigned blocks =
      static_cast<unsigned>((threads + kQuantThreads - 1) / kQuantThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (x_bf16 ? 8 : 16) == 0;
  auto* out = static_cast<int8_t*>(q);
  if (x_bf16) {
    quantize_int8_kernel<__nv_bfloat16><<<blocks, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), out, n, inv_s, vec);
  } else {
    quantize_int8_kernel<float><<<blocks, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), out, n, inv_s, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
