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
// p_y = eps, as in the Pallas kernel.  Class weights are indexed only by a
// target that matched a class in [0, C).
//
// K2a, per pixel (one thread each): softmax over C in registers, then
//   inter_c += p_c [y == c],  sump_c += p_c,  cnt_c += [y == c],
//   nll_sum += w_y * -log p_y,  wsum += w_y,
//   focal_sum += -alpha (1 - p_y - eps)^gamma log(p_y + eps),  count += 1.
// A thread adds the 3C + 4 terms of its pixels (one per span of 256, a
// fixed number of spans per block) into registers; the block reduces them
// once (one shuffle tree per warp for all the values, then the block's
// warps through shared memory, in a fixed order) into one row of
// partials[3C + 4][n_blocks]; a second kernel of one block sums the rows
// in double, in a fixed order.  No atomics on values, and the order of
// every sum depends on N and C only: the loss is the same from run to run
// and from card to card.  The losses themselves (_losses_from_acc) are
// computed from the reduced vector by the caller.
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
// The train step's logits are channels_last, so a pixel's C classes are C
// consecutive floats and thread n's accesses of x[n C + c] touch a 32-byte
// sector for 4 bytes of it, C times over.  For K2a, which only reads, L1
// merges a warp's sector-sized reads, and one kernel serves every layout.
// K2b also writes, and its writes reach L2 as partial sectors, so it has two
// kernels.  The staged one copies a block's contiguous span of 256 pixels x
// C floats into shared memory with 16-byte cp.async chunks; each thread
// takes its pixel's C values from there (stride C words: C is odd, so the
// 32 lanes hit 32 banks) and writes its dlogits back, and device memory
// sees only full sectors, each once.  fused_loss_backward_variant() says
// which tensors it takes: dense channels_last, C = 9 or 11 (both schemas;
// compile-time, so the class loops unroll with no predicated slots),
// 16-byte aligned.  Every other accepted layout (contiguous NCHW, where a
// warp's accesses are coalesced as they are; an even or other class count;
// unaligned pointers) takes K2b's direct kernel.  The direct kernels of K2a
// and K2b have one thread per pixel at the logits' strides, the image in
// the grid's y index, so no thread divides by H*W, and a compile-time C for
// 9 and 11.
//
// K2a's design:
//   - fused_loss_forward_direct_kernel<C>: a block walks kFwdSpans = 16
//     consecutive chunks of 256 pixels of one image, read at the logits'
//     strides.  The threads keep their 3C + 4 partial sums in registers
//     across the chunks and reduce them once per block, not once per 256
//     pixels: at [8, 9, 512, 512] 512 rows of partials instead of 8,192.
//   - the block's reduction (block_sum_slots): a warp sums its first 32
//     values with one halving butterfly of 31 shuffles that leaves value s
//     in lane s (5 shuffles each for the few beyond 32), instead of 5
//     shuffles for every value.
//   - arithmetic (forward_pixel): p = e * (1 / sum); the target's logit
//     from registers; log p_y = (x_y - max) - log(sum); (1 - q)^gamma is
//     (1 - q)^2 at gamma = 2 and one powf otherwise.  No intrinsic and no
//     fast math.
//   - the final sum is a second kernel of one block
//     (fused_loss_reduce_kernel), in double, in a fixed order.
//   Measured at [8, 9, 512, 512] channels_last on an H100 80GB HBM3 at
//   700 W (chip_smoke.py's [k2] phase, 50 launches back to back, so what of
//   the 75.5 MB of logits fits the 50 MB L2 is read from there): the whole
//   forward 0.036 ms replayed from a CUDA graph (65% of the bound), 0.038
//   ms from a loop on the host (60%); 64 registers, 1,028 B of shared
//   memory, no spills (C = 11: 74 registers; run-time C: 106).  The form
//   this file had before (a block per 256 pixels, run-time C, a division
//   per thread, 52 five-shuffle reductions per block) took 0.135 ms
//   (pylc_tpu_torch/tools/time_kernels.py, the two checkouts in turns).
//   What holds K2a at 65%: about 260 instructions per pixel (nine accurate
//   expf, two logf, a division, 3C accumulations) are 17 us of issue at
//   one instruction per scheduler and clock, beside 23 us of memory, and
//   the two do not overlap fully.
//   Tried on the same card and not kept: a staged forward kernel (spans
//   through two shared-memory buffers, the cp.async of span k + 1 in flight
//   during the arithmetic of span k; 64 registers, 19,460 B of shared
//   memory, 4 resident blocks) took 0.037 ms from a graph and 0.040-0.041
//   from a host loop, 0.002 ms more than this kernel on the same tensor in
//   turns: staging buys a read what L1 gives it anyway.  The final sum by
//   the last block to finish (a ticket counter behind __threadfence) took
//   0.042 ms against the second kernel's 0.040: its 4-byte memset and
//   fence cost more than the second launch (2.1 us).  8, 4 and 32 chunks
//   per block took 0.041, 0.045 and 0.046 ms against 16's 0.040 (these on
//   the staged form, host loops).
//
// K2b's design:
//   - fused_loss_backward_staged_kernel<C>: a block stages one span, each
//     thread writes its dlogits back into its pixel's slots, and the block
//     stores the span with 16-byte coalesced writes.  Blocks are not
//     persistent: six resident blocks per SM in different phases overlap
//     one's loads with another's arithmetic.
//   - fused_loss_backward_direct_kernel<C>: one thread per pixel.
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
constexpr int kThreads = 256;             // pixels per span
constexpr int kWarps = kThreads / 32;
constexpr int kFwdSpans = 16;             // chunks of kThreads pixels a K2a
                                          // block walks
constexpr int kFwdPixels = kThreads * kFwdSpans;  // pixels per K2a block
constexpr int kReduceThreads = 1024;      // the one block of the final sum

struct Layout {
  long long HW;  // pixels per image
  long long sB;  // batch stride (elements)
  long long sC;  // class stride
  long long sP;  // stride of the merged (H, W) pixel index
};

// Registers a thread keeps per class: CT > 0 is a compile-time class
// count; CT == 0 takes C <= kMaxC at run time, with the class loops
// unrolled to kMaxC under a test.
template <int CT>
constexpr int kClassSlots = CT > 0 ? CT : kMaxC;

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

// v[] holds a pixel's logits on entry and exp(logit - max) on return;
// returns their sum, and the max through mx.
template <int CT>
__device__ __forceinline__ float softmax_exp(float (&v)[kClassSlots<CT>],
                                             int C, float& mx) {
  mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < kClassSlots<CT>; ++c) {
    if (CT > 0 || c < C) mx = fmaxf(mx, v[c]);
  }
  float se = 0.f;
#pragma unroll
  for (int c = 0; c < kClassSlots<CT>; ++c) {
    if (CT > 0 || c < C) {
      v[c] = expf(v[c] - mx);
      se += v[c];
    }
  }
  return se;
}

// ------------------------------------------------------------------- //
// K2a
// ------------------------------------------------------------------- //

struct FwdParams {
  int weighted;
  float alpha, gamma, eps;
};

// A thread's partial sums live in slots: [c] inter, [S + c] sump,
// [2 S + c] cnt with S = kClassSlots<CT>, then nll_sum, wsum, focal_sum,
// count.  With a compile-time C the slots are the 3C + 4 statistics in
// order.
template <int CT>
constexpr int kFwdSlots = 3 * kClassSlots<CT> + 4;

// Where slot s goes in the statistics vector; -1: a class slot beyond C.
template <int CT>
__device__ __forceinline__ int slot_index(int s, int C) {
  if (CT > 0) return s;
  const int group = s / kMaxC, c = s % kMaxC;
  if (group == 3) return 3 * C + c;
  return c < C ? group * C + c : -1;
}

// One pixel: v[] holds its logits, y its target (-1: a target outside
// [0, C) has no class) and xy the target's logit; its terms are added to
// acc[].  cw_s holds the C class weights (ones when unweighted).
template <int CT>
__device__ __forceinline__ void forward_pixel(
    float (&v)[kClassSlots<CT>], int C, int y, float xy,
    const float* __restrict__ cw_s, const FwdParams& P,
    float (&acc)[kFwdSlots<CT>]) {
  constexpr int S = kClassSlots<CT>;
  float mx;
  const float se = softmax_exp<CT>(v, C, mx);
  const float inv_se = 1.f / se;
  float py = 0.f;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    if (CT > 0 || c < C) {
      const float p = v[c] * inv_se;
      acc[S + c] += p;
      if (c == y) {
        py = p;
        acc[c] += p;
        acc[2 * S + c] += 1.f;
      }
    }
  }
  const float wy = y >= 0 ? cw_s[y] : (P.weighted ? 0.f : 1.f);
  const float nll = y >= 0 ? -((xy - mx) - logf(se)) : 0.f;
  const float q = py + P.eps;
  const float b = 1.f - q;
  const float pw = P.gamma == 2.f ? b * b : powf(b, P.gamma);
  acc[3 * S + 0] += nll * wy;
  acc[3 * S + 1] += wy;
  acc[3 * S + 2] += -P.alpha * pw * logf(q);
  acc[3 * S + 3] += 1.f;
}

// One step of the halving butterfly over w[0 .. 2 O): the lanes whose bit O
// is set keep the upper O values, the others the lower, and each adds its
// partner's copy of what it keeps.
template <int O>
__device__ __forceinline__ void halve(float (&w)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float keep = upper ? w[i + O] : w[i];
    const float send = upper ? w[i] : w[i + O];
    w[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sums every slot of vals[] over the block's threads, in an order that
// depends on nothing but the thread index: thread s < V returns slot s's
// sum (the others return 0).  rows is shared memory, [kWarps][V].
template <int V>
__device__ __forceinline__ float block_sum_slots(const float (&vals)[V],
                                                 float (*rows)[V]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float w[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = i < V ? vals[i] : 0.f;
  halve<16>(w, lane);
  halve<8>(w, lane);
  halve<4>(w, lane);
  halve<2>(w, lane);
  halve<1>(w, lane);  // lane s now holds slot s over the warp
  if (lane < V) rows[warp][lane] = w[0];
#pragma unroll
  for (int s = 32; s < V; ++s) {
    const float sum = warp_sum(vals[s]);
    if (lane == 0) rows[warp][s] = sum;
  }
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < V) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += rows[k][threadIdx.x];
  }
  return total;
}

// K2a, any accepted layout: one thread per pixel at the logits' strides;
// blockIdx.y is the image, and block (bx, by) takes its pixels
// [bx kFwdPixels, (bx + 1) kFwdPixels).
template <int CT>
__global__ void __launch_bounds__(kThreads)
fused_loss_forward_direct_kernel(const float* __restrict__ x,
                                 const uint8_t* __restrict__ t,
                                 const float* __restrict__ cw,
                                 float* __restrict__ partials, int C,
                                 Layout L, FwdParams P) {
  constexpr int S = kClassSlots<CT>;
  __shared__ float rows[kWarps][kFwdSlots<CT>];
  __shared__ float cw_s[S];
  if (threadIdx.x < C) cw_s[threadIdx.x] = P.weighted ? cw[threadIdx.x] : 1.f;
  __syncthreads();

  float acc[kFwdSlots<CT>];
#pragma unroll
  for (int s = 0; s < kFwdSlots<CT>; ++s) acc[s] = 0.f;

  const long long b = blockIdx.y;
  const long long hw0 = static_cast<long long>(blockIdx.x) * kFwdPixels +
                        threadIdx.x;
  for (int k = 0; k < kFwdSpans; ++k) {
    const long long hw = hw0 + static_cast<long long>(k) * kThreads;
    if (hw < L.HW) {
      const long long base = b * L.sB + hw * L.sP;
      const int target = t[b * L.HW + hw];
      float v[S];
#pragma unroll
      for (int c = 0; c < S; ++c) {
        if (CT > 0 || c < C) v[c] = x[base + c * L.sC];
      }
      int y = -1;
      float xy = 0.f;
#pragma unroll
      for (int c = 0; c < S; ++c) {
        if ((CT > 0 || c < C) && c == target) {
          y = c;
          xy = v[c];
        }
      }
      forward_pixel<CT>(v, C, y, xy, cw_s, P, acc);
    }
  }
  // the block's row of partials[3C + 4][n_rows]
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_rows = gridDim.x * gridDim.y;
  const float total = block_sum_slots<kFwdSlots<CT>>(acc, rows);
  if (threadIdx.x < kFwdSlots<CT>) {
    const int v = slot_index<CT>(threadIdx.x, C);
    if (v >= 0) partials[static_cast<long long>(v) * n_rows + row] = total;
  }
}

// K2a's second kernel: one block sums the rows of partials[V][n_rows] in
// double, warp w taking values w, w + 32, ..., its lanes the rows lane,
// lane + 32, ...
__global__ void __launch_bounds__(kReduceThreads)
fused_loss_reduce_kernel(const float* __restrict__ partials,
                         float* __restrict__ out, int n_rows, int V) {
  const int lane = threadIdx.x & 31;
  for (int v = threadIdx.x >> 5; v < V; v += kReduceThreads / 32) {
    const float* row = partials + static_cast<long long>(v) * n_rows;
    double s = 0.0;
#pragma unroll 8
    for (int r = lane; r < n_rows; r += 32) s += static_cast<double>(row[r]);
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
template <int CT>
__device__ __forceinline__ void backward_pixel(
    float (&v)[kClassSlots<CT>], int C, int target, const BwdStats& s,
    const BwdParams& P) {
  constexpr int kN = kClassSlots<CT>;
  float mx;
  const float se = softmax_exp<CT>(v, C, mx);
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
  constexpr int kN = kClassSlots<CT>;
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

// Sizes both kernels take; the image index rides in the grid's y.
bool layout_ok(int C, long long N, long long HW) {
  return C >= 1 && C <= kMaxC && N >= 1 && HW >= 1 && N % HW == 0 &&
         N / HW <= 65535;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Class counts with compile-time instantiations (both schemas').
bool known_classes(int C) { return C == 9 || C == 11; }

}  // namespace

// C entries for ctypes.  Each launch entry returns a cudaError_t: the
// launch's own error (a refused configuration never runs, and a later
// synchronize would not report it), or cudaErrorInvalidValue for sizes
// outside the bounds above.

// Rows of partials K2a's first kernel writes: one per block, a function of
// the shape only (a block does not cross images).
extern "C" long long fused_loss_partial_rows(long long N, long long HW) {
  return (N / HW) * ceil_div(HW, kFwdPixels);
}

// Floats of workspace K2a needs for B = N / HW images of HW pixels and C
// classes: the rows of partials.
extern "C" long long fused_loss_workspace(long long N, long long HW, int C) {
  return fused_loss_partial_rows(N, HW) * (3LL * C + 4);
}

extern "C" int fused_loss_max_classes() { return kMaxC; }

// Which K2a kernel C classes get: 1 a compile-time C, 0 a run-time C.
extern "C" int fused_loss_forward_variant(int C) {
  return known_classes(C) ? 1 : 0;
}

// K2a: out[3C + 4] = (inter[C], sump[C], cnt[C], nll_sum, wsum, focal_sum,
// count) over all N pixels.  workspace holds fused_loss_workspace(N, HW, C)
// floats.
extern "C" int fused_loss_forward_f32(const float* x, const uint8_t* t,
                                      const float* cw, float* workspace,
                                      float* out, int C, long long N,
                                      long long HW, long long sB,
                                      long long sC, long long sP,
                                      int weighted, float alpha, float gamma,
                                      float eps, void* stream) {
  if (!layout_ok(C, N, HW)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{HW, sB, sC, sP};
  const FwdParams P{weighted, alpha, gamma, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(ceil_div(HW, kFwdPixels)),
                  static_cast<unsigned>(N / HW));
  if (C == 9) {
    fused_loss_forward_direct_kernel<9><<<grid, kThreads, 0, s>>>(
        x, t, cw, workspace, C, L, P);
  } else if (C == 11) {
    fused_loss_forward_direct_kernel<11><<<grid, kThreads, 0, s>>>(
        x, t, cw, workspace, C, L, P);
  } else {
    fused_loss_forward_direct_kernel<0><<<grid, kThreads, 0, s>>>(
        x, t, cw, workspace, C, L, P);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_loss_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      workspace, out, static_cast<int>(grid.x * grid.y), 3 * C + 4);
  return static_cast<int>(cudaGetLastError());
}

// Which K2b kernel the layout gets: 2 staged (dense channels_last, C = 9
// or 11, 16-byte aligned), 1 direct with a compile-time C, 0 direct with a
// run-time C.
extern "C" int fused_loss_backward_variant(const float* x, const float* dx,
                                           int C, long long HW, long long sB,
                                           long long sC, long long sP) {
  const bool flat = sC == 1 && sP == C && sB == HW * C;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  return known_classes(C) ? (flat && aligned ? 2 : 1) : 0;
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
  if (!layout_ok(C, N, HW)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{HW, sB, sC, sP};
  const BwdParams P{weighted, alpha, gamma, eps, smooth, w_ce, w_dice,
                    w_focal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = fused_loss_backward_variant(x, dx, C, HW, sB, sC, sP);
  if (variant == 2 && !direct) {
    const unsigned blocks = static_cast<unsigned>(ceil_div(N, kThreads));
    if (C == 9) {
      fused_loss_backward_staged_kernel<9><<<blocks, kThreads, 0, s>>>(
          x, t, cw, acc, cotangent, dx, N, P);
    } else {
      fused_loss_backward_staged_kernel<11><<<blocks, kThreads, 0, s>>>(
          x, t, cw, acc, cotangent, dx, N, P);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(ceil_div(HW, kThreads)),
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
