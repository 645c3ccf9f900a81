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
// takes its pixel's C values from there (stride C words) and writes its
// dlogits back, and device memory sees only full sectors, each once.
// fused_loss_backward_variant() says which tensors it takes: dense
// channels_last, 16-byte aligned.  Every other accepted layout (contiguous
// NCHW, where a warp's accesses are coalesced as they are; unaligned
// pointers) takes K2b's direct kernel.  The direct kernels of K2a and K2b
// have one thread per pixel at the logits' strides, the image in the
// grid's y index, so no thread divides by H*W.  Up to kNarrowC = 16 classes
// every class count has its own instantiation of each of the three
// (NarrowClasses, with_class_count), so the class loops unroll with no
// predicated slots: a user's own --schema runs on the same forms as the
// two packaged schemas (9 and 11 classes).
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
//   memory, no spills (C = 11: 79 registers, C = 16: 125, at the resident
//   blocks kFwdBlocks asks for; the run-time-C form that took the other
//   class counts before every one had its own: 106).  The form
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
//     persistent: six resident blocks per SM (four above 11 classes, where
//     a thread needs more registers) in different phases overlap one's
//     loads with another's arithmetic.  At an even C the lanes reading
//     word c of their rows, C words apart, meet in shared-memory banks
//     (8-way at C = 8).  Measured at [8, C, 512, 512] for C = 6, 8, 12, 16
//     on an H100 80GB HBM3 at 700 W (tools/k2_variants.py, copies of this
//     source with the choice rewritten, in turns), the word-by-word
//     walk took 0.0412, 0.0514, 0.0723, 0.0956 ms; rows in 16- and 8-byte
//     pieces, conflict-free, the same within 1%; the wide staged K2b's
//     lane-skewed walk 1-7% more (0.0434, 0.0551, 0.0756, 0.0968; the
//     rotation's index arithmetic, and a spill at 16); rows padded to
//     C + 1 words, copied through registers, 24-37% more; five resident
//     blocks above 11 classes spilled.  So the walk stays word by word.
//   - fused_loss_backward_direct_kernel<C>: one thread per pixel, compiled
//     for four resident blocks (left to itself the compiler spilled at 15
//     classes; with the bound it is 3-22% faster at 8 to 13 classes, the
//     same at 16 and 12% slower at 6, the same tool).
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
//
// Wide kernels, for 17 to 128 classes (the Pallas loss asserts C <= 128):
// the kernels above keep a pixel's C logits and K2a's 3C + 4 sums in
// registers, one instantiation per class count up to kNarrowC = 16; at 128
// those arrays would spill.  The same rules hold for the wide kernels: the
// 3C + 4 statistics and the final sum in a fixed order, no atomics, two
// launches bit-equal.  K2a wide, two kernels:
//   - fused_loss_forward_wide_staged_kernel<T>, for dense channels_last
//     logits (16-byte aligned): the wide staged K2b's span (the most of
//     256, 128 or 64 pixels whose C floats take at most 32 KB), two spans
//     in shared memory with the 16-byte cp.async copies of the next in
//     flight during the arithmetic of this one.  By rows, T = 256 / span
//     threads per pixel take its max and one expf per class kept in
//     place, with the bank-skewed class walk of the wide staged K2b, then
//     1 / sum and the four scalars; by columns, the block as groups of C
//     threads sums p_c, p_c [y == c] and [y == c] over the span's pixels,
//     lanes on consecutive words.  Each logit is read from device memory
//     once, in whole sectors, and takes one expf; the class sums are f32
//     within a span (at most 32 terms) and double across spans.  Measured
//     on an H100 80GB HBM3 at 700 W (chip_smoke.py's [k2], a CUDA graph of
//     50 launches, the wide kernel in turns): 0.108 ms against 0.170 at
//     [8, 20, 512, 512] (0.47 of the bound), 0.644 against 3.026 at
//     [8, 128, 512, 512] (0.50); 48 registers at T = 1, 62 at T = 2 and
//     4, no spills.  What is left at 20 classes: a block walks its 16 spans
//     one after the other behind three barriers each, and the grid's 512
//     blocks give an SM about 4 of the 5 it could hold.
//   - fused_loss_forward_wide_kernel, for every other layout: per chunk
//     of 256 pixels the pixel threads read a pixel's logits twice (max,
//     then the sum of exps) and leave max and 1 / sum in shared memory;
//     thread c then re-reads class c over the chunk's pixels (one more
//     expf), in double, so no per-class array is needed anywhere.
//
// K2b wide, two kernels, both with the per-class dice and CE terms in
// shared memory and backward_pixel's arithmetic class by class:
//   - fused_loss_backward_wide_staged_kernel, for dense channels_last
//     logits (16-byte aligned): a block of 256, 128 or 64 threads (the
//     most whose span takes at most 32 KB, so that several blocks stay
//     resident in different phases) stages its span of pixels x C floats
//     with 16-byte cp.async chunks, each thread turns its pixel's logits
//     into dlogits in place (max; one expf per class, the exps kept in
//     place; <g, p>; dlogits) and the block writes the span back with
//     16-byte stores: device memory sees each byte once, in whole sectors.
//     A pixel's C floats lie C words apart from its neighbour's, so a
//     thread starts its class walk at (lane g / 32) with g the largest
//     power of two dividing C (at most 32): the 32 lanes hit 32 banks at
//     every step, and each pixel's sums keep one fixed order.  Measured at
//     [8, 20, 512, 512] channels_last on an H100 80GB HBM3 at 700 W
//     (chip_smoke.py's [k2], a CUDA graph of 50 launches): 0.136 ms, 0.74
//     of the bound, against 0.465 ms for the direct kernel below; 38
//     registers, no spills.
//   - fused_loss_backward_wide_kernel, for every other layout: one thread
//     per pixel at the logits' strides, the logits read four times per
//     pixel (max, sum, <g, p>, dlogits), the passes after the first mostly
//     from L1.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr int kMaxC = 128;                // most classes (the Pallas loss's)
constexpr int kNarrowC = 16;              // most classes a thread holds
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
__device__ __forceinline__ float softmax_exp(float (&v)[CT], float& mx) {
  mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < CT; ++i) mx = fmaxf(mx, v[i]);
  float se = 0.f;
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    v[i] = expf(v[i] - mx);
    se += v[i];
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

// A thread's partial sums, the 3C + 4 statistics in order: [c] inter,
// [C + c] sump, [2 C + c] cnt, then nll_sum, wsum, focal_sum, count.
template <int CT>
constexpr int kFwdSlots = 3 * CT + 4;

// One pixel: v[] holds its logits, y its target (-1: a target outside
// [0, C) has no class) and xy the target's logit; its terms are added to
// acc[].  cw_s holds the C class weights (ones when unweighted).
template <int CT>
__device__ __forceinline__ void forward_pixel(
    float (&v)[CT], int y, float xy, const float* __restrict__ cw_s,
    const FwdParams& P, float (&acc)[kFwdSlots<CT>]) {
  float mx;
  const float se = softmax_exp<CT>(v, mx);
  const float inv_se = 1.f / se;
  float py = 0.f;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const float p = v[c] * inv_se;
    acc[CT + c] += p;
    if (c == y) {
      py = p;
      acc[c] += p;
      acc[2 * CT + c] += 1.f;
    }
  }
  const float wy = y >= 0 ? cw_s[y] : (P.weighted ? 0.f : 1.f);
  const float nll = y >= 0 ? -((xy - mx) - logf(se)) : 0.f;
  const float q = py + P.eps;
  const float b = 1.f - q;
  const float pw = P.gamma == 2.f ? b * b : powf(b, P.gamma);
  acc[3 * CT + 0] += nll * wy;
  acc[3 * CT + 1] += wy;
  acc[3 * CT + 2] += -P.alpha * pw * logf(q);
  acc[3 * CT + 3] += 1.f;
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

// K2a, any accepted layout, CT classes: one thread per pixel at the
// logits' strides; blockIdx.y is the image, and block (bx, by) takes its
// pixels [bx kFwdPixels, (bx + 1) kFwdPixels).  The two kernels below
// run it.
template <int CT>
__device__ __forceinline__ void forward_direct(const float* __restrict__ x,
                                               const uint8_t* __restrict__ t,
                                               const float* __restrict__ cw,
                                               float* __restrict__ partials,
                                               const Layout& L,
                                               const FwdParams& P) {
  __shared__ float rows[kWarps][kFwdSlots<CT>];
  __shared__ float cw_s[CT];
  if (threadIdx.x < CT) cw_s[threadIdx.x] = P.weighted ? cw[threadIdx.x] : 1.f;
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
      float v[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) v[c] = x[base + c * L.sC];
      int y = -1;
      float xy = 0.f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if (c == target) {
          y = c;
          xy = v[c];
        }
      }
      forward_pixel<CT>(v, y, xy, cw_s, P, acc);
    }
  }
  // the block's row of partials[3C + 4][n_rows]
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_rows = gridDim.x * gridDim.y;
  const float total = block_sum_slots<kFwdSlots<CT>>(acc, rows);
  if (threadIdx.x < kFwdSlots<CT>) {
    partials[static_cast<long long>(threadIdx.x) * n_rows + row] = total;
  }
}

// Resident blocks K2a's direct kernel is compiled for from 10 classes on:
// as many as the registers of a thread's 3C + 4 sums and C logits leave
// room for (80 and 128 registers a thread).  Left to itself the compiler
// spills 8 B at 10 and 13 classes.  Measured against it
// (tools/k2_variants.py, in turns, H100 80GB HBM3 at 700 W): 2-8% faster
// at 11 to 13 classes and 15% slower at 10, where it chose 64 registers
// and the spill over 80 and three blocks.  Up to 9 classes, where it
// spills nothing, asking for four blocks cost 1-3% at 9 classes: there
// the compiler keeps its own choice (0).
template <int CT>
constexpr int kFwdBlocks = CT <= 9 ? 0 : CT <= 12 ? 3 : 2;

// K2a's direct kernel up to 9 classes, and from 10 on
template <int CT>
__global__ void __launch_bounds__(kThreads)
fused_loss_forward_direct_kernel(const float* __restrict__ x,
                                 const uint8_t* __restrict__ t,
                                 const float* __restrict__ cw,
                                 float* __restrict__ partials, Layout L,
                                 FwdParams P) {
  forward_direct<CT>(x, t, cw, partials, L, P);
}

template <int CT>
__global__ void __launch_bounds__(kThreads, kFwdBlocks<CT>)
fused_loss_forward_direct_blocks_kernel(const float* __restrict__ x,
                                        const uint8_t* __restrict__ t,
                                        const float* __restrict__ cw,
                                        float* __restrict__ partials,
                                        Layout L, FwdParams P) {
  forward_direct<CT>(x, t, cw, partials, L, P);
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct BwdParams {
  int weighted;
  float alpha, gamma, eps, smooth, w_ce, w_dice, w_focal;
};

// What every pixel of a block shares, from K2a's statistics, for up to
// NC classes.
template <int NC>
struct BwdStatsN {
  float g_other[NC];   // dice term g_c where c is not the target
  float g_target[NC];  // g_c where c is the target
  float a_ce[NC + 1];  // w_y / wsum by target class; [C]: no class
  float count;
  float ct;
};
using BwdStats = BwdStatsN<kNarrowC>;

// The first C threads fill `s`; the caller synchronizes.
template <class Stats>
__device__ __forceinline__ void load_stats(Stats& s,
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
__device__ __forceinline__ void backward_pixel(float (&v)[CT], int target,
                                               const BwdStats& s,
                                               const BwdParams& P) {
  float mx;
  const float se = softmax_exp<CT>(v, mx);
  const float inv_se = 1.f / se;
  int y = CT;  // CT: a target outside [0, C) has no class
  float py = 0.f;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    v[c] *= inv_se;
    if (c == target) {
      y = c;
      py = v[c];
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
  for (int c = 0; c < CT; ++c) {
    gp += (c == y ? s.g_target[c] : s.g_other[c]) * v[c];
  }
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const float oh = (c == y) ? 1.f : 0.f;
    const float g = c == y ? s.g_target[c] : s.g_other[c];
    const float d = P.w_ce * (a_ce * (v[c] - oh)) +
                    P.w_focal * (a_focal * (oh - v[c])) +
                    P.w_dice * (v[c] * (g - gp));
    v[c] = d * s.ct;
  }
}

// Resident blocks the staged K2b asks of the compiler: six (at most 40
// registers a thread) up to 11 classes, four (64) above, where a pixel's
// logits alone take up to 16 registers.
template <int CT>
constexpr int kStagedBlocks = CT <= 11 ? 6 : 4;

// K2b, dense channels_last, CT classes: x and dx are flat [N][CT],
// 16-byte aligned.  Each thread walks its pixel's row of the span word by
// word; at an even CT the lanes meet in banks, which costs less than the
// ways round them (K2b's design, above).
template <int CT>
__global__ void __launch_bounds__(kThreads, kStagedBlocks<CT>)
fused_loss_backward_staged_kernel(const float* __restrict__ x,
                                  const uint8_t* __restrict__ t,
                                  const float* __restrict__ cw,
                                  const float* __restrict__ acc,
                                  const float* __restrict__ cotangent,
                                  float* __restrict__ dx, long long N,
                                  BwdParams P) {
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
    backward_pixel<CT>(v, target, stats, P);
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

// K2b, any accepted layout, CT classes: one thread per pixel at the
// logits' strides; blockIdx.y is the image.  Compiled for four resident
// blocks (64 registers): left to itself the compiler spills at 15 classes.
template <int CT>
__global__ void __launch_bounds__(kThreads, 4)
fused_loss_backward_direct_kernel(const float* __restrict__ x,
                                  const uint8_t* __restrict__ t,
                                  const float* __restrict__ cw,
                                  const float* __restrict__ acc,
                                  const float* __restrict__ cotangent,
                                  float* __restrict__ dx, Layout L,
                                  BwdParams P) {
  __shared__ BwdStats stats;
  load_stats(stats, acc, cw, cotangent, CT, P);
  __syncthreads();

  const long long hw = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (hw >= L.HW) return;
  const long long b = blockIdx.y;
  const long long base = b * L.sB + hw * L.sP;
  const int target = t[b * L.HW + hw];
  float v[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) v[c] = x[base + c * L.sC];
  backward_pixel<CT>(v, target, stats, P);
#pragma unroll
  for (int c = 0; c < CT; ++c) dx[base + c * L.sC] = v[c];
}

// ------------------------------------------------------------------- //
// K2a and K2b, wide: kNarrowC < C <= kMaxC at run time
// ------------------------------------------------------------------- //

// K2a, any accepted layout, more classes than a thread holds.  The grid is
// the direct kernel's (a block walks kFwdSpans chunks of kThreads pixels of
// one image).  Per chunk, the pixel threads take their pixel's max and
// 1 / sum over the logits (two passes, nothing per class kept) and the four
// scalars, and leave max, 1 / sum and the target in shared memory; then the
// block's threads, as G = kThreads / C groups of C, take class c of every
// G-th pixel of the chunk (group k: pixels k, k + G, ...) and add p,
// p [y == c] and [y == c] in double.  At the end thread c sums its class
// over the groups in group order, and the scalars take the block's
// fixed-order reduction: the order of every sum depends on N and C only,
// as in the direct kernel.
__global__ void __launch_bounds__(kThreads)
fused_loss_forward_wide_kernel(const float* __restrict__ x,
                               const uint8_t* __restrict__ t,
                               const float* __restrict__ cw,
                               float* __restrict__ partials, int C, Layout L,
                               FwdParams P) {
  constexpr int kNone = -1;   // a target outside [0, C)
  constexpr int kPast = -2;   // no pixel: past the image's end
  __shared__ float s_mx[kThreads];
  __shared__ float s_inv[kThreads];
  __shared__ int s_y[kThreads];
  __shared__ float cw_s[kMaxC];
  __shared__ float rows[kWarps][4];
  __shared__ double groups[3][kThreads];  // a group's class sums
  const int tid = threadIdx.x;
  if (tid < C) cw_s[tid] = P.weighted ? cw[tid] : 1.f;
  __syncthreads();

  // this thread's class and group; threads past n_groups * C stay idle
  const int n_groups = kThreads / C;
  const int grp = tid / C;
  const int cls = tid - grp * C;
  float scal[4] = {0.f, 0.f, 0.f, 0.f};
  double inter = 0.0, sump = 0.0, cnt = 0.0;  // class cls over the group's
  const long long b = blockIdx.y;
  const long long hw_block = static_cast<long long>(blockIdx.x) * kFwdPixels;
  for (int k = 0; k < kFwdSpans; ++k) {
    const long long hw0 = hw_block + static_cast<long long>(k) * kThreads;
    if (hw0 >= L.HW) break;  // the same for every thread of the block
    const long long hw = hw0 + tid;
    int y = kPast;
    if (hw < L.HW) {
      const long long base = b * L.sB + hw * L.sP;
      const int target = t[b * L.HW + hw];
      float mx = -INFINITY;
      for (int c = 0; c < C; ++c) mx = fmaxf(mx, x[base + c * L.sC]);
      float se = 0.f;
      for (int c = 0; c < C; ++c) se += expf(x[base + c * L.sC] - mx);
      const float inv_se = 1.f / se;
      y = target < C ? target : kNone;
      float py = 0.f, xy = 0.f;
      if (y >= 0) {
        xy = x[base + y * L.sC];
        py = expf(xy - mx) * inv_se;
      }
      const float wy = y >= 0 ? cw_s[y] : (P.weighted ? 0.f : 1.f);
      const float nll = y >= 0 ? -((xy - mx) - logf(se)) : 0.f;
      const float q = py + P.eps;
      const float bq = 1.f - q;
      const float pw = P.gamma == 2.f ? bq * bq : powf(bq, P.gamma);
      scal[0] += nll * wy;
      scal[1] += wy;
      scal[2] += -P.alpha * pw * logf(q);
      scal[3] += 1.f;
      s_mx[tid] = mx;
      s_inv[tid] = inv_se;
    }
    s_y[tid] = y;
    __syncthreads();
    if (grp < n_groups) {
      const long long col = b * L.sB + static_cast<long long>(cls) * L.sC;
      for (int j = grp; j < kThreads; j += n_groups) {
        const int yj = s_y[j];
        if (yj == kPast) break;  // the pixels past the end come last
        const float p =
            expf(x[col + (hw0 + j) * L.sP] - s_mx[j]) * s_inv[j];
        sump += p;
        if (yj == cls) {
          inter += p;
          cnt += 1.0;
        }
      }
    }
    __syncthreads();  // s_* are rewritten by the next chunk
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float sum = warp_sum(scal[v]);
    if (lane == 0) rows[warp][v] = sum;
  }
  if (grp < n_groups) {
    groups[0][tid] = inter;
    groups[1][tid] = sump;
    groups[2][tid] = cnt;
  }
  __syncthreads();
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  const long long n_rows = gridDim.x * gridDim.y;
  if (tid < 4) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += rows[w][tid];
    partials[(3LL * C + tid) * n_rows + row] = total;
  }
  if (tid < C) {
    double sums[3] = {0.0, 0.0, 0.0};
    for (int k = 0; k < n_groups; ++k) {
#pragma unroll
      for (int v = 0; v < 3; ++v) sums[v] += groups[v][k * C + tid];
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      partials[static_cast<long long>(v * C + tid) * n_rows + row] =
          static_cast<float>(sums[v]);
    }
  }
}

// K2a, dense channels_last, more classes than a thread holds: x is flat
// [N][C], 16-byte aligned.  Block b takes pixels [b kFwdPixels, (b + 1)
// kFwdPixels) of the flat index, in spans of kSpan = kThreads / T pixels
// (wide_span(C): the most of 256, 128 and 64 whose kSpan C floats take at
// most 32 KB), two spans in shared memory: the 16-byte cp.async copies of
// span s + 1 are in flight while the block works on span s.  Per span:
//   - by rows: thread (k, j) takes pixel j's classes [k M, (k + 1) M),
//     M = ceil(C / T), from a skewed start (lane l starts at (l g / 32) mod
//     its count, g the largest power of two dividing C, at most 32, as in
//     the wide staged K2b: the lanes of a warp, whose pixels lie C words
//     apart, meet in a bank at most twice); its max, then one expf per
//     class kept in place and their sum; the T threads of a pixel meet in
//     shared memory (T > 1), and thread (0, j) keeps 1 / sum and the
//     target and adds the pixel's four scalars;
//   - by columns: the block's threads as kThreads / C groups of C, thread
//     (group, c) sums p_c, p_c [y == c] and [y == c] over the span's
//     pixels group, group + groups, ...: the lanes read consecutive words.
// A thread's class sums are f32 within a span (at most 32 terms) and
// double across spans; at the end thread c sums its class over the groups
// in group order (double), and the scalars take the block's fixed-order
// reduction.  Every order depends on N and C only.
template <int T>
__global__ void __launch_bounds__(kThreads)
fused_loss_forward_wide_staged_kernel(const float* __restrict__ x,
                                      const uint8_t* __restrict__ t,
                                      const float* __restrict__ cw,
                                      float* __restrict__ partials, int C,
                                      long long N, FwdParams P) {
  constexpr int kSpan = kThreads / T;
  extern __shared__ __align__(16) float buf[];  // [2][kSpan C]
  __shared__ float cw_s[kMaxC];
  __shared__ float s_inv[kSpan];    // 1 / sum of exps, by pixel
  __shared__ int s_y[kSpan];        // the target, -1 for no class
  __shared__ float s_z[kSpan];      // the target's logit - max
  __shared__ float s_max[T][kSpan];  // the T threads' partial maxes
  __shared__ float s_sum[T][kSpan];  // and sums
  __shared__ float rows[kWarps][4];
  const int tid = threadIdx.x;
  if (tid < C) cw_s[tid] = P.weighted ? cw[tid] : 1.f;

  const long long n_first = static_cast<long long>(blockIdx.x) * kFwdPixels;
  const long long left = N - n_first;
  const int n_block = left < kFwdPixels ? static_cast<int>(left)
                                        : kFwdPixels;
  const int n_spans = (n_block + kSpan - 1) / kSpan;
  const int span_fl = kSpan * C;
  const float* src = x + n_first * C;  // 16-byte aligned: 4 | kFwdPixels C

  // by rows: pixel j, class block k (one k per warp)
  const int j = tid % kSpan, k = tid / kSpan;
  const int M = (C + T - 1) / T;
  const int c_lo = k * M;
  const int m_k = min(C, c_lo + M) - c_lo;  // at least 1 for C > kNarrowC
  const int g = min(C & -C, 32);
  const int first = (((tid & 31) * g) >> 5) % m_k;
  // by columns: class cc of group grp; threads past n_groups C stay idle
  const int n_groups = kThreads / C;
  const int grp = tid / C, cc = tid - grp * C;

  float scal[4] = {0.f, 0.f, 0.f, 0.f};
  double inter = 0.0, sump = 0.0, cnt = 0.0;

  const auto stage = [&](int s) {  // span s into its half of buf
    const int n_px = min(kSpan, n_block - s * kSpan);
    const int n_fl = n_px * C, n_vec = n_fl >> 2;
    const float* from = src + static_cast<long long>(s) * span_fl;
    float* to = buf + (s & 1) * span_fl;
    for (int i = tid; i < n_vec; i += kThreads) {
      cp_async_16(to + 4 * i, from + 4 * i);
    }
    for (int i = 4 * n_vec + tid; i < n_fl; i += kThreads) to[i] = from[i];
  };
  stage(0);
  cp_async_commit();
  for (int s = 0; s < n_spans; ++s) {
    if (s + 1 < n_spans) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // span s has landed (this thread's copies)
    __syncthreads();     // and every thread's
    const long long n0 = n_first + static_cast<long long>(s) * kSpan;
    const int n_px = min(kSpan, n_block - s * kSpan);
    float* cur = buf + (s & 1) * span_fl;

    // by rows
    const bool live = j < n_px;
    float* v = cur + j * C;
    const int target = live ? t[n0 + j] : 0;
    const int y = target < C ? target : -1;
    float mx = -INFINITY;
    if (live) {
      for (int i = 0, c = c_lo + first; i < m_k;
           ++i, c = c + 1 == c_lo + m_k ? c_lo : c + 1) {
        mx = fmaxf(mx, v[c]);
      }
    }
    if (T > 1) {
      s_max[k][j] = mx;
      __syncthreads();
      mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < T; ++kk) mx = fmaxf(mx, s_max[kk][j]);
    }
    float se = 0.f;
    if (live) {
      if (y >= c_lo && y < c_lo + m_k) s_z[j] = v[y] - mx;
      for (int i = 0, c = c_lo + first; i < m_k;
           ++i, c = c + 1 == c_lo + m_k ? c_lo : c + 1) {
        const float e = expf(v[c] - mx);
        v[c] = e;
        se += e;
      }
    }
    if (T > 1) {
      s_sum[k][j] = se;
      __syncthreads();
      se = 0.f;
#pragma unroll
      for (int kk = 0; kk < T; ++kk) se += s_sum[kk][j];
    }
    if (k == 0 && live) {
      const float inv_se = 1.f / se;
      s_inv[j] = inv_se;
      s_y[j] = y;
      const float py = y >= 0 ? v[y] * inv_se : 0.f;
      const float wy = y >= 0 ? cw_s[y] : (P.weighted ? 0.f : 1.f);
      const float nll = y >= 0 ? -(s_z[j] - logf(se)) : 0.f;
      const float q = py + P.eps;
      const float bq = 1.f - q;
      const float pw = P.gamma == 2.f ? bq * bq : powf(bq, P.gamma);
      scal[0] += nll * wy;
      scal[1] += wy;
      scal[2] += -P.alpha * pw * logf(q);
      scal[3] += 1.f;
    }
    __syncthreads();

    // by columns
    if (grp < n_groups) {
      const float* col = cur + cc;
      float fs = 0.f, fi = 0.f, fc = 0.f;
      for (int jj = grp; jj < n_px; jj += n_groups) {
        const float p = col[jj * C] * s_inv[jj];
        fs += p;
        if (s_y[jj] == cc) {
          fi += p;
          fc += 1.f;
        }
      }
      sump += fs;
      inter += fi;
      cnt += fc;
    }
    __syncthreads();  // span s's half of buf, s_inv and s_y are free
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int vv = 0; vv < 4; ++vv) {
    const float sum = warp_sum(scal[vv]);
    if (lane == 0) rows[warp][vv] = sum;
  }
  double* groups = reinterpret_cast<double*>(buf);  // [3][kThreads]
  if (grp < n_groups) {
    groups[tid] = inter;
    groups[kThreads + tid] = sump;
    groups[2 * kThreads + tid] = cnt;
  }
  __syncthreads();
  const int row = blockIdx.x;
  const long long n_rows = gridDim.x;
  if (tid < 4) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += rows[w][tid];
    partials[(3LL * C + tid) * n_rows + row] = total;
  }
  if (tid < C) {
    double sums[3] = {0.0, 0.0, 0.0};
    for (int gg = 0; gg < n_groups; ++gg) {
#pragma unroll
      for (int vv = 0; vv < 3; ++vv) {
        sums[vv] += groups[vv * kThreads + gg * C + tid];
      }
    }
#pragma unroll
    for (int vv = 0; vv < 3; ++vv) {
      partials[static_cast<long long>(vv * C + tid) * n_rows + row] =
          static_cast<float>(sums[vv]);
    }
  }
}

// K2b, any accepted layout, more classes than a thread holds: one thread
// per pixel at the logits' strides (blockIdx.y the image), the per-class
// terms in shared memory, and the pixel's logits read four times (max, sum,
// <g, p>, dlogits) instead of held: the passes after the first mostly hit
// L1.  The arithmetic is backward_pixel's, class by class.  The wide
// staged kernel below takes dense channels_last logits.
__global__ void __launch_bounds__(kThreads)
fused_loss_backward_wide_kernel(const float* __restrict__ x,
                                const uint8_t* __restrict__ t,
                                const float* __restrict__ cw,
                                const float* __restrict__ acc,
                                const float* __restrict__ cotangent,
                                float* __restrict__ dx, int C, Layout L,
                                BwdParams P) {
  __shared__ BwdStatsN<kMaxC> stats;
  load_stats(stats, acc, cw, cotangent, C, P);
  __syncthreads();

  const long long hw = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (hw >= L.HW) return;
  const long long b = blockIdx.y;
  const long long base = b * L.sB + hw * L.sP;
  const int target = t[b * L.HW + hw];
  float mx = -INFINITY;
  for (int c = 0; c < C; ++c) mx = fmaxf(mx, x[base + c * L.sC]);
  float se = 0.f;
  for (int c = 0; c < C; ++c) se += expf(x[base + c * L.sC] - mx);
  const float inv_se = 1.f / se;
  const int y = target < C ? target : C;  // C: no class
  const float py = y < C ? expf(x[base + y * L.sC] - mx) * inv_se : 0.f;
  const float a_ce = stats.a_ce[y];

  const float q = py + P.eps;
  const float bq = 1.f - q;
  const float pw1 = P.gamma == 2.f ? bq : powf(bq, P.gamma - 1.f);
  const float fprime =
      -P.alpha * (-P.gamma * pw1 * logf(q) + (pw1 * bq) / q);
  const float a_focal = (fprime / stats.count) * py;

  float gp = 0.f;
  for (int c = 0; c < C; ++c) {
    const float p = expf(x[base + c * L.sC] - mx) * inv_se;
    gp += (c == y ? stats.g_target[c] : stats.g_other[c]) * p;
  }
  for (int c = 0; c < C; ++c) {
    const long long o = base + c * L.sC;
    const float p = expf(x[o] - mx) * inv_se;
    const float oh = (c == y) ? 1.f : 0.f;
    const float g = c == y ? stats.g_target[c] : stats.g_other[c];
    const float d = P.w_ce * (a_ce * (p - oh)) +
                    P.w_focal * (a_focal * (oh - p)) +
                    P.w_dice * (p * (g - gp));
    dx[o] = d * stats.ct;
  }
}

// K2b, dense channels_last, more classes than a thread holds: x and dx
// are flat [N][C], 16-byte aligned.  A block of P threads (kWideSpan(C))
// takes a span of P pixels, P C contiguous floats: it stages them with
// 16-byte cp.async chunks, each thread turns its pixel's logits into
// dlogits in place (one expf per class), and the block writes the span
// back with 16-byte stores.  A thread walks its pixel's C floats at stride
// 1 from a class of its own: lane l starts at (l g / 32) with g the
// largest power of two dividing C (at most 32), so that the 32 lanes of a
// warp, whose pixels lie C floats apart, hit 32 different banks at every
// step.  Each pixel's sums are taken in that fixed order.
__global__ void __launch_bounds__(kThreads)
fused_loss_backward_wide_staged_kernel(const float* __restrict__ x,
                                       const uint8_t* __restrict__ t,
                                       const float* __restrict__ cw,
                                       const float* __restrict__ acc,
                                       const float* __restrict__ cotangent,
                                       float* __restrict__ dx, int C,
                                       long long N, BwdParams P) {
  extern __shared__ __align__(16) float span[];  // [blockDim.x][C]
  __shared__ BwdStatsN<kMaxC> stats;
  const int tid = threadIdx.x;
  const int n_span = blockDim.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * n_span;
  const long long left = N - n0;
  const int n_px = left < n_span ? static_cast<int>(left) : n_span;
  const int n_fl = n_px * C;          // floats of this span
  const int n_vec = n_fl >> 2;        // whole 16-byte chunks
  const float* src = x + n0 * C;      // 16-byte aligned: n_span C is a
  float* dst = dx + n0 * C;           // multiple of 4

  for (int i = tid; i < n_vec; i += n_span) {
    cp_async_16(span + 4 * i, src + 4 * i);
  }
  for (int i = 4 * n_vec + tid; i < n_fl; i += n_span) span[i] = src[i];
  for (int c = tid; c < C; c += n_span) {  // load_stats, for any block size
    const float num = 2.f * acc[c] + P.smooth;
    const float den = acc[C + c] + acc[2 * C + c] + P.smooth;
    const float scale = static_cast<float>(C) * (den * den);
    stats.g_other[c] = num / scale;
    stats.g_target[c] = (num - 2.f * den) / scale;
    stats.a_ce[c] = (P.weighted ? cw[c] : 1.f) / acc[3 * C + 1];
  }
  if (tid == 0) {
    stats.a_ce[C] = (P.weighted ? 0.f : 1.f) / acc[3 * C + 1];
    stats.count = acc[3 * C + 3];
    stats.ct = *cotangent;
  }
  const int target = tid < n_px ? t[n0 + tid] : 0;
  cp_async_wait_all();
  __syncthreads();

  if (tid < n_px) {
    float* v = span + tid * C;
    const int g = min(C & -C, 32);
    const int first = ((tid & 31) * g) >> 5;
    // backward_pixel, class by class from `first`: the softmax, with the
    // exps left in v
    float mx = -INFINITY;
    for (int i = 0, c = first; i < C; ++i, c = c + 1 == C ? 0 : c + 1) {
      mx = fmaxf(mx, v[c]);
    }
    float se = 0.f;
    for (int i = 0, c = first; i < C; ++i, c = c + 1 == C ? 0 : c + 1) {
      const float e = expf(v[c] - mx);
      v[c] = e;
      se += e;
    }
    const float inv_se = 1.f / se;
    const int y = target < C ? target : C;  // C: no class
    const float py = y < C ? v[y] * inv_se : 0.f;
    const float a_ce = stats.a_ce[y];

    const float q = py + P.eps;
    const float b = 1.f - q;
    const float pw1 = P.gamma == 2.f ? b : powf(b, P.gamma - 1.f);
    const float fprime =
        -P.alpha * (-P.gamma * pw1 * logf(q) + (pw1 * b) / q);
    const float a_focal = (fprime / stats.count) * py;

    float gp = 0.f;
    for (int i = 0, c = first; i < C; ++i, c = c + 1 == C ? 0 : c + 1) {
      gp += (c == y ? stats.g_target[c] : stats.g_other[c]) * (v[c] * inv_se);
    }
    for (int i = 0, c = first; i < C; ++i, c = c + 1 == C ? 0 : c + 1) {
      const float p = v[c] * inv_se;
      const float oh = (c == y) ? 1.f : 0.f;
      const float gc = c == y ? stats.g_target[c] : stats.g_other[c];
      const float d = P.w_ce * (a_ce * (p - oh)) +
                      P.w_focal * (a_focal * (oh - p)) +
                      P.w_dice * (p * (gc - gp));
      v[c] = d * stats.ct;
    }
  }
  __syncthreads();

  for (int i = tid; i < n_vec; i += n_span) {
    *reinterpret_cast<float4*>(dst + 4 * i) =
        *reinterpret_cast<const float4*>(span + 4 * i);
  }
  for (int i = 4 * n_vec + tid; i < n_fl; i += n_span) dst[i] = span[i];
}

// Sizes both kernels take; the image index rides in the grid's y.
bool layout_ok(int C, long long N, long long HW) {
  return C >= 1 && C <= kMaxC && N >= 1 && HW >= 1 && N % HW == 0 &&
         N / HW <= 65535;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Pixels per block of the wide staged K2b: the most of 256, 128 and 64
// whose span takes at most 32 KB of shared memory (several blocks stay
// resident on an SM, each in its own phase).
int wide_span(int C) {
  int n = kThreads;
  while (n > 64 && n * C > 8192) n /= 2;
  return n;
}

// The class counts with kernels of their own: every one up to kNarrowC.
using NarrowClasses = std::integer_sequence<int, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                            10, 11, 12, 13, 14, 15, 16>;

// launch(std::integral_constant<int, C>{}): the launch of C's own
// instantiation, for C in NarrowClasses; cudaErrorInvalidValue otherwise.
template <class F, int... Cs>
cudaError_t with_class_count(int C, F&& launch,
                             std::integer_sequence<int, Cs...>) {
  cudaError_t e = cudaErrorInvalidValue;
  static_cast<void>(
      ((C == Cs && (e = launch(std::integral_constant<int, Cs>{}), true)) ||
       ...));
  return e;
}

template <class F>
cudaError_t with_class_count(int C, F&& launch) {
  return with_class_count(C, launch, NarrowClasses{});
}

// The wide staged K2a with T threads per pixel of a span, opted in to its
// shared memory (above 48 KB at more than 48 classes).
template <int T>
cudaError_t launch_wide_staged(const float* x, const uint8_t* t,
                               const float* cw, float* partials, int C,
                               long long N, FwdParams P, dim3 grid,
                               size_t smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      fused_loss_forward_wide_staged_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  fused_loss_forward_wide_staged_kernel<T><<<grid, kThreads, smem, s>>>(
      x, t, cw, partials, C, N, P);
  return cudaGetLastError();
}

// Whether logits at these strides are dense channels_last (flat [N][C];
// at one class, whatever the class stride) and, with dx where there is one,
// 16-byte aligned: what the staged kernels take.
bool flat_aligned(const float* x, const float* dx, int C, long long HW,
                  long long sB, long long sC, long long sP) {
  const bool flat = (sC == 1 || C == 1) && sP == C && sB == HW * C;
  return flat && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dx) % 16 == 0;
}

}  // namespace

// C entries for ctypes.  Each launch entry returns a cudaError_t: the
// launch's own error (a refused configuration never runs, and a later
// synchronize would not report it), or cudaErrorInvalidValue for sizes
// outside the bounds above.

// Rows of partials K2a's first kernel writes: one per block, a function of
// the shape only (a block of the direct and wide kernels does not cross
// images; the wide staged kernel's blocks cover the flat index and write
// ceil(N / kFwdPixels) rows, at most this many).
extern "C" long long fused_loss_partial_rows(long long N, long long HW) {
  return (N / HW) * ceil_div(HW, kFwdPixels);
}

// Floats of workspace K2a needs for B = N / HW images of HW pixels and C
// classes: the rows of partials.
extern "C" long long fused_loss_workspace(long long N, long long HW, int C) {
  return fused_loss_partial_rows(N, HW) * (3LL * C + 4);
}

extern "C" int fused_loss_max_classes() { return kMaxC; }

// Which K2a kernel the layout gets: up to kNarrowC classes 1, the direct
// kernel of the class count, whatever the layout; above, 4 the wide staged
// kernel (dense channels_last, 16-byte aligned), 3 the wide kernel (any
// other layout).
extern "C" int fused_loss_forward_variant(const float* x, int C,
                                          long long HW, long long sB,
                                          long long sC, long long sP) {
  if (C > kNarrowC) return flat_aligned(x, x, C, HW, sB, sC, sP) ? 4 : 3;
  return 1;
}

// K2a: out[3C + 4] = (inter[C], sump[C], cnt[C], nll_sum, wsum, focal_sum,
// count) over all N pixels.  workspace holds fused_loss_workspace(N, HW, C)
// floats.  direct != 0 takes the wide kernel above kNarrowC classes
// whatever the layout, to time the wide staged kernel against it.
extern "C" int fused_loss_forward_f32(const float* x, const uint8_t* t,
                                      const float* cw, float* workspace,
                                      float* out, int C, long long N,
                                      long long HW, long long sB,
                                      long long sC, long long sP,
                                      int weighted, float alpha, float gamma,
                                      float eps, int direct, void* stream) {
  if (!layout_ok(C, N, HW)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{HW, sB, sC, sP};
  const FwdParams P{weighted, alpha, gamma, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(ceil_div(HW, kFwdPixels)),
            static_cast<unsigned>(N / HW));
  const int variant = fused_loss_forward_variant(x, C, HW, sB, sC, sP);
  if (variant == 4 && !direct) {
    // a block per kFwdPixels of the flat index: at most the rows above
    grid = dim3(static_cast<unsigned>(ceil_div(N, kFwdPixels)));
    const int n_span = wide_span(C);
    const size_t smem = 2 * static_cast<size_t>(n_span) * C * sizeof(float);
    cudaError_t e = cudaSuccess;
    if (n_span == kThreads) {
      e = launch_wide_staged<1>(x, t, cw, workspace, C, N, P, grid, smem, s);
    } else if (n_span == kThreads / 2) {
      e = launch_wide_staged<2>(x, t, cw, workspace, C, N, P, grid, smem, s);
    } else {
      e = launch_wide_staged<4>(x, t, cw, workspace, C, N, P, grid, smem, s);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (C > kNarrowC) {
    fused_loss_forward_wide_kernel<<<grid, kThreads, 0, s>>>(
        x, t, cw, workspace, C, L, P);
  } else {
    const cudaError_t e = with_class_count(C, [&](auto ct) {
      constexpr int CT = decltype(ct)::value;
      if constexpr (kFwdBlocks<CT> == 0) {
        fused_loss_forward_direct_kernel<CT>
            <<<grid, kThreads, 0, s>>>(x, t, cw, workspace, L, P);
      } else {
        fused_loss_forward_direct_blocks_kernel<CT>
            <<<grid, kThreads, 0, s>>>(x, t, cw, workspace, L, P);
      }
      return cudaGetLastError();
    });
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_loss_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      workspace, out, static_cast<int>(grid.x * grid.y), 3 * C + 4);
  return static_cast<int>(cudaGetLastError());
}

// Which K2b kernel the layout gets: up to kNarrowC classes 2 the staged
// kernel of the class count (dense channels_last, 16-byte aligned), 1 its
// direct kernel (any other layout); above, 4 the wide staged kernel (dense
// channels_last, 16-byte aligned), 3 the wide direct kernel (any other
// layout).
extern "C" int fused_loss_backward_variant(const float* x, const float* dx,
                                           int C, long long HW, long long sB,
                                           long long sC, long long sP) {
  const bool staged = flat_aligned(x, dx, C, HW, sB, sC, sP);
  if (C > kNarrowC) return staged ? 4 : 3;
  return staged ? 2 : 1;
}

// K2b: dx (at the logits' strides) from K2a's out vector `acc` and the
// upstream cotangent of the total, both read on the device.  direct != 0
// takes the direct kernel whatever the layout (the wide direct kernel
// above kNarrowC classes), to time one against the other.
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
    return static_cast<int>(with_class_count(C, [&](auto ct) {
      fused_loss_backward_staged_kernel<decltype(ct)::value>
          <<<blocks, kThreads, 0, s>>>(x, t, cw, acc, cotangent, dx, N, P);
      return cudaGetLastError();
    }));
  }
  if (variant == 4 && !direct) {
    const int n_span = wide_span(C);
    const unsigned blocks = static_cast<unsigned>(ceil_div(N, n_span));
    const size_t smem = static_cast<size_t>(n_span) * C * sizeof(float);
    fused_loss_backward_wide_staged_kernel<<<blocks, n_span, smem, s>>>(
        x, t, cw, acc, cotangent, dx, C, N, P);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(ceil_div(HW, kThreads)),
                  static_cast<unsigned>(N / HW));
  if (C > kNarrowC) {
    fused_loss_backward_wide_kernel<<<grid, kThreads, 0, s>>>(
        x, t, cw, acc, cotangent, dx, C, L, P);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(with_class_count(C, [&](auto ct) {
    fused_loss_backward_direct_kernel<decltype(ct)::value>
        <<<grid, kThreads, 0, s>>>(x, t, cw, acc, cotangent, dx, L, P);
    return cudaGetLastError();
  }));
}
