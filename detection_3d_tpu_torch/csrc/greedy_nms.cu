// Greedy NMS pass: for each of G score-ordered (N, N) float32 IoU
// matrices, row i, when not suppressed, suppresses every j > i with
// iou[g][i][j] > threshold (compared in float32, as JAX compares a float32
// array with a Python float; NaN never exceeds it); rows with valid[g][i]
// false start suppressed. Writes keep[g] (post,) int32, the kept positions
// ascending, padded -1, and count[g] = min(kept, post).
//
// Replaces the JAX package's lax.fori_loop in detection_3d_tpu/ops/nms.py
// (_greedy_suppress, not a Pallas kernel). Contract: the same keep sets as
// the plain version detection_3d_tpu_torch/ops/nms.py:greedy_plain.
//
// What bounds it on an H100: the upper triangle of the float32 matrices,
// read once (32 MB at 4 x 2000^2, ~10 us at 3.35 TB/s), and the walk,
// which is sequential over the rows: a predicated OR a row in the
// chain, a few cycles, and the OR of the alive rows' words beside it.
//
// Design, two launches on the caller's stream:
//  * pack (every SM): a warp a row. 32 lanes read 32 consecutive floats
//    (coalesced, streaming) and __ballot_sync turns "> threshold" into 32
//    bits, two ballots a u64 word; four words' loads are in flight at
//    once. Only the words at or right of the row's diagonal word are read
//    (the pass never looks below the diagonal), into a u64 scratch laid
//    out slab by slab: the 64 rows of slab b (rows 64 b ..) one after
//    another, each from word b & ~1 to W = ceil(N / 64) rounded up to
//    even, so every slab is one contiguous, 16-byte aligned block. The
//    bits (1 MB at 4 x 2000^2) stay in L2 for the walk.
//  * walk (a block a matrix): one thread of warp 1 copies each slab with
//    one cp.async.bulk (TMA) into a ring of shared-memory stages (up to
//    kMaxStages, as many as kRingBytes holds), each with a transaction
//    mbarrier, and waits for a stage's release before reusing it. (A
//    bulk copy a row, 64 a slab, held the walk at ~2 us a slab on the
//    H100, whatever the rows kept.) Warp 0 holds the suppressed mask in
//    registers (word w in lane w % 32, at most 4 words a lane at N =
//    8192). For slab b every lane takes the suppressed word b from its
//    owner (one shuffle) and the slab's 64 diagonal words
//    (broadcast loads, all in flight at once) into registers, then runs
//    the greedy chain over the slab's rows there: a predicated OR a row,
//    the only serial part. (Jumping from alive row to alive row with
//    __ffsll put a dependent shared-memory load in the chain: ~170 cycles
//    a kept row on the H100, against a few here.) Each lane then ORs the
//    alive rows' words right of b into its own, loads that do not depend
//    on one another, and the owner keeps word b.
//  * The kept positions are compacted by warp 0, 32 words a round, with
//    a warp prefix sum of the words' popcounts.
//  * Above N = 8192 (kRegMaxN) the mask no longer fits 4 words a lane
//    and a slab (64 x W x 8 bytes: 256 KB at N = 32768) no longer fits
//    shared memory, so another walk takes over: a block of kLargeThreads
//    a matrix, the suppressed mask in shared memory (W words: 17.7 KB
//    at N = 141,421, the largest (N, N) float32 matrix 80 GB hold), the
//    slabs read from the scratch in global memory (L2) as they are. Warp
//    0 runs the same greedy chain over a slab's 64 diagonal words (64
//    loads at once), then every thread ORs the alive rows' words right
//    of the slab into the mask words it owns (eight rows' loads in
//    flight at once). Any N up to kMaxN is taken; every offset into the
//    IoU and the scratch is 64-bit.
// Each output is written once; the wrapper allocates the scratch and the
// kernels allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRegMaxN = 8192;      // the register-mask walk's largest N
constexpr int kLaneWords = 4;       // ceil(ceil(kRegMaxN / 64) / 32)
// ops/nms.py GREEDY_MAX_N: a mask of 16,384 words (128 KB of shared
// memory); its (N, N) float32 matrix would take 4 TB
constexpr int kMaxN = 1 << 20;
constexpr int kLargeThreads = 256;  // the large walk's block
constexpr int kPackWarps = 8;       // rows a pack block
constexpr int kPackUnroll = 4;      // words whose loads are in flight
constexpr int kSlab = 64;           // rows a walk slab: one mask word
constexpr int kMaxStages = 8;
// the ring's shared memory: 3 stages of 64 rows at N = 8192, 8 at N <= 3072
constexpr int kRingBytes = 3 * kSlab * 128 * 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr int mask_words(int n) {
  return ((n + 63) / 64 + 1) & ~1;
}

// where slab b starts in a matrix's scratch, in words: slab b' holds 64
// rows of words - (b' & ~1) words each, one after another
__host__ __device__ constexpr long long slab_offset(int b, int words) {
  return (long long)kSlab *
         ((long long)b * words - 2LL * (b >> 1) * ((b >> 1) - 1) -
          2LL * (b >> 1) * (b & 1));
}

// the walk's ring stages at this n: as many 64-row slabs as kRingBytes holds
__host__ __device__ constexpr int ring_stages(int n) {
  return kRingBytes / (kSlab * mask_words(n) * 8) < kMaxStages
             ? kRingBytes / (kSlab * mask_words(n) * 8)
             : kMaxStages;
}

__global__ void __launch_bounds__(32 * kPackWarps)
greedy_nms_pack_kernel(const float* __restrict__ iou, float t, int n,
                       uint64_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (r >= n) return;   // uniform over the warp
  const int words = mask_words(n);
  const int wd = r >> 6, w0 = wd & ~1;   // diagonal word, first stored
  const float* src = iou + ((size_t)blockIdx.y * n + r) * n;
  // the row's words w0.. at dst[w - w0], in its slab's block of rows
  uint64_t* dst = bits + blockIdx.y * slab_offset((n + 63) / 64, words) +
                  slab_offset(wd, words) + (r & 63) * (words - w0);
  uint64_t mine = 0;                     // word (group * 32 + lane)
  for (int wb = wd & ~(kPackUnroll - 1); wb < words; wb += kPackUnroll) {
    bool o[2 * kPackUnroll];
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
      const int w = wb + u, p = 64 * w + lane;
      o[2 * u] = w >= wd && p < n && __ldcs(src + p) > t;
      o[2 * u + 1] = w >= wd && p + 32 < n && __ldcs(src + p + 32) > t;
    }
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
      const uint64_t word =
          (uint64_t)__ballot_sync(kFull, o[2 * u + 1]) << 32 |
          __ballot_sync(kFull, o[2 * u]);
      if (lane == ((wb + u) & 31)) mine = word;
    }
    if (((wb + kPackUnroll) & 31) == 0 || wb + kPackUnroll >= words) {
      const int w = (wb & ~31) + lane;   // a group of 32 words ends
      if (w >= w0 && w < words) dst[w - w0] = mine;
      mine = 0;
    }
  }
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem(bar)), "r"(count) : "memory");
}

// waits for the completion of the barrier's phase of this parity; a
// wait that never ends traps (a launch error) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
}

// one bulk (TMA) copy from global to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar))
               : "memory");
}

__global__ void __launch_bounds__(64)
greedy_nms_walk_kernel(const uint64_t* __restrict__ bits,
                       const uint8_t* __restrict__ valid, int n, int post,
                       int* __restrict__ keep, int* __restrict__ count) {
  extern __shared__ __align__(128) uint64_t ring[];   // (stages, 64, W)
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int g = blockIdx.x, lane = threadIdx.x & 31;
  const int words = mask_words(n), slabs = (n + kSlab - 1) / kSlab;
  const int stages = ring_stages(n);
  bits += g * slab_offset(slabs, words);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {   // warp 1: one thread copies each slab
    if (threadIdx.x > 32) return;
    for (int b = 0; b < slabs; ++b) {
      const int s = b % stages, span = words - (b & ~1);
      const uint32_t bytes = min(kSlab, n - kSlab * b) * span * 8;
      if (b >= stages) bar_wait(&empty[s], (b / stages - 1) & 1);
      bar_expect(&full[s], bytes);
      bulk_load(ring + (size_t)s * kSlab * words,
                bits + slab_offset(b, words), bytes, &full[s]);
    }
    return;
  }

  // warp 0: the suppressed mask, word 32 k + lane in sup[k]; positions
  // past n start suppressed, so they are never kept
  valid += (size_t)g * n;
  uint64_t sup[kLaneWords];
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) {
    sup[k] = ~0ull;
    for (int j0 = 0; j0 < 32 && 32 * k + j0 < words; j0 += 8) {
      bool lo[8], hi[8];   // eight words' loads in flight
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int p = 64 * (32 * k + j0 + u) + lane;
        lo[u] = p >= n || !valid[p];
        hi[u] = p + 32 >= n || !valid[p + 32];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint64_t word = (uint64_t)__ballot_sync(kFull, hi[u]) << 32 |
                              __ballot_sync(kFull, lo[u]);
        if (lane == j0 + u) sup[k] = word;
      }
    }
  }

  for (int b = 0; b < slabs; ++b) {
    const int s = b % stages, w0 = b & ~1, span = words - w0;
    const int kb = b >> 5;
    uint64_t own = sup[0];
#pragma unroll
    for (int k = 1; k < kLaneWords; ++k)
      if (k == kb) own = sup[k];
    uint64_t cur = __shfl_sync(kFull, own, b & 31);   // word b
    bar_wait(&full[s], (b / stages) & 1);
    const uint64_t* stage = ring + (size_t)s * kSlab * words;   // [i][w - w0]
    // the slab's diagonal words (one broadcast load each), only the bits
    // right of each row's own; rows past n are suppressed in cur
    uint64_t d[kSlab];
#pragma unroll
    for (int i = 0; i < kSlab; ++i)
      d[i] = stage[(size_t)i * span + b - w0] &
             (i == 63 ? 0ull : ~0ull << (i + 1));
    // the greedy chain over the slab's rows, the only serial part: a
    // predicated OR a row, from registers; rows 0..31 touch the high half
    // off the chain
    uint32_t lo = static_cast<uint32_t>(cur);
    uint32_t hi = static_cast<uint32_t>(cur >> 32);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (!((lo >> i) & 1u)) {
        lo |= static_cast<uint32_t>(d[i]);
        hi |= static_cast<uint32_t>(d[i] >> 32);
      }
    }
#pragma unroll
    for (int i = 32; i < kSlab; ++i)
      if (!((hi >> (i - 32)) & 1u)) hi |= static_cast<uint32_t>(d[i] >> 32);
    cur = (uint64_t)hi << 32 | lo;
    const uint64_t alive = ~cur;
    // each lane ORs the alive rows' words right of b into its own: every
    // load unconditional, masked by its row's alive bit, so none waits
    // for another
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k) {
      const int w = 32 * k + lane;
      if (alive == 0 || 32 * k + 31 <= b || 32 * k >= words) continue;
      if (w > b && w < words) {
        uint64_t acc = 0;
#pragma unroll
        for (int i = 0; i < kSlab; ++i)
          acc |= stage[(size_t)i * span + w - w0] &
                 (0ull - ((alive >> i) & 1ull));
        sup[k] |= acc;
      }
    }
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k)
      if (k == kb && lane == (b & 31)) sup[k] = cur;
    __syncwarp();   // every lane has read the stage
    if (lane == 0) bar_arrive(&empty[s]);
  }

  keep += (size_t)g * post;
  int base = 0;
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) {
    if (32 * k >= words || base >= post) break;   // uniform over the warp
    const int w = 32 * k + lane;
    const uint64_t kept = w < words ? ~sup[k] : 0ull;
    const int c = __popcll(kept);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int at = base + incl - c;
    for (uint64_t x = kept; x != 0 && at < post; x &= x - 1, ++at)
      keep[at] = 64 * w + __ffsll(static_cast<long long>(x)) - 1;
    base += __shfl_sync(kFull, incl, 31);
  }
  base = min(base, post);
  if (lane == 0) count[g] = base;
  for (int at = base + lane; at < post; at += 32) keep[at] = -1;
}

// the walk above kRegMaxN: the mask in shared memory, the slabs read
// from the scratch where they lie
__global__ void __launch_bounds__(kLargeThreads)
greedy_nms_walk_large_kernel(const uint64_t* __restrict__ bits,
                             const uint8_t* __restrict__ valid, int n,
                             int post, int* __restrict__ keep,
                             int* __restrict__ count) {
  extern __shared__ uint64_t sup[];   // the suppressed mask, W words
  __shared__ uint64_t alive_s;
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int words = mask_words(n), slabs = (n + kSlab - 1) / kSlab;
  bits += g * slab_offset(slabs, words);
  valid += (size_t)g * n;
  // positions past n and invalid rows start suppressed
  for (int w = tid; w < words; w += kLargeThreads) {
    uint64_t word = 0;
    for (int j = 0; j < 64; ++j) {
      const long long p = 64LL * w + j;
      word |= (uint64_t)(p >= n || !valid[p]) << j;
    }
    sup[w] = word;
  }
  __syncthreads();

  for (int b = 0; b < slabs; ++b) {
    const int w0 = b & ~1, span = words - w0;
    const int rows = min(kSlab, n - kSlab * b);
    const uint64_t* slab = bits + slab_offset(b, words);   // [i][w - w0]
    if (tid < 32) {
      // the slab's diagonal words, only the bits right of each row's
      // own; rows past n are suppressed in cur and never read
      uint64_t d[kSlab];
#pragma unroll
      for (int i = 0; i < kSlab; ++i)
        d[i] = i < rows ? __ldg(slab + (size_t)i * span + b - w0) &
                              (i == 63 ? 0ull : ~0ull << (i + 1))
                        : 0ull;
      uint64_t cur = sup[b];
#pragma unroll
      for (int i = 0; i < kSlab; ++i)
        if (!((cur >> i) & 1ull)) cur |= d[i];
      if (lane == 0) {
        sup[b] = cur;
        alive_s = ~cur;
      }
    }
    __syncthreads();
    const uint64_t alive = alive_s;
    // the alive rows' words right of b, eight rows' loads at once
    for (int w = b + 1 + tid; w < words && alive != 0; w += kLargeThreads) {
      uint64_t acc = 0, x = alive;
      while (x != 0) {
        uint64_t got[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = __ffsll(static_cast<long long>(x)) - 1;
          got[u] = x != 0 ? __ldg(slab + (size_t)i * span + w - w0) : 0ull;
          x &= x - 1;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc |= got[u];
      }
      sup[w] |= acc;
    }
    __syncthreads();   // word b + 1 is final before the next slab reads it
  }

  if (tid >= 32) return;
  keep += (size_t)g * post;
  int base = 0;
  for (int w0 = 0; w0 < words && base < post; w0 += 32) {   // uniform
    const int w = w0 + lane;
    const uint64_t kept = w < words ? ~sup[w] : 0ull;
    const int c = __popcll(kept);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int at = base + incl - c;
    for (uint64_t x = kept; x != 0 && at < post; x &= x - 1, ++at)
      keep[at] = 64 * w + __ffsll(static_cast<long long>(x)) - 1;
    base += __shfl_sync(kFull, incl, 31);
  }
  base = min(base, post);
  if (lane == 0) count[g] = base;
  for (int at = base + lane; at < post; at += 32) keep[at] = -1;
}

}  // namespace

// the u64 scratch words a matrix takes: its slabs, W = ceil(n / 64)
// rounded up to even
extern "C" long long greedy_nms_scratch_words(int n) {
  return slab_offset((n + kSlab - 1) / kSlab, mask_words(n));
}

// iou (g, n, n) float32 and valid (g, n) bytes (torch.bool); bits a u64
// scratch of greedy_nms_scratch_words(n) words a matrix; keep (g, post)
// and count (g,) int32. The pack launch over every SM, then the walk, a
// block a matrix: the register-mask walk up to kRegMaxN, the large one
// above.
extern "C" int greedy_nms(const void* iou, const void* valid,
                          float threshold, int g, int n, int post,
                          void* bits, void* keep, void* count,
                          void* stream) {
  if (g < 1 || g > 65535 || n < 1 || n > kMaxN || post < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kPackWarps - 1) / kPackWarps, g);
  greedy_nms_pack_kernel<<<grid, 32 * kPackWarps, 0, st>>>(
      static_cast<const float*>(iou), threshold, n,
      static_cast<uint64_t*>(bits));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > kRegMaxN) {
    const size_t mask = (size_t)mask_words(n) * sizeof(uint64_t);
    if (mask > 48 * 1024) {
      e = cudaFuncSetAttribute(greedy_nms_walk_large_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)mask);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    greedy_nms_walk_large_kernel<<<g, kLargeThreads, mask, st>>>(
        static_cast<const uint64_t*>(bits),
        static_cast<const uint8_t*>(valid), n, post, static_cast<int*>(keep),
        static_cast<int*>(count));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t ring = (size_t)ring_stages(n) * kSlab * mask_words(n) *
                      sizeof(uint64_t);
  if (ring + 2 * kMaxStages * sizeof(uint64_t) > 48 * 1024) {
    e = cudaFuncSetAttribute(greedy_nms_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ring);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_nms_walk_kernel<<<g, 64, ring, st>>>(
      static_cast<const uint64_t*>(bits), static_cast<const uint8_t*>(valid),
      n, post, static_cast<int*>(keep), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
