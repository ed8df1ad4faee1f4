// Greedy NMS pass: for each of G score-ordered (N, N) bool matrices
// over[g][i][j] = (IoU(i, j) > threshold), row i, when not suppressed,
// suppresses every j > i it overlaps; rows with valid[g][i] false start
// suppressed. Writes keep[g] (post,) int32, the kept positions ascending,
// padded -1, and count[g] = min(kept, post).
//
// Replaces the JAX package's lax.fori_loop in detection_3d_tpu/ops/nms.py
// (_greedy_suppress, not a Pallas kernel), which the port had run on the
// host after copying each matrix there. Contract, the same keep sets as
// the plain version detection_3d_tpu_torch/ops/nms.py:greedy_plain (a
// numpy loop over the same bits in the same order).
//
// What bounds it on an H100: the N^2 bytes of a matrix are read once,
// 4 MB at N = 2000; the pass is sequential over the rows, so one block
// owns a matrix and the G matrices of a unit (its buildings' RPN
// proposals, or their classes' detections) run on G SMs at once.
//
// Design:
//  * The suppressed set is a bit mask of ceil(N / 32) words in shared
//    memory. Positions past N start suppressed, so they are never kept.
//  * Rows come in blocks of kRows: every thread packs 32 bools of a row
//    into one word (four 4-byte loads when the row is aligned, else byte
//    loads), only the words at or right of the block's diagonal, into
//    shared memory.
//  * Warp 0 then walks the block's rows in order: a row whose bit is
//    clear ORs its words (bits j > i only) into the mask, a lane a word.
//  * The kept positions are compacted by warp 0, 32 words a round, with
//    a warp prefix sum of the words' popcounts.
// Each output is written once; the kernel allocates nothing and launches
// on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// bits t of the word: row[32 * w + t] != 0 for positions below n
__device__ __forceinline__ uint32_t pack_word(const uint8_t* row, int w,
                                              int n) {
  const int p0 = 32 * w;
  uint32_t bits = 0;
  if (p0 + 32 <= n && (reinterpret_cast<uintptr_t>(row + p0) & 3) == 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(row + p0);
    uint32_t u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = q[j];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((u[j] >> (8 * b)) & 0xFFu) bits |= 1u << (4 * j + b);
    return bits;
  }
  for (int t = 0; t < 32 && p0 + t < n; ++t)
    if (row[p0 + t]) bits |= 1u << t;
  return bits;
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const uint8_t* __restrict__ over,
                  const uint8_t* __restrict__ valid, int n, int post,
                  int* __restrict__ keep, int* __restrict__ count) {
  extern __shared__ uint32_t smem[];
  const int words = (n + 31) >> 5;
  uint32_t* sup = smem;                 // (words,) suppressed bits
  uint32_t* blk = smem + words;         // (kRows, words) staged rows
  const int g = blockIdx.x;
  over += (size_t)g * n * n;
  valid += (size_t)g * n;
  keep += (size_t)g * post;
  const int tid = threadIdx.x, lane = tid & 31;

  for (int w = tid; w < words; w += kThreads) {
    uint32_t bits = 0;
    for (int t = 0; t < 32; ++t) {
      const int p = 32 * w + t;
      if (p >= n || !valid[p]) bits |= 1u << t;
    }
    sup[w] = bits;
  }

  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int rows = min(kRows, n - r0);
    const int w0 = r0 >> 5, span = words - w0;
    __syncthreads();   // the mask is set, the previous block is read
    for (int e = tid; e < rows * span; e += kThreads) {
      const int rr = e / span, w = w0 + e % span;
      blk[rr * words + w] = pack_word(over + (size_t)(r0 + rr) * n, w, n);
    }
    __syncthreads();
    if (tid < 32) {
      for (int rr = 0; rr < rows; ++rr) {
        const int i = r0 + rr, wi = i >> 5;
        if ((sup[wi] >> (i & 31)) & 1u) continue;   // uniform over the warp
        for (int w = wi + lane; w < words; w += 32) {
          uint32_t m = blk[rr * words + w];
          if (w == wi) m &= (i & 31) == 31 ? 0u : kFull << ((i & 31) + 1);
          sup[w] |= m;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  if (tid < 32) {
    int base = 0;
    for (int w0 = 0; w0 < words && base < post; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t kept = w < words ? ~sup[w] : 0u;
      const int c = __popc(kept);
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      int at = base + incl - c;
      for (uint32_t b = kept; b != 0 && at < post; b &= b - 1, ++at)
        keep[at] = 32 * w + __ffs(b) - 1;
      base += __shfl_sync(kFull, incl, 31);
    }
    base = min(base, post);
    if (lane == 0) count[g] = base;
    for (int at = base + lane; at < post; at += 32) keep[at] = -1;
  }
}

}  // namespace

// over (g, n, n) and valid (g, n) as bytes (torch.bool); keep (g, post)
// and count (g,) int32. One block a matrix.
extern "C" int greedy_nms(const void* over, const void* valid, int g, int n,
                          int post, void* keep, void* count, void* stream) {
  if (g < 1 || n < 1 || post < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (n + 31) / 32;
  const size_t smem = (size_t)(kRows + 1) * words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_nms_kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(over), static_cast<const uint8_t*>(valid),
      n, post, static_cast<int*>(keep), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
