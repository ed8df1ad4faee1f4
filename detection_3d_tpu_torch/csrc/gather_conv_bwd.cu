// Sparse-convolution backward, dW: the weight gradient of
//   out[i] = sum_k feats[idx[k, i]] @ W[k]      (rows with out_valid false
//                                                 are zero)
// for an upstream gradient g (V_out, Cout):
//   dW[k] = sum over the real entries (k, i) of feats[idx[k, i]]^T g[i],
// an entry being real when idx[k, i] is a real row (not the pad row V_in)
// and output row i is valid. The other gradient, dFeats, is kernel A's
// code on the transposed book (csrc/gather_conv.cu, its dfeats entries).
//
// Replaces the dW half of the VJP of the Pallas TPU kernel
// detection_3d_tpu/ops/pallas/gather_conv_kernel.py (_windowed_bwd, which
// differentiates the XLA gather_conv of ops/sparse_conv.py). Contract,
// identical to the plain version
// detection_3d_tpu_torch/ops/sparse_conv.py:gather_conv_dw: feats
// (V_in, Cin) and g (V_out, Cout) in one type (f32 or bf16); the book's
// real entries as (input row, output row) int32 pairs in k-major order,
// and starts (K + 1) int32, where offset k's entries begin
// (ops/sparse_conv.py:rulebook_entries). Sums are kept in f32; dW
// (K, Cin, Cout) comes out in the feats type.
//
// What bounds it on an H100: bytes. Each real entry reads one feats row
// and one g row, both at random, for 2 * Cin * Cout operations: at scale
// 0 (32 channels, bf16) 128 bytes for 2048 operations, far below the ~295
// operations per byte at which the tensor cores would set the pace. A
// submanifold book there holds ~1.2 real entries per row out of 27, so
// the design reads only the entries that exist.
//
// Design: a grouped GEMM whose reduction axis is the entries of one
// offset.
//  * Work items: each offset's entries are cut into runs of at most
//    per_item entries (numbered k-major); block (x, y) takes run x and
//    the y-th BM (Cin) x BN (Cout) tile, 32 wide where the channels are
//    <= 32, else 64, so no thread idles on a padded tile. The wrapper
//    sizes per_item for about a thousand blocks.
//  * bf16, 4 warps: per stage of 64 entries, the run's feats rows and g
//    rows go to shared memory with cp.async (zero-filled past the run's
//    end) in a ring of three buffers, two stages ahead of the products;
//    each thread reads the entry pairs of its rows one stage ahead, so no
//    copy waits on them. mma.sync m16n8k16 bf16 -> f32 runs with the
//    entries as the reduction axis: ldmatrix.trans turns the entry-major
//    tiles into the A (feats^T) and B (g) fragments. Each warp owns a
//    32 x 32 sub-tile; where the block tile holds fewer than four, the
//    warps share out each stage's 16-entry steps.
//  * f32 (tests and the small card-vs-CPU check): the same items on the
//    CUDA cores, 16 entries at a time through shared memory.
//  * Each block writes its f32 partial tile to its item's slot of a
//    scratch (n_items, Cin, Cout); a second kernel sums each offset's
//    partials in item order and writes dW in the feats type (zero for an
//    offset without entries). No atomics: the same inputs give the same
//    bits on every call.
// The kernels allocate nothing and launch on the caller's stream; the
// wrapper sizes the scratch (n_items >= sum over k of ceil(n_k /
// per_item)) and pads the channels of bf16 rows to multiples of 8.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---- work items ----------------------------------------------------------

__device__ __forceinline__ int items_of(const int* __restrict__ starts,
                                        int k, int per_item) {
  return (starts[k + 1] - starts[k] + per_item - 1) / per_item;
}

// The run of entries [begin, end) of offset k that block b takes; k = -1
// past the last item.
struct Item {
  int k, begin, end;
};

__device__ Item block_item(const int* __restrict__ starts, int n_off,
                           int per_item) {
  __shared__ Item item_s;
  if (threadIdx.x == 0) {
    Item it = {-1, 0, 0};
    int base = 0;
    for (int k = 0; k < n_off; ++k) {
      const int n = items_of(starts, k, per_item);
      if ((int)blockIdx.x < base + n) {
        it.k = k;
        it.begin = starts[k] + ((int)blockIdx.x - base) * per_item;
        it.end = min(it.begin + per_item, starts[k + 1]);
        break;
      }
      base += n;
    }
    item_s = it;
  }
  __syncthreads();
  return item_s;
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int BE = 64;          // entries per stage (the reduction axis)
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kThreads = 128;   // 4 warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; zero-filled when bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// WM x WN warps' 32 x 32 sub-tiles make the BM x BN block tile; the
// SPLIT warps on one sub-tile share out the entry steps.
template <int WM, int WN>
struct DwTile {
  static constexpr int BM = 32 * WM;
  static constexpr int BN = 32 * WN;
  static constexpr int SPLIT = 4 / (WM * WN);
  static constexpr int A_STRIDE = BM + 8;   // bf16 per shared row (entry)
  static constexpr int B_STRIDE = BN + 8;
  static constexpr int A_ITERS = BE * (BM / 8) / kThreads;  // 16-byte
  static constexpr int B_ITERS = BE * (BN / 8) / kThreads;  // chunks each
  static constexpr int STAGE = BE * (A_STRIDE + B_STRIDE);  // bf16
  static constexpr int SMEM = kStages * STAGE * 2;          // bytes
  static_assert(A_ITERS * kThreads == BE * (BM / 8), "A chunks");
  static_assert(B_ITERS * kThreads == BE * (BN / 8), "B chunks");
  static_assert(SPLIT * BM * BN * 4 <= SMEM, "the reduction fits the ring");
};

template <int WM, int WN>
__global__ void __launch_bounds__(kThreads)
gather_dw_partial_bf16(const __nv_bfloat16* __restrict__ feats,
                       const __nv_bfloat16* __restrict__ g,
                       const int2* __restrict__ entries,
                       const int* __restrict__ starts,
                       float* __restrict__ partial, int n_off, int cin,
                       int cout, int per_item, int tiles_n) {
  using T = DwTile<WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const Item item = block_item(starts, n_off, per_item);
  if (item.k < 0) return;

  const int c0 = (blockIdx.y / tiles_n) * T::BM;
  const int n0 = (blockIdx.y % tiles_n) * T::BN;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int split = warp / (WM * WN);
  const int wm = (warp % (WM * WN)) / WN;
  const int wn = warp % WN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int steps = (item.end - item.begin + BE - 1) / BE;
  // the feats rows (A chunks) and g rows (B chunks) of this thread for
  // the next stage to load, read one stage ahead; -1 past the run's end
  int arow[T::A_ITERS], brow[T::B_ITERS];
  auto rows_of = [&](int st) {
    const int e0 = item.begin + st * BE;
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i) {
      const int e = e0 + (threadIdx.x + i * kThreads) / (T::BM / 8);
      arow[i] = e < item.end ? entries[e].x : -1;
    }
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i) {
      const int e = e0 + (threadIdx.x + i * kThreads) / (T::BN / 8);
      brow[i] = e < item.end ? entries[e].y : -1;
    }
  };
  rows_of(0);
  int next = 0;
  auto load_next = [&]() {
    if (next < steps) {
      __nv_bfloat16* as = smem + (next % kStages) * T::STAGE;
      __nv_bfloat16* bs = as + BE * T::A_STRIDE;
#pragma unroll
      for (int i = 0; i < T::A_ITERS; ++i) {
        const int ch = threadIdx.x + i * kThreads;
        const int r = ch / (T::BM / 8);
        const int cc = (ch % (T::BM / 8)) * 8;
        const bool ok = arow[i] >= 0 && c0 + cc < cin;
        cp_async16(as + r * T::A_STRIDE + cc,
                   ok ? feats + (size_t)arow[i] * cin + c0 + cc : feats,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < T::B_ITERS; ++i) {
        const int ch = threadIdx.x + i * kThreads;
        const int r = ch / (T::BN / 8);
        const int nn = (ch % (T::BN / 8)) * 8;
        const bool ok = brow[i] >= 0 && n0 + nn < cout;
        cp_async16(bs + r * T::B_STRIDE + nn,
                   ok ? g + (size_t)brow[i] * cout + n0 + nn : g,
                   ok ? 16 : 0);
      }
      rows_of(++next);
    }
    cp_async_commit();  // an empty group past the last stage keeps counts
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_next();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    // ... for every thread, and every thread is done with stage s - 1,
    // whose buffer the next load refills
    __syncthreads();
    load_next();
    const __nv_bfloat16* a_t = smem + (s % kStages) * T::STAGE;
    const __nv_bfloat16* b_t = a_t + BE * T::A_STRIDE;
#pragma unroll
    for (int ks = split * 16; ks < BE; ks += 16 * T::SPLIT) {
      uint32_t af[2][4], bf[4][2];
      // A = feats^T (Cin x entries) from the entry-major tile: matrices
      // (Cin 0-7 | 8-15) x (entries 0-7 | 8-15), transposed on load
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi],
                          a_t + (ks + (lane & 7) + ((lane >> 4) << 3))
                                    * T::A_STRIDE
                              + wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_t + (ks + lane % 16) * T::B_STRIDE + wn * 32
                                 + nh * 16 + (lane / 16) * 8);
        bf[2 * nh][0] = r[0];
        bf[2 * nh][1] = r[1];
        bf[2 * nh + 1][0] = r[2];
        bf[2 * nh + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], af[mi], bf[nj]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the SPLIT partial tiles

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int row = wm * 32 + mi * 16 + lane / 4 + (t >> 1) * 8;
        const int col = wn * 32 + nj * 8 + (lane % 4) * 2 + (t & 1);
        red[(split * T::BM + row) * T::BN + col] = acc[mi][nj][t];
      }
  __syncthreads();
  float* dst = partial + (size_t)blockIdx.x * cin * cout;
  for (int e = threadIdx.x; e < T::BM * T::BN; e += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int sp = 0; sp < T::SPLIT; ++sp) sum += red[sp * T::BM * T::BN + e];
    const int c = c0 + e / T::BN;
    const int n = n0 + e % T::BN;
    if (c < cin && n < cout) dst[(size_t)c * cout + n] = sum;
  }
}

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int F32_E = 16;       // entries per step

// 16 x 16 threads; thread (tx, ty) owns Cin rows ty*TM.. and Cout columns
// tx*TN.. of a (16 TM) x (16 TN) tile
template <int TM, int TN>
__global__ void __launch_bounds__(kF32Threads)
gather_dw_partial_f32(const float* __restrict__ feats,
                      const float* __restrict__ g,
                      const int2* __restrict__ entries,
                      const int* __restrict__ starts,
                      float* __restrict__ partial, int n_off, int cin,
                      int cout, int per_item, int tiles_n) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  __shared__ float a_s[F32_E][BM];   // gathered feats rows
  __shared__ float b_s[F32_E][BN];   // g rows
  const Item item = block_item(starts, n_off, per_item);
  if (item.k < 0) return;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c0 = (blockIdx.y / tiles_n) * BM;
  const int n0 = (blockIdx.y % tiles_n) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int e0 = item.begin; e0 < item.end; e0 += F32_E) {
    for (int x = tid; x < F32_E * BM; x += kF32Threads) {
      const int e = e0 + x / BM;
      const int c = c0 + x % BM;
      a_s[x / BM][x % BM] = (e < item.end && c < cin)
          ? feats[(size_t)entries[e].x * cin + c] : 0.f;
    }
    for (int x = tid; x < F32_E * BN; x += kF32Threads) {
      const int e = e0 + x / BN;
      const int n = n0 + x % BN;
      b_s[x / BN][x % BN] = (e < item.end && n < cout)
          ? g[(size_t)entries[e].y * cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < F32_E; ++r) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_s[r][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_s[r][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  float* dst = partial + (size_t)blockIdx.x * cin * cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (c < cin && n < cout) dst[(size_t)c * cout + n] = acc[i][j];
    }
  }
}

// ---- the sum of each offset's partials -----------------------------------

constexpr int kReduceThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Block (x, k) sums kReduceThreads / split consecutive elements of dW[k]
// over offset k's items; the split thread groups take every split-th item
// and their sums are added in group order, so the order is fixed.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
gather_dw_reduce(const float* __restrict__ partial,
                 const int* __restrict__ starts, T* __restrict__ d_w,
                 int per_item, int cc, int split) {
  __shared__ float red[kReduceThreads];
  const int k = blockIdx.y;
  const int width = kReduceThreads / split;
  const int col = threadIdx.x % width;
  const int grp = threadIdx.x / width;
  const int e = blockIdx.x * width + col;
  int first = 0;
  for (int j = 0; j < k; ++j) first += items_of(starts, j, per_item);
  const int count = items_of(starts, k, per_item);
  float s = 0.f;
  if (e < cc) {
#pragma unroll 8
    for (int j = grp; j < count; j += split)
      s += partial[(size_t)(first + j) * cc + e];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  if (grp == 0 && e < cc) {
    float t = 0.f;
    for (int q = 0; q < split; ++q) t += red[q * width + col];
    store(d_w + (size_t)k * cc + e, t);
  }
}

template <typename T>
int reduce(const float* partial, const int* starts, void* d_w, int n_off,
           int cc, int per_item, int n_items, cudaStream_t s) {
  // split the items of an offset over more threads when offsets hold
  // many items (the centre offset of a scale-0 book holds most of them)
  int split = 1;
  while (split < 8 && split * n_off * 4 < n_items) split *= 2;
  const int width = kReduceThreads / split;
  dim3 grid((cc + width - 1) / width, n_off);
  gather_dw_reduce<T><<<grid, kReduceThreads, 0, s>>>(
      partial, starts, static_cast<T*>(d_w), per_item, cc, split);
  return static_cast<int>(cudaGetLastError());
}

template <int WM, int WN>
int launch_bf16(const void* feats, const void* g, const void* entries,
                const void* starts, float* partial, int n_off, int cin,
                int cout, int per_item, int n_items, cudaStream_t s) {
  using T = DwTile<WM, WN>;
  auto kernel = gather_dw_partial_bf16<WM, WN>;
  if (T::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_n = (cout + T::BN - 1) / T::BN;
  dim3 grid(n_items, ((cin + T::BM - 1) / T::BM) * tiles_n);
  kernel<<<grid, kThreads, T::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const int2*>(entries), static_cast<const int*>(starts),
      partial, n_off, cin, cout, per_item, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

template <int TM, int TN>
int launch_f32(const void* feats, const void* g, const void* entries,
               const void* starts, float* partial, int n_off, int cin,
               int cout, int per_item, int n_items, cudaStream_t s) {
  const int tiles_n = (cout + 16 * TN - 1) / (16 * TN);
  dim3 grid(n_items, ((cin + 16 * TM - 1) / (16 * TM)) * tiles_n);
  gather_dw_partial_f32<TM, TN><<<grid, kF32Threads, 0, s>>>(
      static_cast<const float*>(feats), static_cast<const float*>(g),
      static_cast<const int2*>(entries), static_cast<const int*>(starts),
      partial, n_off, cin, cout, per_item, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partial: n_items x cin x cout f32 scratch; tiles are 32 wide along a
// side of <= 32 channels, else 64 (ops/sparse_conv.py:_dw_tile).
extern "C" int gather_conv_dw_f32(const void* feats, const void* g,
                                  const void* entries, const void* starts,
                                  void* partial, void* d_w, int n_off,
                                  int cin, int cout, int per_item,
                                  int n_items, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int err;
  if (cin <= 32)
    err = cout <= 32 ? launch_f32<2, 2>(feats, g, entries, starts, p, n_off,
                                        cin, cout, per_item, n_items, s)
                     : launch_f32<2, 4>(feats, g, entries, starts, p, n_off,
                                        cin, cout, per_item, n_items, s);
  else
    err = cout <= 32 ? launch_f32<4, 2>(feats, g, entries, starts, p, n_off,
                                        cin, cout, per_item, n_items, s)
                     : launch_f32<4, 4>(feats, g, entries, starts, p, n_off,
                                        cin, cout, per_item, n_items, s);
  if (err != 0) return err;
  return reduce<float>(p, static_cast<const int*>(starts), d_w, n_off,
                       cin * cout, per_item, n_items, s);
}

// bf16 needs cin % 8 == 0 and cout % 8 == 0 (the wrapper pads).
extern "C" int gather_conv_dw_bf16(const void* feats, const void* g,
                                   const void* entries, const void* starts,
                                   void* partial, void* d_w, int n_off,
                                   int cin, int cout, int per_item,
                                   int n_items, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int err;
  if (cin <= 32)
    err = cout <= 32 ? launch_bf16<1, 1>(feats, g, entries, starts, p, n_off,
                                         cin, cout, per_item, n_items, s)
                     : launch_bf16<1, 2>(feats, g, entries, starts, p, n_off,
                                         cin, cout, per_item, n_items, s);
  else
    err = cout <= 32 ? launch_bf16<2, 1>(feats, g, entries, starts, p, n_off,
                                         cin, cout, per_item, n_items, s)
                     : launch_bf16<2, 2>(feats, g, entries, starts, p, n_off,
                                         cin, cout, per_item, n_items, s);
  if (err != 0) return err;
  return reduce<__nv_bfloat16>(p, static_cast<const int*>(starts), d_w,
                               n_off, cin * cout, per_item, n_items, s);
}

extern "C" const char* gather_conv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
