// Sparse-convolution forward: out[i] = sum_k feats[idx[k, i]] @ W[k].
//
// Replaces the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// gather_conv_kernel.py (_kernel / _windowed_conv_call, reached through
// windowed_gather_conv). Contract, identical to the plain version
// detection_3d_tpu_torch/ops/sparse_conv.py:gather_conv:
//   feats (V_in, Cin) f32 or bf16, idx (K, V_out) int32 with idx == V_in
//   reading a zero row, W (K, Cin, Cout) in the feats type, out_valid
//   (V_out,) bool. Rows whose out_valid is false are written as zero.
//   Sums are kept in f32; the output is in the feats type.
// The same kernel computes the backward's dFeats: on the transposed book
// (ops/sparse_conv.py:transpose_rulebook) with W transposed, g takes the
// place of feats and dFeats that of out (every input row wanted). Its C
// entries gather_conv_dfeats_{f32,bf16} run the same body under a kernel
// symbol of its own (the ConvDFeats tag), so a device profile tells the
// forward and dFeats apart.
// The kernel takes out_valid through the rulebook's row order
// (ops/sparse_conv.py:rulebook_row_order), which the wrapper always
// passes: perm (V_out,) int32, a permutation of the output rows, and
// masks (V_out, MW) uint64, masks[p] holding bit k when row perm[p] is
// valid and has a real entry at offset k, in word k / 64: MW = 1 for
// K <= 64, MW = 2 for K <= 128 (the 5^3 stem of a segmentation network).
// Each mask width is its own instantiation (the *_w2 entries take two
// words), so a book of at most 64 offsets runs the one-word code. A row
// whose mask is 0 (out_valid false) runs no offset and is written as
// zero.
//
// What bounds it on an H100: bytes at most shapes of the main path (the
// random row reads and the output write at scale 0, ~1.1 real entries
// per row), operations for the 128-256 channel submanifold convs of the
// deep scales. Those calls are short and their tables mostly padding,
// so their time is set by the chain of dependent steps that a tile runs,
// not by either bound. The TPU kernel's windows, one-hot MXU gathers and
// 128-lane grouped rows exist because a TPU reads random rows badly; a
// GPU reads them through L1/L2 at sector granularity, so none of that is
// carried over.
//
// Design: one block owns a tile of BM consecutive positions of the row
// order (rows sorted by their offset mask, so a tile's rows share their
// real offsets) and BN output channels. It ORs its rows' masks and runs
// only the offsets in that OR: at scale 0 a tile then runs ~1-2 offsets
// instead of 27, and a deconv tile one instead of 8. Rows whose own mask
// lacks an offset gather the zero row. Each output row is written once,
// at its own index, so there are no atomics and the result is
// deterministic.
//   * bf16: per (offset, 32-channel chunk) step, the tile's gathered rows
//     and the W[k] chunk go to shared memory with cp.async (zero-filled
//     where a row has no entry) in a ring of three buffers, two steps
//     ahead of the products, and each warp runs a 32 x 32 sub-tile with
//     mma.sync m16n8k16 bf16 -> f32 (ldmatrix fragments). A deep-scale
//     tile runs a long chain of small steps, so load latency sets its
//     time: each thread reads the rulebook entries of its rows once per
//     offset, one offset ahead, so no copy waits on an idx load. Tiles:
//     128 x 32 for Cout <= 32, 64 x 64 for Cout <= 64, 64 x 128 above.
//     The wrapper pads Cin to a multiple of 16 and Cout to a multiple of
//     8 (16-byte copies).
//   * f32 (tests only): the same tile and offset skipping on the CUDA
//     cores: a 16 x 16 thread grid, each thread a TM x TN micro-tile.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// kernel symbol tags: the forward and dFeats run one body under two names
struct ConvForward {};
struct ConvDFeats {};

// ---- row order and tile mask, shared by both kernels ---------------------

// A set of offsets, MW words of 64 bits (offset k: word k / 64).
template <int MW>
struct Bits {
  uint64_t w[MW];

  __device__ __forceinline__ bool has(int k) const {
    if constexpr (MW == 1) {
      return (w[0] >> k) & 1ull;
    } else {
      return (w[k >> 6] >> (k & 63)) & 1ull;
    }
  }
  // the lowest offset in the set, or -1
  __device__ __forceinline__ int lowest() const {
#pragma unroll
    for (int i = 0; i < MW; ++i)
      if (w[i]) return 64 * i + __ffsll(static_cast<long long>(w[i])) - 1;
    return -1;
  }
  __device__ __forceinline__ void drop_lowest() {
#pragma unroll
    for (int i = 0; i < MW; ++i)
      if (w[i]) {
        w[i] &= w[i] - 1;
        return;
      }
  }
  __device__ __forceinline__ int count() const {
    int n = 0;
#pragma unroll
    for (int i = 0; i < MW; ++i) n += __popcll(w[i]);
    return n;
  }
};

// rows_s[r]: the output row at tile position r (-1 past V_out);
// masks_s[r]: its real offsets. Returns the OR of the tile's masks
// (after a barrier).
template <int BM, int THREADS, int MW>
__device__ __forceinline__ Bits<MW> tile_rows(
    const int* __restrict__ perm, const uint64_t* __restrict__ masks,
    int v_out, int m0, int* rows_s, Bits<MW>* masks_s, uint64_t* or_s) {
  if (threadIdx.x < MW) or_s[threadIdx.x] = 0;
  __syncthreads();
  Bits<MW> mine;
#pragma unroll
  for (int i = 0; i < MW; ++i) mine.w[i] = 0;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int p = m0 + r;
    rows_s[r] = p < v_out ? perm[p] : -1;
    Bits<MW> m;
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      m.w[i] = p < v_out ? masks[(size_t)p * MW + i] : 0;
      mine.w[i] |= m.w[i];
    }
    masks_s[r] = m;
  }
#pragma unroll
  for (int i = 0; i < MW; ++i)
    if (mine.w[i])
      atomicOr(reinterpret_cast<unsigned long long*>(or_s + i),
               static_cast<unsigned long long>(mine.w[i]));
  __syncthreads();
  Bits<MW> out;
#pragma unroll
  for (int i = 0; i < MW; ++i) out.w[i] = or_s[i];
  return out;
}

// The feature row that tile row (row, mask) reads at offset k, or -1.
template <int MW>
__device__ __forceinline__ int source_row(const int* __restrict__ idx,
                                          int row, const Bits<MW>& mask,
                                          int k, int v_in, int v_out) {
  if (row < 0 || !mask.has(k)) return -1;
  const int s = idx[(size_t)k * v_out + row];
  return (s >= 0 && s < v_in) ? s : -1;
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int BK = 32;          // channels per step (two mma k-steps)
constexpr int kStages = 3;      // cp.async ring depth
constexpr int A_STRIDE = BK + 8;  // bf16 per shared row of A (80 bytes)

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// WM x WN warps, each a 32 x 32 sub-tile of the BM x BN block tile.
template <int WM, int WN>
struct Tile {
  static constexpr int BM = 32 * WM;
  static constexpr int BN = 32 * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int B_STRIDE = BN + 8;
};

template <int WM, int WN, int MW>
struct Loader {
  using T = Tile<WM, WN>;
  // A's 16-byte chunks per thread: each thread copies fixed tile rows
  static constexpr int A_ITERS = T::BM * (BK / 8) / T::THREADS;
  static_assert(A_ITERS * T::THREADS == T::BM * (BK / 8), "A chunks");

  // the source rows of this thread's A chunks at offset k (-1: zero row)
  __device__ __forceinline__ static void sources(
      int* src, const int* idx, const int* rows_s, const Bits<MW>* masks_s,
      int k, int v_in, int v_out) {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int r = (threadIdx.x + i * T::THREADS) / (BK / 8);
      src[i] = k < 0 ? -1
                     : source_row(idx, rows_s[r], masks_s[r], k, v_in, v_out);
    }
  }

  // one (offset k, channels c0..c0+BK) step: gathered rows and W[k]
  __device__ __forceinline__ static void step(
      __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* feats,
      const __nv_bfloat16* w, const int* src, int k, int c0, int cin,
      int cout, int n0) {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int e = threadIdx.x + i * T::THREADS;
      const int r = e / (BK / 8);
      const int cc = (e % (BK / 8)) * 8;
      const bool ok = src[i] >= 0 && c0 + cc < cin;
      cp_async16(as + r * A_STRIDE + cc,
                 ok ? feats + (size_t)src[i] * cin + c0 + cc : feats,
                 ok ? 16 : 0);
    }
    constexpr int B_CHUNKS = BK * (T::BN / 8);
    for (int e = threadIdx.x; e < B_CHUNKS; e += T::THREADS) {
      const int kk = e / (T::BN / 8);
      const int nn = (e % (T::BN / 8)) * 8;
      const bool ok = c0 + kk < cin && n0 + nn < cout;
      cp_async16(bs + kk * T::B_STRIDE + nn,
                 ok ? w + ((size_t)k * cin + c0 + kk) * cout + n0 + nn : w,
                 ok ? 16 : 0);
    }
  }
};

template <int WM, int WN, int MW, typename Role>
__global__ void __launch_bounds__(Tile<WM, WN>::THREADS)
gather_conv_bf16_kernel(const __nv_bfloat16* __restrict__ feats,
                        const int* __restrict__ idx,
                        const __nv_bfloat16* __restrict__ w,
                        const int* __restrict__ perm,
                        const uint64_t* __restrict__ masks,
                        __nv_bfloat16* __restrict__ out, int v_in,
                        int v_out, int cin, int cout) {
  using T = Tile<WM, WN>;
  __shared__ __align__(16) __nv_bfloat16 as[kStages][T::BM * A_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 bs[kStages][BK * T::B_STRIDE];
  __shared__ int rows_s[T::BM];
  __shared__ Bits<MW> masks_s[T::BM];
  __shared__ uint64_t or_s[MW];

  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WN;
  const int wn = warp % WN;

  const Bits<MW> tile_or = tile_rows<T::BM, T::THREADS, MW>(
      perm, masks, v_out, m0, rows_s, masks_s, or_s);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int n_chunks = (cin + BK - 1) / BK;
  const int steps = tile_or.count() * n_chunks;
  // the (offset, chunk) of the next step to load; loads run kStages - 1
  // steps ahead of the products. The rulebook entries of this thread's
  // rows are read once per offset, and those of the offset after it are
  // read one offset ahead, so no copy waits on an idx load.
  using L = Loader<WM, WN, MW>;
  Bits<MW> bits = tile_or;
  int lk = bits.lowest();
  bits.drop_lowest();
  int nk = bits.lowest();
  int lc = 0;
  int src[L::A_ITERS], nsrc[L::A_ITERS];
  L::sources(src, idx, rows_s, masks_s, lk, v_in, v_out);
  L::sources(nsrc, idx, rows_s, masks_s, nk, v_in, v_out);
  auto load_next = [&](int step) {
    if (step < steps) {
      const int buf = step % kStages;
      L::step(as[buf], bs[buf], feats, w, src, lk, lc * BK, cin, cout, n0);
      if (++lc == n_chunks) {
        lc = 0;
        lk = nk;
#pragma unroll
        for (int i = 0; i < L::A_ITERS; ++i) src[i] = nsrc[i];
        bits.drop_lowest();
        nk = bits.lowest();
        L::sources(nsrc, idx, rows_s, masks_s, nk, v_in, v_out);
      }
    }
    cp_async_commit();  // an empty group past the last step keeps counts
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_next(st);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed
    // ... for every thread, and every thread is done with step s - 1,
    // whose buffer the next load refills
    __syncthreads();
    load_next(s + kStages - 1);
    const __nv_bfloat16* a_t = as[s % kStages];
    const __nv_bfloat16* b_t = bs[s % kStages];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], a_t + (wm * 32 + mi * 16 + lane % 16) * A_STRIDE
                                + ks + (lane / 16) * 8);
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

  // each row written once at its own index (zeros where it gathered none)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows_s[wm * 32 + mi * 16 + lane / 4 + h * 8];
      if (row < 0) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn * 32 + nj * 8 + (lane % 4) * 2;
        if (n >= cout) continue;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][nj][2 * h],
                                                 acc[mi][nj][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * cout + n) = v;
      }
    }
  }
}

template <int WM, int WN, int MW, typename Role>
void launch_bf16(const void* feats, const void* idx, const void* w,
                 const void* perm, const void* masks, void* out, int v_in,
                 int v_out, int cin, int cout, cudaStream_t stream) {
  using T = Tile<WM, WN>;
  dim3 grid((v_out + T::BM - 1) / T::BM, (cout + T::BN - 1) / T::BN);
  gather_conv_bf16_kernel<WM, WN, MW, Role><<<grid, T::THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const int*>(idx),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(perm),
      static_cast<const uint64_t*>(masks), static_cast<__nv_bfloat16*>(out),
      v_in, v_out, cin, cout);
}

// ---- f32: CUDA cores (tests only) -----------------------------------------

constexpr int kF32Threads = 256;
constexpr int BK32 = 16;

// 16 x 16 threads; thread (tx, ty) owns tile rows ty*TM.. and cols tx*TN..
template <int TM, int TN, int MW, typename Role>
__global__ void __launch_bounds__(kF32Threads)
gather_conv_f32_kernel(const float* __restrict__ feats,
                       const int* __restrict__ idx,
                       const float* __restrict__ w,
                       const int* __restrict__ perm,
                       const uint64_t* __restrict__ masks,
                       float* __restrict__ out, int v_in, int v_out,
                       int cin, int cout) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  __shared__ float a_s[BK32][BM + 1];  // gathered rows, channel-major
  __shared__ float b_s[BK32][BN];      // W[k] chunk
  __shared__ int rows_s[BM];
  __shared__ Bits<MW> masks_s[BM];
  __shared__ int src_s[BM];
  __shared__ uint64_t or_s[MW];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Bits<MW> bits = tile_rows<BM, kF32Threads, MW>(perm, masks, v_out, m0,
                                                 rows_s, masks_s, or_s);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k = bits.lowest(); k >= 0; bits.drop_lowest(), k = bits.lowest()) {
    for (int r = tid; r < BM; r += kF32Threads)
      src_s[r] = source_row(idx, rows_s[r], masks_s[r], k, v_in, v_out);
    __syncthreads();
    for (int c0 = 0; c0 < cin; c0 += BK32) {
      for (int e = tid; e < BM * BK32; e += kF32Threads) {
        const int r = e / BK32;
        const int c = e % BK32;
        const int src = src_s[r];
        a_s[c][r] = (src >= 0 && c0 + c < cin)
                        ? feats[(size_t)src * cin + c0 + c] : 0.f;
      }
      for (int e = tid; e < BK32 * BN; e += kF32Threads) {
        const int c = e / BN;
        const int n = e % BN;
        b_s[c][n] = (c0 + c < cin && n0 + n < cout)
                        ? w[((size_t)k * cin + c0 + c) * cout + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < BK32; ++c) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_s[c][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = b_s[c][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = rows_s[ty * TM + i];
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < cout) out[(size_t)row * cout + n] = acc[i][j];
    }
  }
}

template <int TM, int TN, int MW, typename Role>
void launch_f32(const void* feats, const void* idx, const void* w,
                const void* perm, const void* masks, void* out, int v_in,
                int v_out, int cin, int cout, cudaStream_t stream) {
  dim3 grid((v_out + 16 * TM - 1) / (16 * TM),
            (cout + 16 * TN - 1) / (16 * TN));
  gather_conv_f32_kernel<TM, TN, MW, Role><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(feats), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const int*>(perm),
      static_cast<const uint64_t*>(masks), static_cast<float*>(out), v_in,
      v_out, cin, cout);
}

template <int MW, typename Role>
int run_f32(const void* feats, const void* idx, const void* w,
            const void* perm, const void* masks, void* out, int v_in,
            int v_out, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 32)
    launch_f32<8, 2, MW, Role>(feats, idx, w, perm, masks, out, v_in, v_out, cin,
                           cout, s);
  else
    launch_f32<4, 4, MW, Role>(feats, idx, w, perm, masks, out, v_in, v_out, cin,
                           cout, s);
  return static_cast<int>(cudaGetLastError());
}

template <int MW, typename Role>
int run_bf16(const void* feats, const void* idx, const void* w,
             const void* perm, const void* masks, void* out, int v_in,
             int v_out, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 32)
    launch_bf16<4, 1, MW, Role>(feats, idx, w, perm, masks, out, v_in, v_out,
                            cin, cout, s);
  else if (cout <= 64)
    launch_bf16<2, 2, MW, Role>(feats, idx, w, perm, masks, out, v_in, v_out,
                            cin, cout, s);
  else
    launch_bf16<2, 4, MW, Role>(feats, idx, w, perm, masks, out, v_in, v_out,
                            cin, cout, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 needs cin % 16 == 0 and cout % 8 == 0 (the wrapper pads). The
// *_w2 entries take masks of two words a row (64 < K <= 128).
#define GATHER_CONV_ENTRY(name, run, MW, Role)                              \
  extern "C" int name(const void* feats, const void* idx, const void* w,    \
                      const void* perm, const void* masks, void* out,       \
                      int v_in, int v_out, int cin, int cout,               \
                      void* stream) {                                       \
    return run<MW, Role>(feats, idx, w, perm, masks, out, v_in, v_out, cin, \
                         cout, stream);                                     \
  }

GATHER_CONV_ENTRY(gather_conv_f32, run_f32, 1, ConvForward)
GATHER_CONV_ENTRY(gather_conv_bf16, run_bf16, 1, ConvForward)
GATHER_CONV_ENTRY(gather_conv_dfeats_f32, run_f32, 1, ConvDFeats)
GATHER_CONV_ENTRY(gather_conv_dfeats_bf16, run_bf16, 1, ConvDFeats)
GATHER_CONV_ENTRY(gather_conv_f32_w2, run_f32, 2, ConvForward)
GATHER_CONV_ENTRY(gather_conv_bf16_w2, run_bf16, 2, ConvForward)
GATHER_CONV_ENTRY(gather_conv_dfeats_f32_w2, run_f32, 2, ConvDFeats)
GATHER_CONV_ENTRY(gather_conv_dfeats_bf16_w2, run_bf16, 2, ConvDFeats)

extern "C" const char* gather_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
