// Sparse-convolution backward: the two gradients of
//   out[i] = sum_k feats[idx[k, i]] @ W[k]      (rows with out_valid false
//                                                 are zero)
// for an upstream gradient g (V_out, Cout):
//   dFeats[idx[k, i]] += g[i] @ W[k]^T          (dfeats entry)
//   dW[k]             += feats[idx[k, i]]^T g[i] (dw entry)
// over every (k, i) whose idx is a real row (not the pad row V_in) and
// whose output row i is valid (g is masked by out_valid).
//
// Replaces the VJP of the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// gather_conv_kernel.py (_windowed_bwd, which differentiates the XLA
// gather_conv of ops/sparse_conv.py). Contract, identical to the plain
// version detection_3d_tpu_torch/ops/sparse_conv.py:gather_conv_backward:
//   feats (V_in, Cin), g (V_out, Cout) and W (K, Cin, Cout) in one type
//   (f32 or bf16), idx (K, V_out) int32, out_valid (V_out,) bool. Sums
//   are kept in f32; the results come out in the feats / W type. The pad
//   row's gradient is dropped.
//
// What bounds it on an H100: like the forward, 2*Cin*Cout flops per real
// (k, i) entry against random row reads. At scale 0 a submanifold book
// holds about 1.2 real entries per site out of 27, so the work is in
// finding the real entries and skipping the rest.
//
// Design (simple first version, no tensor cores):
//  * dfeats: one block of 256 threads owns a BM x BN tile of (output rows
//    x Cin) and loops over the K offsets, skipping an offset when every
//    row of the tile reads the pad row. It forms g_tile @ W[k]^T with f32
//    sums (Cout in chunks of 16 through shared memory) and adds each row
//    of the product to an f32 scratch dFeats[idx[k, i]] with atomicAdd.
//    For a fixed k the books of this package map distinct outputs to
//    distinct inputs, so atomics collide only across offsets.
//  * dw: one block per (offset k, 64 x 64 tile of Cin x Cout, chunk of
//    output rows). It walks its chunk 16 rows at a time, skips a group of
//    rows that all read the pad row, gathers the feats rows and g rows of
//    the group into shared memory and keeps the tile's sums in f32
//    registers; at the end it adds the tile into an f32 scratch dW with
//    atomicAdd (one add per entry per chunk).
//  * a last pass casts the f32 scratch to the bf16 result; for f32 the
//    scratch is the result.
// Atomics add in an order that changes from run to run, so results agree
// with the plain version to f32 rounding, not bit for bit. The kernels
// allocate nothing and launch on the caller's stream; the scratch comes
// zeroed from the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 x 16 threads; thread (tx, ty) owns tile rows ty*TM.. and Cin columns
// tx*TN..
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
dfeats_kernel(const T* __restrict__ g, const int* __restrict__ idx,
              const T* __restrict__ w, const uint8_t* __restrict__ out_valid,
              float* __restrict__ d_in, int v_in, int v_out, int n_off,
              int cin, int cout) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  __shared__ float a_s[BK][BM + 1];  // g rows, Cout-major
  __shared__ float b_s[BK][BN];      // W[k]^T chunk: [n][c]
  __shared__ int rows_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;

  for (int k = 0; k < n_off; ++k) {
    int any = 0;
    for (int r = tid; r < BM; r += kThreads) {
      const int m = m0 + r;
      int dst = v_in;
      if (m < v_out && out_valid[m]) dst = idx[(size_t)k * v_out + m];
      rows_s[r] = dst;
      any |= (dst >= 0 && dst < v_in);
    }
    // every row of this tile reads the pad row at offset k: no gradient
    if (!__syncthreads_or(any)) continue;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int n0 = 0; n0 < cout; n0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK;
        const int n = e % BK;
        const int dst = rows_s[r];
        float v = 0.f;
        if (dst >= 0 && dst < v_in && n0 + n < cout)
          v = to_f32(g[(size_t)(m0 + r) * cout + n0 + n]);
        a_s[n][r] = v;
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int c = e / BK;
        const int n = e % BK;
        float v = 0.f;
        if (c0 + c < cin && n0 + n < cout)
          v = to_f32(w[((size_t)k * cin + c0 + c) * cout + n0 + n]);
        b_s[n][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < BK; ++n) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_s[n][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = b_s[n][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int dst = rows_s[ty * TM + i];
      if (dst < 0 || dst >= v_in) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + tx * TN + j;
        if (c < cin) atomicAdd(&d_in[(size_t)dst * cin + c], acc[i][j]);
      }
    }
    // rows_s is rewritten by the next offset
    __syncthreads();
  }
}

// dW tile: 64 (Cin) x 64 (Cout), 16 x 16 threads of 4 x 4 sums each
constexpr int DW_T = 64;
constexpr int DW_R = 16;    // output rows per step through the chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ feats, const T* __restrict__ g,
          const int* __restrict__ idx, const uint8_t* __restrict__ out_valid,
          float* __restrict__ d_w, int v_in, int v_out, int n_off, int cin,
          int cout, int chunk, int tiles_n) {
  __shared__ float a_s[DW_R][DW_T];   // gathered feats rows
  __shared__ float b_s[DW_R][DW_T];   // g rows
  __shared__ int rows_s[DW_R];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k = blockIdx.z;
  const int c0 = (blockIdx.y / tiles_n) * DW_T;
  const int n0 = (blockIdx.y % tiles_n) * DW_T;
  const int r_begin = blockIdx.x * chunk;
  const int r_end = min(r_begin + chunk, v_out);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  bool touched = false;

  for (int r0 = r_begin; r0 < r_end; r0 += DW_R) {
    int real = 0;
    if (tid < DW_R) {
      const int m = r0 + tid;
      int src = v_in;
      if (m < r_end && out_valid[m]) src = idx[(size_t)k * v_out + m];
      rows_s[tid] = src;
      real = (src >= 0 && src < v_in);
    }
    // every row of this group reads the pad row at offset k: skip it
    if (!__syncthreads_or(real)) continue;
    touched = true;
    for (int e = tid; e < DW_R * DW_T; e += kThreads) {
      const int r = e / DW_T;
      const int c = e % DW_T;
      const int src = rows_s[r];
      const bool ok = src >= 0 && src < v_in;
      float fa = 0.f, fb = 0.f;
      if (ok && c0 + c < cin) fa = to_f32(feats[(size_t)src * cin + c0 + c]);
      if (ok && n0 + c < cout)
        fb = to_f32(g[(size_t)(r0 + r) * cout + n0 + c]);
      a_s[r][c] = fa;
      b_s[r][c] = fb;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < DW_R; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  if (!touched) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < cout)
        atomicAdd(&d_w[((size_t)k * cin + c) * cout + n], acc[i][j]);
    }
  }
}

__global__ void cast_kernel(const float* __restrict__ src,
                            __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

int cast_to(const float* scratch, void* out, size_t n, bool to_bf16,
            cudaStream_t s) {
  if (!to_bf16 || n == 0) return static_cast<int>(cudaGetLastError());
  const size_t want = (n + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  cast_kernel<<<blocks, 256, 0, s>>>(scratch,
                                     static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TM, int TN>
void launch_dfeats(const void* g, const void* idx, const void* w,
                   const void* out_valid, float* scratch, int v_in,
                   int v_out, int n_off, int cin, int cout,
                   cudaStream_t s) {
  dim3 grid((v_out + 16 * TM - 1) / (16 * TM),
            (cin + 16 * TN - 1) / (16 * TN));
  dfeats_kernel<T, TM, TN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const int*>(idx),
      static_cast<const T*>(w), static_cast<const uint8_t*>(out_valid),
      scratch, v_in, v_out, n_off, cin, cout);
}

template <typename T>
int dfeats(const void* g, const void* idx, const void* w,
           const void* out_valid, void* scratch, void* d_feats, int v_in,
           int v_out, int n_off, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(scratch);
  // narrow inputs take a tall 128 x 32 tile, wide ones a 64 x 64 tile
  if (cin <= 32)
    launch_dfeats<T, 8, 2>(g, idx, w, out_valid, acc, v_in, v_out, n_off,
                           cin, cout, s);
  else
    launch_dfeats<T, 4, 4>(g, idx, w, out_valid, acc, v_in, v_out, n_off,
                           cin, cout, s);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return cast_to(acc, d_feats, (size_t)v_in * cin,
                 sizeof(T) == 2 && d_feats != scratch, s);
}

template <typename T>
int dw(const void* feats, const void* g, const void* idx,
       const void* out_valid, void* scratch, void* d_w, int v_in, int v_out,
       int n_off, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_c = (cin + DW_T - 1) / DW_T;
  const int tiles_n = (cout + DW_T - 1) / DW_T;
  // about 2048 blocks in all: enough to fill 132 SMs several times over,
  // few enough that each dW entry takes a few dozen atomic adds
  int per_k = 2048 / (n_off * tiles_c * tiles_n);
  if (per_k < 1) per_k = 1;
  int chunk = (v_out + per_k - 1) / per_k;
  chunk = ((chunk + DW_R - 1) / DW_R) * DW_R;
  if (chunk < DW_R) chunk = DW_R;
  dim3 grid((v_out + chunk - 1) / chunk, tiles_c * tiles_n, n_off);
  float* acc = static_cast<float*>(scratch);
  dw_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g),
      static_cast<const int*>(idx), static_cast<const uint8_t*>(out_valid),
      acc, v_in, v_out, n_off, cin, cout, chunk, tiles_n);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return cast_to(acc, d_w, (size_t)n_off * cin * cout,
                 sizeof(T) == 2 && d_w != scratch, s);
}

}  // namespace

extern "C" int gather_conv_dfeats_f32(const void* g, const void* idx,
                                      const void* w, const void* out_valid,
                                      void* scratch, void* d_feats, int v_in,
                                      int v_out, int n_off, int cin,
                                      int cout, void* stream) {
  return dfeats<float>(g, idx, w, out_valid, scratch, d_feats, v_in, v_out,
                       n_off, cin, cout, stream);
}

extern "C" int gather_conv_dfeats_bf16(const void* g, const void* idx,
                                       const void* w, const void* out_valid,
                                       void* scratch, void* d_feats,
                                       int v_in, int v_out, int n_off,
                                       int cin, int cout, void* stream) {
  return dfeats<__nv_bfloat16>(g, idx, w, out_valid, scratch, d_feats, v_in,
                               v_out, n_off, cin, cout, stream);
}

extern "C" int gather_conv_dw_f32(const void* feats, const void* g,
                                  const void* idx, const void* out_valid,
                                  void* scratch, void* d_w, int v_in,
                                  int v_out, int n_off, int cin, int cout,
                                  void* stream) {
  return dw<float>(feats, g, idx, out_valid, scratch, d_w, v_in, v_out,
                   n_off, cin, cout, stream);
}

extern "C" int gather_conv_dw_bf16(const void* feats, const void* g,
                                   const void* idx, const void* out_valid,
                                   void* scratch, void* d_w, int v_in,
                                   int v_out, int n_off, int cin, int cout,
                                   void* stream) {
  return dw<__nv_bfloat16>(feats, g, idx, out_valid, scratch, d_w, v_in,
                           v_out, n_off, cin, cout, stream);
}

extern "C" const char* gather_conv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
