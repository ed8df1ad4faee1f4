// Sparse-convolution forward: out[i] = sum_k feats[idx[k, i]] @ W[k].
//
// Replaces the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// gather_conv_kernel.py (_kernel / _windowed_conv_call, reached through
// windowed_gather_conv). Contract, identical to the plain version
// detection_3d_tpu_torch/ops/sparse_conv.py:gather_conv_plain:
//   feats (V_in, Cin) f32 or bf16, idx (K, V_out) int32 with idx == V_in
//   reading a zero row, W (K, Cin, Cout) in the feats type, out_valid
//   (V_out,) bool. Rows whose out_valid is false are written as zero.
//   Sums are kept in f32; the output is in the feats type.
//
// What bounds it on an H100: at the main path's widths (Cin, Cout 9..256)
// the work per gathered row is 2*Cin*Cout flops against Cin*2..4 bytes,
// so the large-width convs are bound by operations and the narrow ones
// (scale 0, 32 channels) by the random row reads. The TPU kernel's
// windows, one-hot MXU gathers and 128-lane grouped rows exist because a
// TPU reads random rows badly; a GPU reads them through L1/L2 at sector
// granularity, so none of that is carried over.
//
// Design (simple first version, no tensor cores): one block of 256
// threads owns a BM x BN tile of (output rows x Cout) and loops over the
// K offsets. For each offset it loads the tile's BM rulebook entries into
// shared memory and skips the offset when every entry is the pad row
// (BEV and strided rulebooks are mostly pad). It then walks Cin in
// chunks of BK: the gathered rows (converted to f32) and the W[k] chunk
// go to shared memory with coalesced loads, and each thread accumulates
// a TM x TN micro-tile in f32 registers. Rows whose out_valid is false
// gather nothing. The kernel allocates nothing and launches on the
// caller's stream.

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
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 x 16 threads; thread (tx, ty) owns rows ty*TM.. and cols tx*TN..
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
gather_conv_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                   const T* __restrict__ w,
                   const uint8_t* __restrict__ out_valid,
                   T* __restrict__ out, int v_in, int v_out, int n_off,
                   int cin, int cout) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  __shared__ float a_s[BK][BM + 1];  // gathered rows, channel-major
  __shared__ float b_s[BK][BN];      // W[k] chunk
  __shared__ int rows_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < n_off; ++k) {
    int any = 0;
    for (int r = tid; r < BM; r += kThreads) {
      const int m = m0 + r;
      int src = v_in;
      if (m < v_out && out_valid[m]) src = idx[(size_t)k * v_out + m];
      rows_s[r] = src;
      any |= (src >= 0 && src < v_in);
    }
    // every row of this tile reads the pad row at offset k: nothing to add
    if (!__syncthreads_or(any)) continue;

    for (int c0 = 0; c0 < cin; c0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK;
        const int c = e % BK;
        const int src = rows_s[r];
        float v = 0.f;
        if (src >= 0 && src < v_in && c0 + c < cin)
          v = to_f32(feats[(size_t)src * cin + c0 + c]);
        a_s[c][r] = v;
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int c = e / BN;
        const int n = e % BN;
        float v = 0.f;
        if (c0 + c < cin && n0 + n < cout)
          v = to_f32(w[((size_t)k * cin + c0 + c) * cout + n0 + n]);
        b_s[c][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < BK; ++c) {
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
    const int m = m0 + ty * TM + i;
    if (m >= v_out) continue;
    const bool ok = out_valid[m] != 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < cout) out[(size_t)m * cout + n] = from_f32<T>(ok ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, int TM, int TN>
void launch(const void* feats, const void* idx, const void* w,
            const void* out_valid, void* out, int v_in, int v_out,
            int n_off, int cin, int cout, cudaStream_t stream) {
  dim3 grid((v_out + 16 * TM - 1) / (16 * TM),
            (cout + 16 * TN - 1) / (16 * TN));
  gather_conv_kernel<T, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(idx),
      static_cast<const T*>(w), static_cast<const uint8_t*>(out_valid),
      static_cast<T*>(out), v_in, v_out, n_off, cin, cout);
}

template <typename T>
int gather_conv(const void* feats, const void* idx, const void* w,
                const void* out_valid, void* out, int v_in, int v_out,
                int n_off, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // narrow outputs take a tall 128 x 32 tile, wide ones a 64 x 64 tile
  if (cout <= 32)
    launch<T, 8, 2>(feats, idx, w, out_valid, out, v_in, v_out, n_off, cin,
                    cout, s);
  else
    launch<T, 4, 4>(feats, idx, w, out_valid, out, v_in, v_out, n_off, cin,
                    cout, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_conv_f32(const void* feats, const void* idx,
                               const void* w, const void* out_valid,
                               void* out, int v_in, int v_out, int n_off,
                               int cin, int cout, void* stream) {
  return gather_conv<float>(feats, idx, w, out_valid, out, v_in, v_out,
                            n_off, cin, cout, stream);
}

extern "C" int gather_conv_bf16(const void* feats, const void* idx,
                                const void* w, const void* out_valid,
                                void* out, int v_in, int v_out, int n_off,
                                int cin, int cout, void* stream) {
  return gather_conv<__nv_bfloat16>(feats, idx, w, out_valid, out, v_in,
                                    v_out, n_off, cin, cout, stream);
}

extern "C" const char* gather_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
