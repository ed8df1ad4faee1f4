// Masked batch norm + leaky ReLU over the valid rows of (B, V, C) rows,
// forward and backward:
//   forward   masked_bn_stats_rows   each chunk of rows' (n, sum x,
//                                    sum x^2), a (b, channel) at a time
//             masked_bn_stats_fold   the chunks' partials summed in order
//             masked_bn_normalise    (x - mean) * (inv * scale) + bias,
//                                    the leaky slope, zero on invalid rows
//   backward  masked_bn_dsums_rows   each chunk's (sum dy, sum dy * xhat),
//                                    dy the output's gradient through the
//                                    slope, xhat = (x - mean) * inv
//             masked_bn_dsums_fold   the same fold, and the sum over b
//                                    (the scale's and bias's gradients)
//             masked_bn_dx           scale * inv / n * (n dy - sum dy
//                                    - half * xhat * sum(dy xhat))
//
// Replaces no Pallas kernel: the JAX package leaves its masked BN
// (detection_3d_tpu/ops/norm.py) to XLA, which fuses it. In the port the
// plain version took some thirty launches a call and moved ~118 bytes
// per bf16 element. Contract, that of the plain version
// detection_3d_tpu_torch/ops/norm.py (batch_norm_leaky_relu_plain, and
// the closed-form backward batch_norm_leaky_relu_backward_plain): x and
// the output's gradient in one type (f32 or bf16), valid (B, V) bytes,
// scale and bias (C,) f32. Statistics over each b's valid rows in f32:
// n clamped at 1, var = s2 / n - mean^2 clamped at 0, inv = 1 / sqrt(var
// + eps); the variance's gradient passes where s2 / n - mean^2 > 0, half
// of it at 0, none below (torch.maximum's rule). Invalid rows come out
// zero, forward and backward; rows whose mask is false are never read.
//
// What bounds it on an H100: bytes. Per element of a valid row the
// forward reads x twice and writes the output, the backward reads x and
// the gradient twice and writes dx: 8 elements against the 5 that a
// single pass each way would need (a pass cannot both sum a channel over
// every row and use that sum). An invalid row costs one written element
// each way.
//
// Design:
//  * A block covers a tile of channels: thread t takes the W channels of
//    vector group t % gt (W = 8 bf16 or 4 f32 in one 16-byte access when
//    C is a multiple of W and the rows are aligned, else W = 1) and every
//    R-th row from row lane t / gt (R = 256 / gt), 8 rows in flight (4
//    in the backward, two tensors a row) kept packed as loaded, and the
//    next group's mask bytes read beside them; registers capped for 2
//    blocks an SM (a cap of 3 spilled to the stack and ran slower).
//  * The sums run in a fixed order that depends on V and C alone, never
//    on B: chunks of `chunk` rows (the wrapper's choice from V), in each
//    chunk a thread's rows in order, then a fixed tree over the row lanes
//    in shared memory, then a second kernel sums each b's chunks in order
//    (32 lanes strided over the chunks, then a tree of the lanes). No
//    atomics: the same inputs give the same bits on every call, and a
//    building the same bits alone as in a unit.
//  * The statistics go between the two stages as sums, so that the
//    wrapper can all-reduce them over a process group; each later kernel
//    takes mean and inv from the sums itself, with the plain version's
//    roundings (no contracted multiply-adds in the elementwise steps).
// The kernels allocate nothing, read no host memory and launch on the
// caller's stream, so a CUDA graph can capture them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;  // rows a thread writes (normalise, dx)
constexpr int kMaxW = 8;
constexpr int kFoldWidth = 8;       // sums a fold block writes
constexpr int kFoldLanes = kThreads / kFoldWidth;

// ---- W consecutive channels of one row --------------------------------

// One row's W channels as they are loaded (one 16-byte access when W > 1),
// kept packed until they are used, so a thread holds 8 rows in flight in
// 4 registers each.
template <typename T, int W>
struct Packed;
template <>
struct Packed<float, 4> {
  using type = float4;
};
template <>
struct Packed<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Packed<float, 1> {
  using type = float;
};
template <>
struct Packed<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
};

template <typename T, int W>
__device__ __forceinline__ typename Packed<T, W>::type load_packed(
    const T* p) {
  return *reinterpret_cast<const typename Packed<T, W>::type*>(p);
}

__device__ __forceinline__ void unpack(const float4& t, float* v) {
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void unpack(const uint4& t, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(float t, float* v) { v[0] = t; }

__device__ __forceinline__ void unpack(__nv_bfloat16 t, float* v) {
  v[0] = __bfloat162float(t);
}

template <int W>
__device__ __forceinline__ void store_w(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = v[i];
  }
}

template <int W>
__device__ __forceinline__ void store_w(__nv_bfloat16* p, const float* v) {
  if constexpr (W == 8) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// ---- threads over rows and channels --------------------------------------

// gt vector groups of W channels a block (channel tile blockIdx.z), R row
// lanes; threads past R * gt, or past the channels, are idle.
struct Lanes {
  int gt, rows, g, lane, c0;
  bool active;
};

template <int W>
__device__ __forceinline__ Lanes lanes(int C) {
  Lanes l;
  l.gt = min(C / W, kThreads);
  l.rows = kThreads / l.gt;
  l.g = threadIdx.x % l.gt;
  l.lane = threadIdx.x / l.gt;
  l.c0 = (blockIdx.z * l.gt + l.g) * W;
  l.active = l.lane < l.rows && l.c0 < C;
  return l;
}

// ---- statistics from the sums (n, s1[C], s2[C]) ---------------------------

struct Moments {
  float n, mean, inv, half;
};

__device__ __forceinline__ Moments moments(const float* __restrict__ sums,
                                           int C, int c, float eps) {
  Moments m;
  m.n = fmaxf(sums[0], 1.0f);
  m.mean = __fdiv_rn(sums[1 + c], m.n);
  const float v0 = __fsub_rn(__fdiv_rn(sums[1 + C + c], m.n),
                             __fmul_rn(m.mean, m.mean));
  const float var = v0 < 0.0f ? 0.0f : v0;   // NaN stays NaN
  m.inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  m.half = v0 < 0.0f ? 0.0f : (v0 == 0.0f ? 0.5f : 1.0f);
  return m;
}

// The coefficients of W channels: mean, a = inv * scale, bias, inv.
template <int W>
struct Coef {
  float mean[W], a[W], beta[W], inv[W];
};

template <int W>
__device__ __forceinline__ void coefficients(
    const float* __restrict__ sums, const float* __restrict__ scale,
    const float* __restrict__ bias, int C, int c0, float eps, Coef<W>& k) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const Moments m = moments(sums, C, c0 + i, eps);
    k.mean[i] = m.mean;
    k.inv[i] = m.inv;
    k.a[i] = __fmul_rn(m.inv, scale[c0 + i]);
    k.beta[i] = bias[c0 + i];
  }
}

// y = (x - mean) * a + bias, as the plain version rounds it
__device__ __forceinline__ float affine(float x, float mean, float a,
                                        float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), a), beta);
}

// ---- the fixed tree over a block's row lanes ------------------------------

// red[q][lane * gt * W + g * W + i] holds row lane `lane`'s sums; after
// the tree lane 0's slots hold the block's. Every thread of the block
// calls it.
template <int W, int Q>
__device__ __forceinline__ void lane_tree(float (*red)[kThreads * kMaxW],
                                          int* cnt, const Lanes& l) {
  int top = 1;
  while (top < l.rows) top <<= 1;
  const int base = (l.lane * l.gt + l.g) * W;
  for (int s = top >> 1; s > 0; s >>= 1) {
    __syncthreads();
    if (l.lane < s && l.lane + s < l.rows) {
      const int o = base + s * l.gt * W;
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int i = 0; i < W; ++i) red[q][base + i] += red[q][o + i];
      if (cnt != nullptr && l.g == 0) cnt[l.lane] += cnt[l.lane + s];
    }
  }
  __syncthreads();
}

// ---- a thread's rows, U at a time ----------------------------------------

// The mask bytes of rows r, r + step, ..., r + (U - 1) step below row1.
// Each loop over a thread's rows reads the next group's bytes while the
// current group's rows are in flight, so a group costs one round trip to
// memory and not two.
template <int U>
__device__ __forceinline__ void mask_bytes(const uint8_t* __restrict__ vb,
                                           int r, int step, int row1,
                                           bool* ok) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int rr = r + u * step;
    ok[u] = rr < row1 && vb[rr] != 0;
  }
}

// ---- forward: statistics --------------------------------------------------

constexpr int kStatsU = 8;

// grid (J chunks, B, channel tiles); part (B, J, 2C + 1)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) masked_bn_stats_rows(
    const T* __restrict__ x, const uint8_t* __restrict__ valid,
    float* __restrict__ part, int V, int C, int chunk, int J) {
  constexpr int U = kStatsU;
  __shared__ float red[2][kThreads * kMaxW];
  __shared__ int cnt_s[kThreads];
  const Lanes l = lanes<W>(C);
  const int j = blockIdx.x, b = blockIdx.y;
  const int row1 = min((j + 1) * chunk, V);
  float s1[W], s2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s1[i] = s2[i] = 0.0f;
  int cnt = 0;
  if (l.active) {
    const T* xb = x + (size_t)b * V * C + l.c0;
    const uint8_t* vb = valid + (size_t)b * V;
    const int step = U * l.rows;
    bool next[U];
    mask_bytes<U>(vb, j * chunk + l.lane, l.rows, row1, next);
    for (int r = j * chunk + l.lane; r < row1; r += step) {
      bool ok[U];
      typename Packed<T, W>::type raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = next[u];
        if (ok[u])
          raw[u] = load_packed<T, W>(xb + (size_t)(r + u * l.rows) * C);
      }
      mask_bytes<U>(vb, r + step, l.rows, row1, next);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        ++cnt;
        float v[W];
        unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          s1[i] += v[i];
          s2[i] = fmaf(v[i], v[i], s2[i]);
        }
      }
    }
  }
  const int base = (l.lane * l.gt + l.g) * W;
  if (l.lane < l.rows) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      red[0][base + i] = s1[i];
      red[1][base + i] = s2[i];
    }
    if (l.g == 0) cnt_s[l.lane] = cnt;
  }
  lane_tree<W, 2>(red, cnt_s, l);
  if (l.lane == 0 && l.active) {
    float* p = part + ((size_t)b * J + j) * (2 * C + 1);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      p[1 + l.c0 + i] = red[0][base + i];
      p[1 + C + l.c0 + i] = red[1][base + i];
    }
    if (l.g == 0 && blockIdx.z == 0) p[0] = (float)cnt_s[0];
  }
}

// sums[b, k] = sum over j of part[b, j, k] in a fixed order (32 lanes,
// lane l summing chunks l, l + 32, ... in order, then a tree of the
// lanes); with total, the block walks every b and total[k] = sum over b
// of sums[b, k] in order of b.
__device__ __forceinline__ void fold(const float* __restrict__ part,
                                     float* __restrict__ sums,
                                     float* __restrict__ total, int B, int J,
                                     int K) {
  __shared__ float red[kFoldLanes][kFoldWidth];
  const int kk = threadIdx.x % kFoldWidth, lane = threadIdx.x / kFoldWidth;
  const int k = blockIdx.x * kFoldWidth + kk;
  const int b0 = total != nullptr ? 0 : blockIdx.y;
  const int b1 = total != nullptr ? B : b0 + 1;
  float tot = 0.0f;
  for (int b = b0; b < b1; ++b) {
    float acc = 0.0f;
    if (k < K) {
      const float* p = part + (size_t)b * J * K + k;
#pragma unroll 16
      for (int j = lane; j < J; j += kFoldLanes) acc += p[(size_t)j * K];
    }
    red[lane][kk] = acc;
    for (int s = kFoldLanes / 2; s > 0; s >>= 1) {
      __syncthreads();
      if (lane < s) red[lane][kk] += red[lane + s][kk];
    }
    __syncthreads();
    if (lane == 0 && k < K) {
      sums[(size_t)b * K + k] = red[0][kk];
      tot += red[0][kk];
    }
    __syncthreads();
  }
  if (total != nullptr && lane == 0 && k < K) total[k] = tot;
}

// grid (ceil(K / 8), B)
__global__ void __launch_bounds__(kThreads) masked_bn_stats_fold(
    const float* __restrict__ part, float* __restrict__ sums, int J, int K) {
  fold(part, sums, nullptr, 0, J, K);
}

// grid (ceil(K / 8), 1)
__global__ void __launch_bounds__(kThreads) masked_bn_dsums_fold(
    const float* __restrict__ part, float* __restrict__ sums,
    float* __restrict__ total, int B, int J, int K) {
  fold(part, sums, total, B, J, K);
}

// ---- forward: normalise, activate, mask ----------------------------------

constexpr int kNormU = 8;

// grid (ceil(V / (16 R)), B, channel tiles)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) masked_bn_normalise(
    const T* __restrict__ x, const uint8_t* __restrict__ valid,
    const float* __restrict__ sums, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int V, int C,
    float leak, float eps) {
  constexpr int U = kNormU;
  const Lanes l = lanes<W>(C);
  if (!l.active) return;
  const int b = blockIdx.y;
  const int per = kRowsPerThread * l.rows;
  const int row0 = blockIdx.x * per + l.lane, row1 = min(row0 - l.lane + per,
                                                         V);
  const size_t base = (size_t)b * V;
  const int step = U * l.rows;
  bool next[U];
  mask_bytes<U>(valid + base, row0, l.rows, row1, next);
  Coef<W> k;
  coefficients<W>(sums + (size_t)b * (2 * C + 1), scale, bias, C, l.c0, eps,
                  k);
  for (int r = row0; r < row1; r += step) {
    bool ok[U];
    typename Packed<T, W>::type raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = next[u];
      if (ok[u])
        raw[u] = load_packed<T, W>(x + (base + r + u * l.rows) * C + l.c0);
    }
    mask_bytes<U>(valid + base, r + step, l.rows, row1, next);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * l.rows >= row1) continue;
      float v[W], y[W];
      if (ok[u]) unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (ok[u]) {
          const float t = affine(v[i], k.mean[i], k.a[i], k.beta[i]);
          y[i] = t > 0.0f ? t : __fmul_rn(t, leak);
        } else {
          y[i] = 0.0f;
        }
      }
      store_w<W>(out + (base + r + u * l.rows) * C + l.c0, y);
    }
  }
}

// ---- backward -------------------------------------------------------------

constexpr int kGradU = 4;

// the gradient through the slope and the mask's valid side, and xhat
template <int W>
__device__ __forceinline__ void dy_xhat(const float* x, const float* dz,
                                        const Coef<W>& k, float leak,
                                        float* dy, float* xh) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float t = affine(x[i], k.mean[i], k.a[i], k.beta[i]);
    dy[i] = t > 0.0f ? dz[i] : __fmul_rn(dz[i], leak);
    xh[i] = __fmul_rn(__fsub_rn(x[i], k.mean[i]), k.inv[i]);
  }
}

// grid (J chunks, B, channel tiles); part (B, J, 2C): sum dy, sum dy xhat
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) masked_bn_dsums_rows(
    const T* __restrict__ x, const T* __restrict__ dz,
    const uint8_t* __restrict__ valid, const float* __restrict__ sums,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ part, int V, int C, int chunk, int J, float leak,
    float eps) {
  constexpr int U = kGradU;
  __shared__ float red[2][kThreads * kMaxW];
  const Lanes l = lanes<W>(C);
  const int j = blockIdx.x, b = blockIdx.y;
  const int row1 = min((j + 1) * chunk, V);
  float s1[W], s2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s1[i] = s2[i] = 0.0f;
  if (l.active) {
    const size_t off = (size_t)b * V * C + l.c0;
    const uint8_t* vb = valid + (size_t)b * V;
    const int step = U * l.rows;
    bool next[U];
    mask_bytes<U>(vb, j * chunk + l.lane, l.rows, row1, next);
    Coef<W> k;
    coefficients<W>(sums + (size_t)b * (2 * C + 1), scale, bias, C, l.c0,
                    eps, k);
    for (int r = j * chunk + l.lane; r < row1; r += step) {
      bool ok[U];
      typename Packed<T, W>::type xr[U], gr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = next[u];
        if (!ok[u]) continue;
        const size_t at = off + (size_t)(r + u * l.rows) * C;
        xr[u] = load_packed<T, W>(x + at);
        gr[u] = load_packed<T, W>(dz + at);
      }
      mask_bytes<U>(vb, r + step, l.rows, row1, next);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        float xv[W], gv[W], dy[W], xh[W];
        unpack(xr[u], xv);
        unpack(gr[u], gv);
        dy_xhat<W>(xv, gv, k, leak, dy, xh);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          s1[i] += dy[i];
          s2[i] = fmaf(dy[i], xh[i], s2[i]);
        }
      }
    }
  }
  const int base = (l.lane * l.gt + l.g) * W;
  if (l.lane < l.rows) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      red[0][base + i] = s1[i];
      red[1][base + i] = s2[i];
    }
  }
  lane_tree<W, 2>(red, nullptr, l);
  if (l.lane == 0 && l.active) {
    float* p = part + ((size_t)b * J + j) * (2 * C);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      p[l.c0 + i] = red[0][base + i];
      p[C + l.c0 + i] = red[1][base + i];
    }
  }
}

// grid (ceil(V / (16 R)), B, channel tiles); gsums (B, 2C)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) masked_bn_dx(
    const T* __restrict__ x, const T* __restrict__ dz,
    const uint8_t* __restrict__ valid, const float* __restrict__ sums,
    const float* __restrict__ gsums, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ dx, int V, int C,
    float leak, float eps) {
  constexpr int U = kGradU;
  const Lanes l = lanes<W>(C);
  if (!l.active) return;
  const int b = blockIdx.y;
  const int per = kRowsPerThread * l.rows;
  const int row0 = blockIdx.x * per + l.lane, row1 = min(row0 - l.lane + per,
                                                         V);
  const size_t base = (size_t)b * V;
  const int step = U * l.rows;
  bool next[U];
  mask_bytes<U>(valid + base, row0, l.rows, row1, next);
  const float* sb = sums + (size_t)b * (2 * C + 1);
  const float* gb = gsums + (size_t)b * (2 * C);
  Coef<W> k;
  coefficients<W>(sb, scale, bias, C, l.c0, eps, k);
  const float n = fmaxf(sb[0], 1.0f);
  float coef[W], g1[W], g2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int c = l.c0 + i;
    coef[i] = __fdiv_rn(__fmul_rn(scale[c], k.inv[i]), n);
    g1[i] = gb[c];
    // half is 0, 1/2 or 1: (half * xhat) * s2 == xhat * (half * s2)
    g2[i] = __fmul_rn(moments(sb, C, c, eps).half, gb[C + c]);
  }
  for (int r = row0; r < row1; r += step) {
    bool ok[U];
    typename Packed<T, W>::type xr[U], gr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = next[u];
      if (!ok[u]) continue;
      const size_t at = (base + r + u * l.rows) * C + l.c0;
      xr[u] = load_packed<T, W>(x + at);
      gr[u] = load_packed<T, W>(dz + at);
    }
    mask_bytes<U>(valid + base, r + step, l.rows, row1, next);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * l.rows >= row1) continue;
      float d[W];
      if (ok[u]) {
        float xv[W], gv[W], dy[W], xh[W];
        unpack(xr[u], xv);
        unpack(gr[u], gv);
        dy_xhat<W>(xv, gv, k, leak, dy, xh);
#pragma unroll
        for (int i = 0; i < W; ++i)
          d[i] = __fmul_rn(coef[i],
                           __fsub_rn(__fsub_rn(__fmul_rn(n, dy[i]), g1[i]),
                                     __fmul_rn(xh[i], g2[i])));
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) d[i] = 0.0f;
      }
      store_w<W>(dx + (base + r + u * l.rows) * C + l.c0, d);
    }
  }
}

// ---- launches -------------------------------------------------------------

struct Shape {
  int groups, gt, rows, tiles;
};

template <int W>
Shape shape_of(int C) {
  Shape s;
  s.groups = C / W;
  s.gt = s.groups < kThreads ? s.groups : kThreads;
  s.rows = kThreads / s.gt;
  s.tiles = (s.groups + s.gt - 1) / s.gt;
  return s;
}

int fold_blocks(int K) { return (K + kFoldWidth - 1) / kFoldWidth; }

int row_blocks(int V, int rows) {
  const int per = kRowsPerThread * rows;
  return (V + per - 1) / per;
}

template <typename T, int W>
int stats(const void* x, const void* valid, float* part, float* sums, int B,
          int V, int C, int chunk, int J, cudaStream_t st) {
  const Shape s = shape_of<W>(C);
  if (J > 0) {
    masked_bn_stats_rows<T, W><<<dim3(J, B, s.tiles), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(valid), part,
        V, C, chunk, J);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_bn_stats_fold<<<dim3(fold_blocks(2 * C + 1), B), kThreads, 0,
                         st>>>(part, sums, J, 2 * C + 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int normalise(const void* x, const void* valid, const float* sums,
              const float* scale, const float* bias, void* out, int B, int V,
              int C, float leak, float eps, cudaStream_t st) {
  const Shape s = shape_of<W>(C);
  if (V == 0) return 0;
  masked_bn_normalise<T, W>
      <<<dim3(row_blocks(V, s.rows), B, s.tiles), kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const uint8_t*>(valid), sums,
          scale, bias, static_cast<T*>(out), V, C, leak, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int dsums(const void* x, const void* dz, const void* valid, const float* sums,
          const float* scale, const float* bias, float* part, float* gsums,
          float* total, int B, int V, int C, int chunk, int J, float leak,
          float eps, cudaStream_t st) {
  const Shape s = shape_of<W>(C);
  if (J > 0) {
    masked_bn_dsums_rows<T, W><<<dim3(J, B, s.tiles), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dz),
        static_cast<const uint8_t*>(valid), sums, scale, bias, part, V, C,
        chunk, J, leak, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_bn_dsums_fold<<<dim3(fold_blocks(2 * C), 1), kThreads, 0, st>>>(
      part, gsums, total, B, J, 2 * C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int grad_x(const void* x, const void* dz, const void* valid,
           const float* sums, const float* gsums, const float* scale,
           const float* bias, void* dx, int B, int V, int C, float leak,
           float eps, cudaStream_t st) {
  const Shape s = shape_of<W>(C);
  if (V == 0) return 0;
  masked_bn_dx<T, W>
      <<<dim3(row_blocks(V, s.rows), B, s.tiles), kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(dz),
          static_cast<const uint8_t*>(valid), sums, gsums, scale, bias,
          static_cast<T*>(dx), V, C, leak, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points, one a kernel and type. vec != 0: 16-byte accesses (C a
// multiple of 8 in bf16, of 4 in f32, every row tensor 16-byte aligned;
// the wrapper checks), else one channel a thread. sums (B, 2C + 1): n,
// sum x, sum x^2; part a (B, J, 2C + 1) scratch, J = ceil(V / chunk);
// gsums (B, 2C): sum dy, sum dy xhat; total (2C,): gsums summed over b.
// B >= 1 and C >= 1; V may be 0.

#define MASKED_BN_ENTRIES(TAG, T, WV)                                        \
  extern "C" int masked_bn_stats_##TAG(                                      \
      const void* x, const void* valid, void* part, void* sums, int B,      \
      int V, int C, int chunk, int J, int vec, void* stream) {               \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    float* p = static_cast<float*>(part);                                    \
    float* s = static_cast<float*>(sums);                                    \
    return vec ? stats<T, WV>(x, valid, p, s, B, V, C, chunk, J, st)         \
               : stats<T, 1>(x, valid, p, s, B, V, C, chunk, J, st);         \
  }                                                                          \
  extern "C" int masked_bn_normalise_##TAG(                                  \
      const void* x, const void* valid, const void* sums, const void* scale, \
      const void* bias, void* out, int B, int V, int C, int vec, float leak, \
      float eps, void* stream) {                                             \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    const float* s = static_cast<const float*>(sums);                        \
    const float* g = static_cast<const float*>(scale);                       \
    const float* bb = static_cast<const float*>(bias);                       \
    return vec ? normalise<T, WV>(x, valid, s, g, bb, out, B, V, C, leak,    \
                                  eps, st)                                   \
               : normalise<T, 1>(x, valid, s, g, bb, out, B, V, C, leak,     \
                                 eps, st);                                   \
  }                                                                          \
  extern "C" int masked_bn_dsums_##TAG(                                      \
      const void* x, const void* dz, const void* valid, const void* sums,   \
      const void* scale, const void* bias, void* part, void* gsums,          \
      void* total, int B, int V, int C, int chunk, int J, int vec,           \
      float leak, float eps, void* stream) {                                 \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    const float* s = static_cast<const float*>(sums);                        \
    const float* g = static_cast<const float*>(scale);                       \
    const float* bb = static_cast<const float*>(bias);                       \
    float* p = static_cast<float*>(part);                                    \
    float* gs = static_cast<float*>(gsums);                                  \
    float* tot = static_cast<float*>(total);                                 \
    return vec ? dsums<T, WV>(x, dz, valid, s, g, bb, p, gs, tot, B, V, C,   \
                              chunk, J, leak, eps, st)                       \
               : dsums<T, 1>(x, dz, valid, s, g, bb, p, gs, tot, B, V, C,    \
                             chunk, J, leak, eps, st);                       \
  }                                                                          \
  extern "C" int masked_bn_dx_##TAG(                                         \
      const void* x, const void* dz, const void* valid, const void* sums,   \
      const void* gsums, const void* scale, const void* bias, void* dx,      \
      int B, int V, int C, int vec, float leak, float eps, void* stream) {   \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    const float* s = static_cast<const float*>(sums);                        \
    const float* gs = static_cast<const float*>(gsums);                      \
    const float* g = static_cast<const float*>(scale);                       \
    const float* bb = static_cast<const float*>(bias);                       \
    return vec ? grad_x<T, WV>(x, dz, valid, s, gs, g, bb, dx, B, V, C,      \
                               leak, eps, st)                                \
               : grad_x<T, 1>(x, dz, valid, s, gs, g, bb, dx, B, V, C, leak, \
                              eps, st);                                      \
  }

MASKED_BN_ENTRIES(f32, float, 4)
MASKED_BN_ENTRIES(bf16, __nv_bfloat16, 8)

#undef MASKED_BN_ENTRIES

extern "C" const char* masked_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
