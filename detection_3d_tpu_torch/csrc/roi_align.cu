// Rotated 3D ROI align over a sparse voxel table, forward and backward:
//   roi_align_rotated_fwd        each bin of each roi: its sr^3 rotated
//                                sample points, their 8 trilinear corners
//                                looked up in the roi's building's sorted
//                                keys, the found rows weighted and summed
//                                in f32, scaled by 1 / sr^3, written once
//   roi_align_rotated_bwd_pairs  the same lookups, each corner written as
//                                a (row, w / sr^3) pair; the caller orders
//                                them in plain torch: a stable sort by row
//                                and a searchsorted for each row's first
//                                pair (ops/roi_align.roi_align_bwd_cuda)
//   roi_align_rotated_bwd_sum    a warp a table row: w times its bins'
//                                gradient summed over the row's pairs in
//                                the sorted order, in f32, written once
//
// Replaces no Pallas kernel: the JAX package's pooler
// (detection_3d_tpu/ops/roi_align.py) is left to XLA, which fuses it. In
// the port the plain version (detection_3d_tpu_torch/ops/roi_align.py,
// roi_align_plain) takes the corners one at a time: a key search, an
// index_select of every sample's row, a bf16 product and a reduction a
// corner, ~487 launches and ~12.6 GB of device-memory traffic a building
// (R = 1,000 rois of 6 x 8 x 4 bins, sr = 2, C = 128 bf16); its backward
// a bf16 index_add_ a corner. Contract, that of the plain version: rois
// (nb R, 7) f32 standard boxes in voxel units [xc, yc, zc, xs, ys, zs,
// yaw], sizes floored at 1; per axis sample offsets -size/2 + i *
// size/bins + (s + 0.5) * (size/bins) / sr; world = [[cos, -sin], [sin,
// cos]] @ local + center; a sample is in bounds when -1 < p < X (Y, Z),
// then clamped to [0, X - 1], x0 = floor, x1 = min(x0 + 1, X - 1);
// corner (x, y, z) of level b (the roi's level, 0 without a level array)
// has key ((b X + x) << 32) | (y Z + z), searched in the roi's own
// building's keys (ops/coords.key_search); a missing corner adds
// nothing. A roi whose valid byte is 0 writes zeros and reads nothing,
// and takes no gradient. The coordinate steps round as the plain
// version's separate torch ops do (no contracted multiply-adds). The
// plain version rounds each corner's weight and product to the feature
// type; here the weight stays f32 and each product is added exact (a
// fused multiply-add into the f32 sum).
//
// What bounds it on an H100: the output, nb R bins C elements written
// once (49 MB a building in bf16, 15 us at 3.35 TB/s), and the table read
// once (12.6 MB at V = 49,152 rows of 128 bf16). The table sits in the 50
// MB L2, so the true cost is the corner rows read from L2 and L1: 64 rows
// a bin (12.3 M rows, 3.15 GB a building), and the key searches: 32 lower
// bounds a bin of ceil(log2 V) + 1 dependent loads.
//
// Design:
//  * A warp a bin; a block 8 consecutive bins, of one roi as a rule, so
//    the block's rows repeat in L1. Each lane takes one (sample, xy
//    corner) pair (32 = 8 samples x 4 at sr = 2; more rounds of 32 when
//    sr > 2) and searches the lower bound of its z0 key: the z1 corner's
//    key is the next one, so it is the next row or absent, and one search
//    finds both.
//  * The lanes lie across the channels (4 a lane: 8-byte loads in bf16,
//    16-byte in f32; one a lane when C is not a multiple of 4 or a row is
//    not aligned): each found row is read as coalesced loads, 8 rows in
//    flight, and summed in f32 registers in a fixed order (lane j's z0
//    then z1 row, j = 0 .. 31), so a bin's bits depend on its roi, the
//    table and nothing else: a building gives the same bits in a unit as
//    alone, on every call.
//  * The backward has no atomics: the pairs, sorted by row with their
//    slots in order, give each row its contributions in a fixed order, so
//    it is bit-reproducible (torch's deterministic mode holds), and a
//    building's rows take the same bits alone as in a unit. The lookups
//    are made again, so nothing but the rois is kept between the passes.
//    A backward call is thus two kernels here and, between them, plain
//    torch's radix sort of the nb R bins x 2 lookups pairs (3.1 M at 256
//    rois) and a searchsorted over the nb V + 1 rows (chip_smoke.py --roi
//    reads the call's device time whole and the two kernels' part).
// The kernels allocate nothing, read no host memory and launch on the
// caller's stream, so a CUDA graph can capture them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBatch = 4;   // lanes' corner pairs a batch: 8 rows in flight

struct Geometry {
  int R, V, C, os0, os1, os2, sr, X, Y, Z;
  float inv;   // 1 / sr^3, rounded to f32 as the plain version's scalar
};

// ---- W channels of one row -------------------------------------------------

template <typename T, int W>
struct Vec {
  float v[W];
};

__device__ __forceinline__ void load(const float* p, Vec<float, 4>& o) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  o.v[0] = t.x;
  o.v[1] = t.y;
  o.v[2] = t.z;
  o.v[3] = t.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Vec<__nv_bfloat16, 4>& o) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o.v[0] = a.x;
  o.v[1] = a.y;
  o.v[2] = b.x;
  o.v[3] = b.y;
}

__device__ __forceinline__ void load(const float* p, Vec<float, 1>& o) {
  o.v[0] = __ldg(p);
}

__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Vec<__nv_bfloat16, 1>& o) {
  o.v[0] = __bfloat162float(p[0]);
}

template <int W>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (W == 4) {
    uint2 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// ---- one lane's lookup: a sample's two corners at one (x, y) ---------------

struct Pair {
  int row0, row1;   // flat rows b V + i, or -1 when the corner is missing
  float w0, w1;
};

// the local coordinate of sample `sub` of bin `bin` along an axis of
// `size` cut into `bins` bins, in the plain version's roundings
__device__ __forceinline__ float offset(float size, int bins, int bin,
                                        int sub, int sr) {
  const float step = __fdiv_rn(size, static_cast<float>(bins));
  const float a = __fmul_rn(static_cast<float>(bin), step);
  const float c = __fdiv_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(sub), 0.5f), step),
      static_cast<float>(sr));
  return __fadd_rn(__fdiv_rn(-size, 2.0f), __fadd_rn(a, c));
}

// the lower bound of q among keys[0, n)
__device__ __forceinline__ int lower_bound(const long long* __restrict__ keys,
                                           int n, long long q) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(keys + lo + half) < q) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Lookup j of bin (i0, i1, i2) of roi `roi`: sample j / 4, x corner bit 1
// of j % 4, y corner bit 0.
__device__ Pair lookup(const float* __restrict__ rois,
                       const int* __restrict__ level,
                       const long long* __restrict__ keys, const Geometry& g,
                       int roi, int i0, int i1, int i2, int j) {
  const float* r = rois + static_cast<long long>(roi) * 7;
  const int s = j >> 2;
  const int cx = (j >> 1) & 1, cy = j & 1;
  const int sr = g.sr;
  const int s0 = s / (sr * sr), s1 = (s / sr) % sr, s2 = s % sr;
  const float xs = fmaxf(r[3], 1.0f), ys = fmaxf(r[4], 1.0f),
              zs = fmaxf(r[5], 1.0f);
  const float lx = offset(xs, g.os0, i0, s0, sr);
  const float ly = offset(ys, g.os1, i1, s1, sr);
  const float lz = offset(zs, g.os2, i2, s2, sr);
  const float cs = cosf(r[6]), sn = sinf(r[6]);
  const float gx = __fadd_rn(__fsub_rn(__fmul_rn(lx, cs), __fmul_rn(ly, sn)),
                             r[0]);
  const float gy = __fadd_rn(__fadd_rn(__fmul_rn(lx, sn), __fmul_rn(ly, cs)),
                             r[1]);
  const float gz = __fadd_rn(lz, r[2]);
  const bool inb = gx > -1.0f && gx < static_cast<float>(g.X) &&
                   gy > -1.0f && gy < static_cast<float>(g.Y) &&
                   gz > -1.0f && gz < static_cast<float>(g.Z);
  const float px = fminf(fmaxf(gx, 0.0f), static_cast<float>(g.X - 1));
  const float py = fminf(fmaxf(gy, 0.0f), static_cast<float>(g.Y - 1));
  const float pz = fminf(fmaxf(gz, 0.0f), static_cast<float>(g.Z - 1));
  const int x0 = static_cast<int>(floorf(px));
  const int y0 = static_cast<int>(floorf(py));
  const int z0 = static_cast<int>(floorf(pz));
  const float fx = __fsub_rn(px, static_cast<float>(x0));
  const float fy = __fsub_rn(py, static_cast<float>(y0));
  const float fz = __fsub_rn(pz, static_cast<float>(z0));
  const int x = cx ? min(x0 + 1, g.X - 1) : x0;
  const int y = cy ? min(y0 + 1, g.Y - 1) : y0;
  const float wx = cx ? fx : __fsub_rn(1.0f, fx);
  const float wy = cy ? fy : __fsub_rn(1.0f, fy);
  const float wxy = __fmul_rn(wx, wy);
  const float in = inb ? 1.0f : 0.0f;
  Pair p;
  p.w0 = __fmul_rn(__fmul_rn(wxy, __fsub_rn(1.0f, fz)), in);
  p.w1 = __fmul_rn(__fmul_rn(wxy, fz), in);
  p.row0 = p.row1 = -1;
  const int b = level ? level[roi] : 0;
  if (b < 0) return p;
  const int unit = roi / g.R;
  const long long* k = keys + static_cast<long long>(unit) * g.V;
  const long long hi = static_cast<long long>(b) * g.X + x;
  const long long q = (hi << 32) | static_cast<long long>(y * g.Z + z0);
  const int at = lower_bound(k, g.V, q);
  const int base = unit * g.V;
  const bool f0 = at < g.V && __ldg(k + at) == q;
  if (f0) p.row0 = base + at;
  if (z0 + 1 > g.Z - 1) {           // z1 = z0: the same key
    p.row1 = p.row0;
  } else {
    const int at1 = f0 ? at + 1 : at;
    if (at1 < g.V && __ldg(k + at1) == q + 1) p.row1 = base + at1;
  }
  return p;
}

struct Bin {
  int roi, i0, i1, i2;
  long long index;   // the bin's place among the unit's nb R bins
  long long out;     // its first output element
};

__device__ __forceinline__ bool bin_of(const Geometry& g, long long total,
                                       Bin& b) {
  const long long gb =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (gb >= total) return false;
  const int bins = g.os0 * g.os1 * g.os2;
  b.roi = static_cast<int>(gb / bins);
  const int bin = static_cast<int>(gb % bins);
  b.i0 = bin / (g.os1 * g.os2);
  b.i1 = (bin / g.os2) % g.os1;
  b.i2 = bin % g.os2;
  b.index = gb;
  b.out = gb * g.C;
  return true;
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
roi_align_rotated_fwd(const T* __restrict__ feats,
                      const long long* __restrict__ keys,
                      const float* __restrict__ rois,
                      const uint8_t* __restrict__ valid,
                      const int* __restrict__ level, T* __restrict__ out,
                      Geometry g, long long total) {
  Bin bin;
  if (!bin_of(g, total, bin)) return;   // whole warps leave together
  const int lane = threadIdx.x & 31;
  const bool live = valid[bin.roi] != 0;
  const int lookups = 4 * g.sr * g.sr * g.sr;
  for (int base = 0; base < g.C; base += 32 * W) {
    const int c0 = base + lane * W;
    const bool active = c0 < g.C;
    float acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.0f;
    for (int round = 0; live && round < lookups; round += 32) {
      Pair p = {-1, -1, 0.0f, 0.0f};
      if (round + lane < lookups)
        p = lookup(rois, level, keys, g, bin.roi, bin.i0, bin.i1, bin.i2,
                   round + lane);
      const int lanes = min(32, lookups - round);   // a multiple of 4
      for (int j = 0; j < lanes; j += kBatch) {
        int row[2 * kBatch];
        float w[2 * kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          row[2 * u] = __shfl_sync(kFull, p.row0, j + u);
          row[2 * u + 1] = __shfl_sync(kFull, p.row1, j + u);
          w[2 * u] = __shfl_sync(kFull, p.w0, j + u);
          w[2 * u + 1] = __shfl_sync(kFull, p.w1, j + u);
        }
        Vec<T, W> v[2 * kBatch];
#pragma unroll
        for (int u = 0; u < 2 * kBatch; ++u) {
          if (active && row[u] >= 0) {
            load(feats + static_cast<long long>(row[u]) * g.C + c0, v[u]);
          } else {
#pragma unroll
            for (int i = 0; i < W; ++i) v[u].v[i] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < 2 * kBatch; ++u) {
          if (row[u] >= 0) {
#pragma unroll
            for (int i = 0; i < W; ++i)
              acc[i] = __fmaf_rn(w[u], v[u].v[i], acc[i]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = __fmul_rn(acc[i], g.inv);
      store<W>(out + bin.out + c0, acc);
    }
  }
}

// The backward's first pass: each bin's lookups as (row, w / sr^3) pairs,
// slot b L2 + 2 j + z for lookup j's z corner (L2 = 2 lookups a bin); a
// missing corner, and every slot of an invalid roi, takes the row
// `rows`, which sorts after every real row.
__global__ void __launch_bounds__(kThreads)
roi_align_rotated_bwd_pairs(const long long* __restrict__ keys,
                            const float* __restrict__ rois,
                            const uint8_t* __restrict__ valid,
                            const int* __restrict__ level,
                            int* __restrict__ rows_out,
                            float* __restrict__ w_out, Geometry g, int rows,
                            long long total) {
  Bin bin;
  if (!bin_of(g, total, bin)) return;
  const int lane = threadIdx.x & 31;
  const int lookups = 4 * g.sr * g.sr * g.sr;
  const long long base = bin.index * 2 * lookups;
  const bool live = valid[bin.roi] != 0;
  for (int j = lane; j < lookups; j += 32) {
    Pair p = {-1, -1, 0.0f, 0.0f};
    if (live)
      p = lookup(rois, level, keys, g, bin.roi, bin.i0, bin.i1, bin.i2, j);
    rows_out[base + 2 * j] = p.row0 < 0 ? rows : p.row0;
    rows_out[base + 2 * j + 1] = p.row1 < 0 ? rows : p.row1;
    w_out[base + 2 * j] = __fmul_rn(p.w0, g.inv);
    w_out[base + 2 * j + 1] = __fmul_rn(p.w1, g.inv);
  }
}

// The backward's last pass, after the pairs are sorted by row (stable):
// a warp a table row sums w times its bins' gradient over the row's pairs
// [starts[r], starts[r + 1]) in the sorted order, in f32 registers, and
// writes the row once in the type (0 where no pair reaches it).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
roi_align_rotated_bwd_sum(const T* __restrict__ grad,
                          const long long* __restrict__ order,
                          const float* __restrict__ w,
                          const int* __restrict__ starts, T* __restrict__ d,
                          int rows, int C, int slots_per_bin) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int begin = starts[r], end = starts[r + 1];
  for (int base = 0; base < C; base += 32 * W) {
    const int c0 = base + lane * W;
    const bool active = c0 < C;
    float acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.0f;
    for (int k0 = begin; k0 < end; k0 += 32) {
      long long bin = 0;
      float wk = 0.0f;
      if (k0 + lane < end) {
        const long long slot = order[k0 + lane];
        bin = slot / slots_per_bin;
        wk = w[slot];
      }
      const int n = min(32, end - k0);
      for (int j = 0; j < n; j += 2 * kBatch) {
        long long bj[2 * kBatch];
        float wj[2 * kBatch];
#pragma unroll
        for (int u = 0; u < 2 * kBatch; ++u) {
          bj[u] = __shfl_sync(kFull, bin, (j + u) & 31);
          wj[u] = __shfl_sync(kFull, wk, (j + u) & 31);
        }
        Vec<T, W> v[2 * kBatch];
#pragma unroll
        for (int u = 0; u < 2 * kBatch; ++u) {
          if (active && j + u < n) {
            load(grad + bj[u] * C + c0, v[u]);
          } else {
#pragma unroll
            for (int i = 0; i < W; ++i) v[u].v[i] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < 2 * kBatch; ++u) {
          if (j + u < n) {
#pragma unroll
            for (int i = 0; i < W; ++i)
              acc[i] = __fmaf_rn(wj[u], v[u].v[i], acc[i]);
          }
        }
      }
    }
    if (active) store<W>(d + r * C + c0, acc);
  }
}

template <typename T, int W>
int forward(const void* feats, const void* keys, const void* rois,
            const void* valid, const void* level, void* out, int nb,
            const Geometry& g, cudaStream_t st) {
  const long long total =
      static_cast<long long>(nb) * g.R * g.os0 * g.os1 * g.os2;
  if (total == 0 || g.C == 0) return 0;
  roi_align_rotated_fwd<T, W>
      <<<static_cast<unsigned>((total + kWarps - 1) / kWarps), kThreads, 0,
         st>>>(static_cast<const T*>(feats),
               static_cast<const long long*>(keys),
               static_cast<const float*>(rois),
               static_cast<const uint8_t*>(valid),
               static_cast<const int*>(level), static_cast<T*>(out), g,
               total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int backward_sum(const void* grad, const void* order, const void* w,
                 const void* starts, void* d, int rows, int C,
                 int slots_per_bin, cudaStream_t st) {
  if (rows == 0 || C == 0) return 0;
  roi_align_rotated_bwd_sum<T, W>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
          static_cast<const T*>(grad), static_cast<const long long*>(order),
          static_cast<const float*>(w), static_cast<const int*>(starts),
          static_cast<T*>(d), rows, C, slots_per_bin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points. feats (nb V, C) and out (nb R, os0, os1, os2, C) in the
// type; keys (nb, V) int64 sorted a building; rois (nb R, 7) f32; valid
// (nb R) bytes; level (nb R) int32, or null for level 0. vec != 0: 4
// channels a lane (C a multiple of 4, rows aligned to 4 elements; the
// wrapper checks), else one. The backward: roi_align_bwd_pairs writes
// rows_out and w_out (nb R bins x 2 lookups slots each, rows = nb V for
// no row); the caller sorts rows_out (stable) into `order` (slot of each
// sorted pair) and finds each row's first sorted pair `starts` (rows + 1
// entries); roi_align_bwd_sum_* writes d (nb V, C) in the type.

extern "C" int roi_align_bwd_pairs(const void* keys, const void* rois,
                                   const void* valid, const void* level,
                                   void* rows_out, void* w_out, int nb, int R,
                                   int V, int os0, int os1, int os2, int sr,
                                   int X, int Y, int Z, float inv,
                                   void* stream) {
  const Geometry g{R, V, 1, os0, os1, os2, sr, X, Y, Z, inv};
  const long long total = static_cast<long long>(nb) * R * os0 * os1 * os2;
  if (total == 0) return 0;
  roi_align_rotated_bwd_pairs<<<static_cast<unsigned>(
                                    (total + kWarps - 1) / kWarps),
                                kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const float*>(rois),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(level),
      static_cast<int*>(rows_out), static_cast<float*>(w_out), g, nb * V,
      total);
  return static_cast<int>(cudaGetLastError());
}

#define ROI_ALIGN_ENTRIES(TAG, T)                                            \
  extern "C" int roi_align_fwd_##TAG(                                        \
      const void* feats, const void* keys, const void* rois,                 \
      const void* valid, const void* level, void* out, int nb, int R, int V, \
      int C, int os0, int os1, int os2, int sr, int X, int Y, int Z,         \
      float inv, int vec, void* stream) {                                    \
    const Geometry g{R, V, C, os0, os1, os2, sr, X, Y, Z, inv};              \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    return vec ? forward<T, 4>(feats, keys, rois, valid, level, out, nb, g,  \
                               st)                                           \
               : forward<T, 1>(feats, keys, rois, valid, level, out, nb, g,  \
                               st);                                          \
  }                                                                          \
  extern "C" int roi_align_bwd_sum_##TAG(                                    \
      const void* grad, const void* order, const void* w,                    \
      const void* starts, void* d, int rows, int C, int slots_per_bin,       \
      int vec, void* stream) {                                               \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    return vec ? backward_sum<T, 4>(grad, order, w, starts, d, rows, C,      \
                                    slots_per_bin, st)                       \
               : backward_sum<T, 1>(grad, order, w, starts, d, rows, C,      \
                                    slots_per_bin, st);                      \
  }

ROI_ALIGN_ENTRIES(f32, float)
ROI_ALIGN_ENTRIES(bf16, __nv_bfloat16)

#undef ROI_ALIGN_ENTRIES

extern "C" const char* roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
