// Submanifold 3x3x3 rulebook: out[k, i] = row of the neighbour of site i
// at offset k, or V when it is absent, out of the grid, or site i is a
// pad row; masks[i] = the bits k with out[k, i] < V.
//
// Replaces the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// match_kernel.py (_kernel / _match_call, reached through
// neighbor_match_3x3x3). Contract, identical bit for bit to the plain
// versions detection_3d_tpu_torch/ops/sparse.py:neighbor_match_columns
// (this algorithm) and neighbor_indices (one search per offset):
//   keys (V,) int64 sorted table keys ((b*X + x) << 32 | (y*Z + z), pad
//   rows carry the largest key), coords (V, 4) int32 [x, y, z, b],
//   num (1,) int32 active rows; out (27, V) int32, masks (V,) int64 (the
//   row masks of ops/sparse_conv.row_masks). Offset k walks dx outer,
//   dy, dz inner (ops/sparse.submanifold_offsets order).
//   A unit of B buildings (the batched forward) passes B stacked tables:
//   keys (B, V), coords (B, V, 4), num (B,). Grid axis y is the
//   building: block (tile, b) searches table b alone, with its own num
//   and windows, and writes the flat book out (27, B * V) whose entries
//   are global rows (row + b * V) and whose pad is B * V, and masks
//   (B * V,). B = 1 is one building's book.
//
// What bounds it on an H100: the (27, V) int32 output write (56.6 MB at
// V = 524288) and the key reads, ~0.02 ms. A search per (site, offset)
// of ~20 dependent probes over the whole key array waits on L2 latency
// instead: 27 such searches per site took 8x the bound.
//
// Design:
//  * Columns, not offsets. The three dz neighbours of (x+dx, y+dy) have
//    keys q-1, q, q+1 around q = key(x+dx, y+dy, z), so they sit in at
//    most three consecutive rows of the sorted table: one lower-bound
//    search for q-1 gives row p, and each of the three is found by
//    equality among rows p, p+1, p+2. The centre column needs no search:
//    dz = 0 is the site itself, dz = -1/+1 is row i-1/i+1 when its key is
//    the site's key -1/+1. 8 searches per site instead of 26.
//  * Short windows in shared memory (subm_match_windows, a thread per
//    site, 256 sites a block). For a fixed column the queries of a block
//    of consecutive sites are the sites' sorted keys shifted by a
//    constant, so they fall in one window of the table. The columns of
//    one dx share a window (dy shifts lo by at most Z): per block, three
//    windows, each found by two warp-wide searches (32 probes a round,
//    4 dependent loads at V = 524288) and staged into shared memory. A
//    window longer than the budget (an argument, so that a test can
//    force this path) is searched in global memory between its ends
//    instead: the same answers.
//  * Small tables (subm_match_table, budget 0): there the chain of
//    dependent loads that finds and stages a window costs more than it
//    saves, and too few blocks of 256 sites reach the SMs. A block holds
//    32 sites and a warp per column group, and each thread searches the
//    whole table (which sits in L1/L2) in global memory, its columns'
//    searches in lockstep.
//  * Out-of-grid columns and dz = -1/+1 at z = 0 / Z-1 are masked from
//    the coords before any key compare (a shifted key there is another
//    voxel's key), as match_kernel.py masks them.
//  * Each output is written once, no atomics (in the table kernel a
//    site's mask is the OR of its 8 threads' bits, gathered through
//    shared memory); the kernels allocate nothing and launch on the
//    caller's stream.
// The TPU kernel's 128-lane window sweep, scatter inversion of the
// mirror offsets and (V, 32) lane layout are ways around the TPU's lack
// of fast random loads and are not carried over.
//
// The 5x5x5 form (subm_match_5x5x5, the 5^3 stem of a segmentation
// network): out (125, B * V) int32 with the same pad, offset k = 25 *
// (dx + 2) + 5 * (dy + 2) + (dz + 2), and masks (B * V, 2) int64, bit k
// in word k / 64 (ops/sparse_conv.row_masks of a 125-offset book). Its
// plain twin is ops/sparse.py:neighbor_match_columns(radius=2). Each of
// the 25 columns (dx, dy) in [-2, 2]^2 takes one lower-bound search for
// the key of dz = -2, and its five dz neighbours sit among the next five
// rows; the centre column is searched like the others. It is the table
// form (subm_match_table5): 32 sites a block, warp g holds columns g,
// g + 8, g + 16 (and warp 0 also 24) of each site and searches the
// table's real rows in lockstep; a site's two mask words are the OR of
// its 8 threads' bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableSites = kThreads / 8;   // subm_match_table: 8 warps
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kPastEnd = 0x7FFFFFFFFFFFFFFFLL;

// First index in [lo, hi) whose key is >= q, else hi. The whole warp
// calls it with the same arguments: each round its 32 lanes probe the
// last keys of 32 equal chunks, so the range shrinks 32-fold per load.
__device__ int warp_lower_bound(const long long* __restrict__ keys, int lo,
                                int hi, long long q) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = lo + (lane + 1) * step - 1;
    const bool less = pos < hi && keys[pos] < q;
    lo += __popc(__ballot_sync(kFull, less)) * step;
    hi = min(hi, lo + step);
  }
  const bool less = lane < hi - lo && keys[lo + lane] < q;
  return lo + __popc(__ballot_sync(kFull, less));
}

// First index in [lo, hi) whose key is >= q, else hi; one thread.
__device__ __forceinline__ int lower_bound(const long long* keys, int lo,
                                           int hi, long long q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long site_key(int4 c, int X, int Z) {
  return ((long long)(c.w * X + c.x) << 32) | (long long)(c.y * Z + c.z);
}

__device__ __forceinline__ bool column_in_grid(int4 c, int dx, int dy,
                                               int X, int Y) {
  return c.w >= 0 && c.x + dx >= 0 && c.x + dx < X && c.y + dy >= 0 &&
         c.y + dy < Y;
}

// The rows of the column's three neighbours from p, the first of the n
// rows of `a` whose key is >= t (the key of dz = -1): key t + dz sits at
// p + j with j <= dz, since the keys rise. Row numbers are row0 + index.
__device__ __forceinline__ void column_rows(const long long* a, int n, int p,
                                            long long t, bool zlo, bool zhi,
                                            int row0, int r[3]) {
  long long k3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) k3[j] = p + j < n ? a[p + j] : kPastEnd;
  const bool zok[3] = {zlo, true, zhi};
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int j = 0; j <= dz; ++j)
      if (zok[dz] && k3[j] == t + dz) r[dz] = row0 + p + j;
}

// The centre column: the site itself and its adjacent rows.
__device__ __forceinline__ void centre_rows(int i, int v, bool valid,
                                            long long key, long long k_prev,
                                            long long k_next, bool zlo,
                                            bool zhi, int r[3]) {
  r[0] = valid && zlo && i > 0 && k_prev == key - 1 ? i - 1 : v;
  r[1] = valid ? i : v;
  r[2] = valid && zhi && i + 1 < v && k_next == key + 1 ? i + 1 : v;
}

// 256 sites a block, a thread a site, the columns' windows in shared
// memory (budget rows each).
__global__ void __launch_bounds__(kThreads)
subm_match_windows(const long long* __restrict__ keys,
                   const int4* __restrict__ coords,
                   const int* __restrict__ num_ptr, int v, int X, int Y,
                   int Z, int budget, int* __restrict__ out,
                   long long* __restrict__ masks) {
  extern __shared__ long long win[];    // windows dx = -1, 0, +1
  __shared__ int w_lo[3], w_end[3];
  // building b's table, and its block of the flat book
  const int b = blockIdx.y;
  const size_t stride = (size_t)gridDim.y * v;
  const int row0 = b * v, pad = (int)stride;
  keys += row0;
  coords += row0;
  num_ptr += b;
  out += row0;
  masks += row0;
  const int first = blockIdx.x * kThreads;
  const int i = first + threadIdx.x;
  const int end = min(first + kThreads, v);
  // independent loads first, so that they are in flight together
  const int4 c = i < v ? coords[i] : make_int4(0, 0, 0, -1);
  const long long k_prev = i > 0 && i < v ? keys[i - 1] : 0;
  const long long k_next = i + 1 < v ? keys[i + 1] : 0;
  const long long k_first = keys[first];
  const long long k_end = keys[end - 1];
  const int num = min(*num_ptr, v);
  if (first >= num) {                   // a block of pad rows only
    if (i < v) {
      for (int k = 0; k < 27; ++k) out[k * stride + i] = pad;
      masks[i] = 0;
    }
    return;
  }
  const int last = min(end, num) - 1;
  const long long k_last = last == end - 1 ? k_end : keys[last];
  // warp 2w + e finds end e of window w: rows [w_lo, w_end) hold every
  // key from the block's smallest target (dy = -1, dz = -1) to its
  // largest (dy = +1, dz = +1) in that window's x plane
  const int warp = threadIdx.x >> 5;
  if (warp < 6) {
    const int w = warp >> 1;
    const long long shift = (long long)(w - 1) << 32;
    const long long q = (warp & 1) ? k_last + shift + Z + 2
                                   : k_first + shift - Z - 1;
    const int pos = warp_lower_bound(keys, 0, v, q);
    if ((threadIdx.x & 31) == 0) (warp & 1 ? w_end : w_lo)[w] = pos;
  }
  __syncthreads();
  for (int w = 0; w < 3; ++w) {
    const int lo = w_lo[w], n = w_end[w] - lo;
    if (n > budget) continue;
    for (int j = threadIdx.x; j < n; j += 4 * kThreads) {
      long long a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = j + u * kThreads < n ? keys[lo + j + u * kThreads] : 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + u * kThreads < n) win[w * budget + j + u * kThreads] = a[u];
    }
  }
  __syncthreads();
  if (i >= v) return;
  int r[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) r[k] = v;
  const bool valid = i < num;
  const bool zlo = c.z >= 1, zhi = c.z + 1 < Z;
  const long long key = valid ? site_key(c, X, Z) : 0;
  if (valid) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int w = dx + 1;
      const int lo = w_lo[w], n = w_end[w] - lo;
      const long long* wk = win + w * budget;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        if ((dx == 0 && dy == 0) || !column_in_grid(c, dx, dy, X, Y))
          continue;
        const int k0 = 9 * (dx + 1) + 3 * (dy + 1);
        const long long t =
            key + ((long long)dx << 32) + (long long)dy * Z - 1;
        if (n <= budget)
          column_rows(wk, n, lower_bound(wk, 0, n, t), t, zlo, zhi, lo,
                      r + k0);
        else
          column_rows(keys + lo, n, lower_bound(keys, lo, lo + n, t) - lo, t,
                      zlo, zhi, lo, r + k0);
      }
    }
  }
  centre_rows(i, v, valid, key, k_prev, k_next, zlo, zhi, r + 12);
  long long mask = 0;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    out[k * stride + i] = r[k] < v ? r[k] + row0 : pad;
    if (r[k] < v) mask |= 1LL << k;
  }
  masks[i] = mask;
}

// 32 sites a block; warp g holds column g of each site (and warp 0 also
// column 8; column 4 is the centre) and searches the whole table.
__global__ void __launch_bounds__(kThreads)
subm_match_table(const long long* __restrict__ keys,
                 const int4* __restrict__ coords,
                 const int* __restrict__ num_ptr, int v, int X, int Y, int Z,
                 int* __restrict__ out, long long* __restrict__ masks) {
  __shared__ int bits[kThreads];
  const int b = blockIdx.y;
  const size_t stride = (size_t)gridDim.y * v;
  const int row0 = b * v, pad = (int)stride;
  keys += row0;
  coords += row0;
  num_ptr += b;
  out += row0;
  masks += row0;
  const int s = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int i = blockIdx.x * kTableSites + s;
  const int4 c = i < v ? coords[i] : make_int4(0, 0, 0, -1);
  const long long k_prev = g == 4 && i > 0 && i < v ? keys[i - 1] : 0;
  const long long k_next = g == 4 && i + 1 < v ? keys[i + 1] : 0;
  const int num = min(*num_ptr, v);
  const bool valid = i < num;
  const bool zlo = c.z >= 1, zhi = c.z + 1 < Z;
  const long long key = valid ? site_key(c, X, Z) : 0;
  const int cols = g == 0 ? 2 : 1;
  const int cidx[2] = {g, 8};
  long long t[2];
  bool on[2];
  int base[2] = {0, 0};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int dx = cidx[m] / 3 - 1, dy = cidx[m] % 3 - 1;
    on[m] = valid && m < cols && cidx[m] != 4 &&
            column_in_grid(c, dx, dy, X, Y);
    t[m] = key + ((long long)dx << 32) + (long long)dy * Z - 1;
  }
  // branchless lower bounds over the table's num real rows, in lockstep
  for (int len = num; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int m = 0; m < 2; ++m)
      if (on[m] && keys[base[m] + half] < t[m]) base[m] += half;
    len -= half;
  }
  int bit = 0;
  if (i < v) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m >= cols) continue;
      int r[3] = {v, v, v};
      if (cidx[m] == 4)
        centre_rows(i, v, valid, key, k_prev, k_next, zlo, zhi, r);
      else if (on[m])
        column_rows(keys, num, base[m] + (keys[base[m]] < t[m]), t[m], zlo,
                    zhi, 0, r);
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        out[(3 * cidx[m] + dz) * stride + i] = r[dz] < v ? r[dz] + row0
                                                          : pad;
        if (r[dz] < v) bit |= 1 << (3 * cidx[m] + dz);
      }
    }
  }
  bits[threadIdx.x] = bit;
  __syncthreads();
  if (g == 0 && i < v) {
    long long mask = 0;
#pragma unroll
    for (int h = 0; h < 8; ++h) mask |= bits[h * kTableSites + s];
    masks[i] = mask;
  }
}

// 32 sites a block; warp g holds columns g, g + 8, g + 16 and, in warp
// 0, 24 of each site (column (dx + 2) * 5 + dy + 2) and searches the
// table's real rows.
__global__ void __launch_bounds__(kThreads)
subm_match_table5(const long long* __restrict__ keys,
                  const int4* __restrict__ coords,
                  const int* __restrict__ num_ptr, int v, int X, int Y,
                  int Z, int* __restrict__ out,
                  unsigned long long* __restrict__ masks) {
  constexpr int kCols = 25, kWarps = kThreads / 32, kMax = 4;
  __shared__ unsigned long long bits[2][kThreads];
  const int b = blockIdx.y;
  const size_t stride = (size_t)gridDim.y * v;
  const int row0 = b * v, pad = (int)stride;
  keys += row0;
  coords += row0;
  num_ptr += b;
  out += row0;
  masks += 2 * (size_t)row0;
  const int s = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int i = blockIdx.x * kTableSites + s;
  const int4 c = i < v ? coords[i] : make_int4(0, 0, 0, -1);
  const int num = min(*num_ptr, v);
  const bool valid = i < num;
  const long long key = valid ? site_key(c, X, Z) : 0;
  bool zok[5];
#pragma unroll
  for (int dz = 0; dz < 5; ++dz) zok[dz] = c.z + dz - 2 >= 0 && c.z + dz - 2 < Z;
  long long t[kMax];
  bool on[kMax];
  int base[kMax];
#pragma unroll
  for (int m = 0; m < kMax; ++m) {
    const int col = g + kWarps * m;
    const int dx = col / 5 - 2, dy = col % 5 - 2;
    on[m] = valid && col < kCols && column_in_grid(c, dx, dy, X, Y);
    t[m] = key + ((long long)dx << 32) + (long long)dy * Z - 2;
    base[m] = 0;
  }
  // branchless lower bounds over the table's num real rows, in lockstep
  for (int len = num; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int m = 0; m < kMax; ++m)
      if (on[m] && keys[base[m] + half] < t[m]) base[m] += half;
    len -= half;
  }
  unsigned long long word[2] = {0ull, 0ull};
  if (i < v) {
#pragma unroll
    for (int m = 0; m < kMax; ++m) {
      const int col = g + kWarps * m;
      if (col >= kCols) continue;
      int r[5] = {v, v, v, v, v};
      if (on[m]) {
        // key t + dz sits at p + j with j <= dz, since the keys rise
        const int p = base[m] + (keys[base[m]] < t[m]);
        long long k5[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) k5[j] = p + j < num ? keys[p + j] : kPastEnd;
#pragma unroll
        for (int dz = 0; dz < 5; ++dz)
#pragma unroll
          for (int j = 0; j <= dz; ++j)
            if (zok[dz] && k5[j] == t[m] + dz) r[dz] = p + j;
      }
#pragma unroll
      for (int dz = 0; dz < 5; ++dz) {
        const int k = 5 * col + dz;
        out[k * stride + i] = r[dz] < v ? r[dz] + row0 : pad;
        if (r[dz] < v) word[k >> 6] |= 1ull << (k & 63);
      }
    }
  }
  bits[0][threadIdx.x] = word[0];
  bits[1][threadIdx.x] = word[1];
  __syncthreads();
  if (g == 0 && i < v) {
    unsigned long long m0 = 0, m1 = 0;
#pragma unroll
    for (int h = 0; h < kWarps; ++h) {
      m0 |= bits[0][h * kTableSites + s];
      m1 |= bits[1][h * kTableSites + s];
    }
    masks[2 * (size_t)i] = m0;
    masks[2 * (size_t)i + 1] = m1;
  }
}

}  // namespace

// nb stacked tables of v rows (grid axis y): the 5x5x5 book (125,
// nb * v) and its two-word masks (nb * v, 2) in one launch.
extern "C" int subm_match_5x5x5(const void* keys, const void* coords,
                                const void* num, int nb, int v, int X, int Y,
                                int Z, void* out, void* masks, void* stream) {
  if (v < 1 || nb < 1 || nb > 65535 || 125LL * nb * v > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((v + kTableSites - 1) / kTableSites, nb);
  subm_match_table5<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const int4*>(coords),
      static_cast<const int*>(num), v, X, Y, Z, static_cast<int*>(out),
      static_cast<unsigned long long*>(masks));
  return static_cast<int>(cudaGetLastError());
}

// nb stacked tables of v rows (grid axis y). budget >= 1:
// subm_match_windows with windows of budget rows (3 * budget * 8 bytes of
// dynamic shared memory per block; a longer window is searched in global
// memory between its ends); budget 0: subm_match_table.
extern "C" int subm_match_3x3x3(const void* keys, const void* coords,
                                const void* num, int nb, int v, int X, int Y,
                                int Z, int budget, void* out, void* masks,
                                void* stream) {
  const auto k = static_cast<const long long*>(keys);
  const auto c = static_cast<const int4*>(coords);
  const auto n = static_cast<const int*>(num);
  const auto o = static_cast<int*>(out);
  const auto m = static_cast<long long*>(masks);
  const auto st = static_cast<cudaStream_t>(stream);
  if (budget < 0 || v < 1 || nb < 1 || nb > 65535 ||
      (long long)nb * v > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (budget == 0) {
    const dim3 grid((v + kTableSites - 1) / kTableSites, nb);
    subm_match_table<<<grid, kThreads, 0, st>>>(k, c, n, v, X, Y, Z, o, m);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (size_t)3 * budget * sizeof(long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        subm_match_windows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((v + kThreads - 1) / kThreads, nb);
  subm_match_windows<<<grid, kThreads, smem, st>>>(k, c, n, v, X, Y, Z,
                                                   budget, o, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subm_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
