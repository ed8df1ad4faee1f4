// Submanifold 3x3x3 rulebook: out[k, i] = row of the neighbour of site i
// at offset k, or V when it is absent, out of the grid, or site i is a
// pad row.
//
// Replaces the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// match_kernel.py (_kernel / _match_call, reached through
// neighbor_match_3x3x3). Contract, identical bit for bit to the plain
// version detection_3d_tpu_torch/ops/sparse.py:neighbor_indices:
//   keys (V,) int64 sorted table keys ((b*X + x) << 32 | (y*Z + z), pad
//   rows carry the largest key), coords (V, 4) int32 [x, y, z, b],
//   num (1,) int32 active rows; out (27, V) int32. Offset k walks dx
//   outer, dy, dz inner (ops/sparse.submanifold_offsets order).
//
// What bounds it on an H100: 27*V binary searches of ~log2(V) probes
// over a key array that fits L2 (4 MB at V = 524288), and the (27, V)
// int32 output write. Probes are dependent loads, so the kernel is
// bound by L2 latency times the probe depth more than by DRAM bytes.
//
// Design (simple first version): one thread per (site, offset), with a
// plain lower-bound search on the 64-bit composite key. Out-of-grid
// offsets are masked from the coords before the search (a shifted key
// would alias a voxel of the next column), as match_kernel.py masks
// them. The TPU kernel's 4-group window sweep, scatter inversion of the
// mirror offsets, centre-column adjacency and (V, 32) lane layout are
// ways around the TPU's lack of fast random loads and are not carried
// over. The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void subm_match_kernel(const long long* __restrict__ keys,
                                  const int4* __restrict__ coords,
                                  const int* __restrict__ num, int v, int X,
                                  int Y, int Z, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= v) return;
  const int dx = k / 9 - 1;
  const int dy = (k / 3) % 3 - 1;
  const int dz = k % 3 - 1;
  int res = v;
  if (i < *num) {
    const int4 c = coords[i];
    const int x = c.x + dx;
    const int y = c.y + dy;
    const int z = c.z + dz;
    const int b = c.w;
    if (x >= 0 && x < X && y >= 0 && y < Y && z >= 0 && z < Z && b >= 0) {
      const long long q =
          ((long long)(b * X + x) << 32) | (long long)(y * Z + z);
      int lo = 0;
      int hi = v;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < q)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo < v && keys[lo] == q) res = lo;
    }
  }
  out[(size_t)k * v + i] = res;
}

}  // namespace

extern "C" int subm_match_3x3x3(const void* keys, const void* coords,
                                const void* num, int v, int X, int Y, int Z,
                                void* out, void* stream) {
  const int threads = 256;
  dim3 grid((v + threads - 1) / threads, 27);
  subm_match_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const int4*>(coords),
      static_cast<const int*>(num), v, X, Y, Z, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subm_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
