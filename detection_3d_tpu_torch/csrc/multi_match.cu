// Query-key match: out[q] = the table row whose key equals query q, else V.
//
// Replaces the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// match_kernel.py (_kernel_multi / _multi_match_call, reached through
// sorted_multi_match, conv_rulebook_match and deconv_rulebook_match).
// Contract, identical bit for bit to the plain version
// detection_3d_tpu_torch/ops/multi_match.py:multi_match_plain:
//   keys (V,) int64 sorted table keys ((b*X + x) << 32 | (y*Z + z); pad
//   rows carry the largest key), queries (N,) int64 composite keys, where
//   a query whose high half is INVALID (2^31 - 1) is invalid; out (N,)
//   int32. The table's real keys are distinct, so the lower bound is the
//   one row that can match.
//
// What bounds it on an H100: N independent binary searches of
// ceil(log2 V) + 1 dependent probes into a key array that sits in L2
// (4 MB at V = 524288), then the int32 output write. The probes are
// latency bound more than the bytes are.
//
// Design (simple first version): one thread per query, a plain
// lower-bound search. The TPU kernel sorts the queries so that a block's
// keys fall in one window of the table, DMAs that window into VMEM and
// sweeps it in 128-lane rows; a GPU reads the table through L2 at random,
// so none of that carries over and the queries need not be sorted. The
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kInvalidHi = 0x7FFFFFFFLL;

__global__ void multi_match_kernel(const long long* __restrict__ keys,
                                   const long long* __restrict__ queries,
                                   int v, int n, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long q = queries[i];
  int res = v;
  if ((q >> 32) != kInvalidHi) {
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
  out[i] = res;
}

}  // namespace

extern "C" int multi_match(const void* keys, const void* queries, void* out,
                           int v, int n, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    multi_match_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys),
        static_cast<const long long*>(queries), v, n,
        static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* multi_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
