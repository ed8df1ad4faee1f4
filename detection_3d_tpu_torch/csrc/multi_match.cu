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
//   one row that can match. No assumption on the queries' order.
//
// What bounds it on an H100: the bytes, V * 8 + N * 12 (the keys, the
// queries read and the answers written once; 29 MB, 8.8 us at 3.35 TB/s
// for a full-size building's scale-0 conv queries). A lower-bound search
// a query is instead a chain of ceil(log2 V) + 1 dependent loads, and a
// warp's 32 searches spread over more lines at each level down: at the
// large books the L1/L2 traffic of those levels sets the pace (3x the
// bound on sorted queries, 17x on shuffled ones), at the small ones the
// chain's latency.
//
// Design: three forms, chosen by the wrapper from N and V
// (ops/multi_match.py multi_match_form; the same bits from each):
//  * quad (N <= 65,536: the launch is one wave of the card, so the
//    chain's latency is the time): a 4-ary search a query. The top holds
//    the <= 4 keys at stride 4^L; each level below loads the 3 keys
//    between the bracket's ends, independent loads, so the chain is
//    ceil(log4 V) + 1 steps against ceil(log2 V) + 1. The bracket's
//    upper key is carried down, so the key at the lower bound is never
//    loaded again.
//  * compact (N >= 2^20 and N >= 8 V: a deconv book, whose
//    queries are valid only where the division is exact, 1 in 8 at
//    stride 2; 89 % invalid at scale 0): a thread reads 4 queries as two
//    16-byte loads and answers the invalid ones V at once; each warp
//    compacts its valid ones (warp prefix of popcounts) into a queue in
//    shared memory and searches them 32 at a time, a lane each, so no
//    lane waits out a chain for an invalid query; the 4 answers leave as
//    one 16-byte store.
//  * binary (the rest): the plain lower-bound search, a query a thread.
//    At these sizes the card needs the most warps in flight, each with
//    the shortest chain of loads, and a thread a query gives that; every
//    other form measured on the card lost here:
//    a table-side sample in shared memory (persistent blocks, tiles
//    compacted, interleaved searches: 13-15 of 17 query sets slower; one
//    query a thread grid-stride: shuffled queries 14-19 % faster, the
//    sorted conv ones 13-17 % slower, the persistent grid alone 25 %),
//    compaction of the dense conv books (7-44 % slower), a 64-key window
//    a sorted warp (40 % slower), a hash table of the keys (its build
//    alone 25 us at V = 524288), two or four searches a thread
//    interleaved (30-50 % slower), branch-free and cache-hinted loops
//    (no gain).
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kInvalidHi = 0x7FFFFFFFLL;
constexpr long long kTop = 0x7FFFFFFFFFFFFFFFLL;   // above every key
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;   // the compact form's queries a thread

__device__ __forceinline__ bool valid_query(long long q) {
  return (q >> 32) != kInvalidHi;
}

// the lower bound of q in keys (v rows): the binary search
__device__ __forceinline__ int binary_search(const long long* __restrict__ keys,
                                             int v, long long q) {
  int lo = 0;
  int hi = v;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < v && keys[lo] == q ? lo : v;
}

__global__ void __launch_bounds__(kThreads)
multi_match_kernel(const long long* __restrict__ keys,
                   const long long* __restrict__ queries, int v, int n,
                   int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long q = queries[i];
  out[i] = valid_query(q) ? binary_search(keys, v, q) : v;
}

// the 4-ary search: L levels below a top of ceil(v / 4^L) <= 4 keys
__global__ void __launch_bounds__(kThreads)
multi_match_quad_kernel(const long long* __restrict__ keys,
                        const long long* __restrict__ queries, int v, int n,
                        int levels, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long q = queries[i];
  int res = v;
  if (valid_query(q)) {
    // p = the keys below q among the level's; ub = the key at p
    const int top = 1 << (2 * levels);
    long long e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      e[u] = (long long)u * top < v ? keys[(long long)u * top] : kTop;
    int p = (e[0] < q) + (e[1] < q) + (e[2] < q) + (e[3] < q);
    long long ub = p == 0 ? e[0] : p == 1 ? e[1] : p == 2 ? e[2]
                 : p == 3 ? e[3] : kTop;
    for (int l = levels - 1; l >= 0 && p > 0; --l) {
      // the level's keys 4(p - 1) < q <= 4p: the 3 between decide
      const int stride = 1 << (2 * l), base = 4 * (p - 1);
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const long long at = (long long)(base + 1 + u) * stride;
        e[u] = at < v ? keys[at] : kTop;
      }
      const int c = (e[0] < q) + (e[1] < q) + (e[2] < q);
      p = base + 1 + c;
      ub = c == 0 ? e[0] : c == 1 ? e[1] : c == 2 ? e[2] : ub;
    }
    if (ub == q) res = p;
  }
  out[i] = res;
}

// warp compaction: a warp's 32 * kPer queries, its valid ones searched
// 32 at a time
__global__ void __launch_bounds__(kThreads)
multi_match_compact_kernel(const long long* __restrict__ keys,
                           const long long* __restrict__ queries, int v,
                           int n, int* __restrict__ out) {
  __shared__ long long qk[kWarps][32 * kPer];
  __shared__ unsigned char qp[kWarps][32 * kPer];
  __shared__ __align__(16) int res[kWarps][32 * kPer];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long at =
      ((long long)blockIdx.x * kWarps + w) * 32 * kPer + lane * kPer;
  long long q[kPer];
  if ((reinterpret_cast<uintptr_t>(queries) & 15) == 0 && at + kPer <= n) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(queries + at));
    const longlong2 b =
        __ldcs(reinterpret_cast<const longlong2*>(queries + at + 2));
    q[0] = a.x, q[1] = a.y, q[2] = b.x, q[3] = b.y;
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r) q[r] = at + r < n ? queries[at + r] : 0;
  }
  // invalid queries (and places past n) are answered V at once; the
  // valid ones go to the warp's queue in their order
  unsigned valid = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    valid |= (unsigned)(at + r < n && valid_query(q[r])) << r;
    res[w][lane * kPer + r] = v;
  }
  const int c = __popc(valid);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  int slot = incl - c;
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    if ((valid >> r) & 1u) {
      qk[w][slot] = q[r];
      qp[w][slot] = static_cast<unsigned char>(lane * kPer + r);
      ++slot;
    }
  const int cnt = __shfl_sync(kFull, incl, 31);
  __syncwarp();
  for (int e = lane; e < cnt; e += 32)
    res[w][qp[w][e]] = binary_search(keys, v, qk[w][e]);
  __syncwarp();
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0 && at + kPer <= n) {
    *reinterpret_cast<int4*>(out + at) =
        *reinterpret_cast<const int4*>(&res[w][lane * kPer]);
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      if (at + r < n) out[at + r] = res[w][lane * kPer + r];
  }
}

}  // namespace

// keys (v,) and queries (n,) int64, out (n,) int32; form 1 binary, 2
// quad, 3 compact. One launch.
extern "C" int multi_match(const void* keys, const void* queries, void* out,
                           int v, int n, int form, void* stream) {
  if (n < 1) return 0;
  if (v < 0 || form < 1 || form > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(keys);
  const auto* q = static_cast<const long long*>(queries);
  auto* o = static_cast<int*>(out);
  const long long per = form == 3 ? (long long)kThreads * kPer : kThreads;
  const int grid = static_cast<int>((n + per - 1) / per);
  if (form == 1) {
    multi_match_kernel<<<grid, kThreads, 0, st>>>(k, q, v, n, o);
  } else if (form == 2) {
    int levels = 0;   // ceil(v / 4^levels) <= 4
    while (((long long)v + (1LL << (2 * levels)) - 1) >> (2 * levels) > 4)
      ++levels;
    multi_match_quad_kernel<<<grid, kThreads, 0, st>>>(k, q, v, n, levels, o);
  } else {
    multi_match_compact_kernel<<<grid, kThreads, 0, st>>>(k, q, v, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* multi_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
