// Rotated BEV IoU matrix: out[i, j] = iou(boxes[i] as target,
// query[j] as anchor), boxes [cx, cy, x_d, y_d, angle].
//
// Replaces the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// rotated_iou_kernel.py (_tile_kernel / rotated_iou_matrix_pallas). The
// semantics are those of the plain version detection_3d_tpu_torch/ops/
// rotated_iou.py:rotated_iou_plain, bit for bit:
//   * 24 candidate vertices in a fixed order: the 4 query corners inside
//     the target, the 4 target corners inside the query, then the 16
//     query-edge x target-edge intersections (query edge outer);
//   * inclusive point-in-quad test, strict orientation tests;
//   * centroid pseudo-angle key, rank = count of smaller keys with the
//     static "j < i" tie-break (sort-free), shoelace area;
//   * criteria -1 (union), 0 (query area), 1 (target area), 2 (thin-box
//     rule on the target), anything else the raw intersection area;
//   * same_box_fix: a pair whose five |differences| are all < 1e-6 gives
//     1 (the reference's check_same_boxes).
//
// What bounds it on an H100: a pair that meets costs a few thousand
// scalar f32 operations, a pair that cannot meet only its extent test
// and its 4-byte write. At the RPN-target call (512 gt boxes x 344,064
// anchors) a real gt box meets a few hundred anchors, so the call's
// least time is that of writing the 176 M results. The callers that own
// validity (rpn_targets, roi_targets) park their pad rows far away
// before the call (ops/rotated_iou.py:park_invalid), so the cull rules
// out their pairs too. Build with --fmad=false: the orientation tests
// are strict comparisons, and a contracted multiply-add would round
// differently from the plain version and can flip a test on touching
// boxes.
//
// Design:
//   * cull: every box's axis-aligned extent comes from its own corners.
//     A pair whose extents are separated by more than 1e-3 in x or in y
//     has no valid candidate, so its intersection is +0 and it writes the
//     criterion's formula at inter = +0.0f (the same bits as the full
//     computation, the NaN of a 0/0 included). A box with a non-finite
//     corner or a zero edge (its point-in-quad test would accept a whole
//     strip) takes the extent (-inf, inf) and is never culled; so is
//     any pair whose comparisons see a NaN. One thread owns one query;
//     a block's 128 queries (in anchor order, spatially coherent) share
//     a chunk of up to 64 targets staged in shared memory, and a target
//     separated from the union extent of a warp's 32 queries is culled
//     for the whole warp at once (the warp is the unit that diverges).
//   * hull: the candidates' validity and centroid are computed for all
//     24 as before; the valid ones are then compacted in candidate order
//     (typically <= 8) and the rank and successor searches loop only over
//     them. An invalid candidate's key (1e9) never ranks below a real
//     key, so a valid vertex's rank changes only when its own key is 1e9
//     (it then counts the invalid candidates before it, added back
//     here), and an invalid candidate adds 0 to the shoelace sum.
//   * batch: G matrices of the same (N, K) in one launch (grid axis z),
//     (G, N, 5) x (G, K, 5) -> (G, N, K). Matrix g reads only its own
//     boxes, with its own cull, so it is bit equal to its own call; the
//     NMS of a unit's buildings, and of their classes, is one launch.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNc = 24;
constexpr float kBig = 1e9f;
constexpr float kGap = 1e-3f;
constexpr float kSame = 1e-6f;
constexpr int kThreads = 128;
constexpr int kMaxChunk = 64;
constexpr int kTargetBlocks = 4096;

__device__ __forceinline__ void corners(const float* b, float* px,
                                        float* py) {
  const float cx = b[0], cy = b[1], xd = b[2], yd = b[3], ang = b[4];
  const float c = cosf(ang), s = sinf(ang);
  const float hx = xd * 0.5f, hy = yd * 0.5f;
  const float lx[4] = {-hx, -hx, hx, hx};
  const float ly[4] = {-hy, hy, hy, -hy};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    px[j] = c * lx[j] + s * ly[j] + cx;
    py[j] = -s * lx[j] + c * ly[j] + cy;
  }
}

// Axis-aligned extent {lo_x, hi_x, lo_y, hi_y} of a box from its
// corners, or (-inf, inf) in both axes when the box must not be culled.
__device__ __forceinline__ void extent(const float* px, const float* py,
                                       float* ext) {
  bool fin = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) fin = fin && isfinite(px[j]) && isfinite(py[j]);
  const float abx = px[1] - px[0], aby = py[1] - py[0];
  const float adx = px[3] - px[0], ady = py[3] - py[0];
  const float abab = abx * abx + aby * aby;
  const float adad = adx * adx + ady * ady;
  fin = fin && isfinite(abab) && isfinite(adad) && abab > 0.f && adad > 0.f;
  if (!fin) {
    ext[0] = ext[2] = -INFINITY;
    ext[1] = ext[3] = INFINITY;
    return;
  }
  ext[0] = fminf(fminf(px[0], px[1]), fminf(px[2], px[3]));
  ext[1] = fmaxf(fmaxf(px[0], px[1]), fmaxf(px[2], px[3]));
  ext[2] = fminf(fminf(py[0], py[1]), fminf(py[2], py[3]));
  ext[3] = fmaxf(fmaxf(py[0], py[1]), fmaxf(py[2], py[3]));
}

// True when the extents are separated by more than kGap in x or in y
// (false whenever a comparison sees a NaN).
__device__ __forceinline__ bool apart(const float* a, const float* b) {
  return (a[0] - b[1] > kGap) || (b[0] - a[1] > kGap) ||
         (a[2] - b[3] > kGap) || (b[2] - a[3] > kGap);
}

__device__ __forceinline__ bool in_quad(float px, float py, const float* qx,
                                        const float* qy) {
  const float abx = qx[1] - qx[0], aby = qy[1] - qy[0];
  const float adx = qx[3] - qx[0], ady = qy[3] - qy[0];
  const float apx = px - qx[0], apy = py - qy[0];
  const float abab = abx * abx + aby * aby;
  const float abap = abx * apx + aby * apy;
  const float adad = adx * adx + ady * ady;
  const float adap = adx * apx + ady * apy;
  return (abab >= abap) && (abap >= 0.f) && (adad >= adap) && (adap >= 0.f);
}

// Intersection area of query (qx, qy) and target (bx, by).
__device__ float intersection(const float* qx, const float* qy,
                              const float* bx, const float* by) {
  float x[kNc], y[kNc];
  bool v[kNc];
#pragma unroll
  for (int t = 0; t < 4; ++t) {  // query corners inside the target
    x[t] = qx[t];
    y[t] = qy[t];
    v[t] = in_quad(qx[t], qy[t], bx, by);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {  // target corners inside the query
    x[4 + t] = bx[t];
    y[4 + t] = by[t];
    v[4 + t] = in_quad(bx[t], by[t], qx, qy);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // query edge e x target edge f
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float ax = qx[e], ay = qy[e];
      const float bx_ = qx[(e + 1) % 4], by_ = qy[(e + 1) % 4];
      const float cx = bx[f], cy = by[f];
      const float dx = bx[(f + 1) % 4], dy = by[(f + 1) % 4];
      const bool acd = (dy - ay) * (cx - ax) > (cy - ay) * (dx - ax);
      const bool bcd = (dy - by_) * (cx - bx_) > (cy - by_) * (dx - bx_);
      const bool abc = (cy - ay) * (bx_ - ax) > (by_ - ay) * (cx - ax);
      const bool abd = (dy - ay) * (bx_ - ax) > (by_ - ay) * (dx - ax);
      const float bax = bx_ - ax, bay = by_ - ay;
      const float dcx = dx - cx, dcy = dy - cy;
      const float abba = ax * by_ - bx_ * ay;
      const float cddc = cx * dy - dx * cy;
      const float dh = bay * dcx - bax * dcy;
      const float safe = (dh == 0.f) ? 1.f : dh;
      const int t = 8 + 4 * e + f;
      x[t] = (abba * dcx - bax * cddc) / safe;
      y[t] = (abba * dcy - bay * cddc) / safe;
      v[t] = (acd != bcd) && (abc != abd) && (dh != 0.f);
    }
  }

  // centroid of the valid candidates, summed over all 24 in order (an
  // invalid candidate adds 0 * x, as in the plain version)
  float cnt = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
  for (int t = 0; t < kNc; ++t) {
    const float vf = v[t] ? 1.f : 0.f;
    cnt = cnt + vf;
    sx = sx + vf * x[t];
    sy = sy + vf * y[t];
  }
  const float denom = fmaxf(cnt, 1.f);
  const float cxm = sx / denom;
  const float cym = sy / denom;

  // the valid candidates, compacted in candidate order: offsets from the
  // centroid, pseudo-angle key, and how many invalid candidates precede
  float ox[kNc], oy[kNc], key[kNc];
  int skipped[kNc];
  int m = 0;
#pragma unroll
  for (int t = 0; t < kNc; ++t) {
    if (v[t]) {
      const float dx = x[t] - cxm;
      const float dy = y[t] - cym;
      const float d = sqrtf(dx * dx + dy * dy);
      const float ds = (d > 0.f) ? d : 1.f;
      const float ux = dx / ds;
      const float uy = dy / ds;
      const float kk = (uy < 0.f) ? (-2.f - ux) : ux;
      ox[m] = dx;
      oy[m] = dy;
      key[m] = (d > 0.f) ? kk : kBig;
      skipped[m] = t - m;
      ++m;
    }
  }

  int rank[kNc];
  for (int a = 0; a < m; ++a) {
    int r = 0;
    for (int c = 0; c < m; ++c) {
      if (c == a) continue;
      const bool less = (key[c] < key[a]) || (c < a && key[c] == key[a]);
      r += less ? 1 : 0;
    }
    // the invalid candidates before a tie with a key of 1e9
    if (key[a] == kBig) r += skipped[a];
    rank[a] = r;
  }

  // shoelace: the successor of vertex a is the valid vertex of rank+1
  const int nv = static_cast<int>(cnt);
  float area2 = 0.f;
  for (int a = 0; a < m; ++a) {
    const int nxt = (rank[a] + 1 >= nv) ? 0 : rank[a] + 1;
    float vnx = 0.f, vny = 0.f;
    for (int c = 0; c < m; ++c) {
      if (rank[c] == nxt) {
        vnx = ox[c];
        vny = oy[c];
      }
    }
    const float cross = ox[a] * vny - oy[a] * vnx;
    area2 = area2 + cross;
  }
  return 0.5f * fabsf(area2);
}

__device__ __forceinline__ float criterion_iou(float inter, const float* q,
                                               const float* b,
                                               int criterion) {
  const float area_q = q[2] * q[3];
  const float area_b = b[2] * b[3];
  const float uni = area_q + area_b - inter;
  if (criterion == -1) return inter / uni;
  if (criterion == 0) return inter / area_q;
  if (criterion == 1) return inter / area_b;
  if (criterion == 2) {
    const float mx = fmaxf(b[2], b[3]);
    const float mn = fminf(b[2], b[3]);
    const bool thin = mn / mx < 0.25f;
    const float thin_denom = area_b + fmaxf(0.f, area_q * 0.5f - inter);
    return thin ? inter / thin_denom : inter / uni;
  }
  return inter;
}

__device__ __forceinline__ bool same_box(const float* q, const float* b) {
  bool same = true;
#pragma unroll
  for (int t = 0; t < 5; ++t) same = same && (fabsf(b[t] - q[t]) < kSame);
  return same;
}

// a staged box: box (5), corners x (4), corners y (4), extent (4)
constexpr int kStride = 17;

__device__ __forceinline__ void stage(const float* box, float* g) {
#pragma unroll
  for (int t = 0; t < 5; ++t) g[t] = box[t];
  corners(g, g + 5, g + 9);
  extent(g + 5, g + 9, g + 13);
}

__global__ void __launch_bounds__(kThreads)
rotated_iou_kernel(const float* __restrict__ boxes,
                   const float* __restrict__ query, int n, int k,
                   int criterion, int same_box_fix, int chunk,
                   float* __restrict__ out) {
  __shared__ float tgt[kMaxChunk * kStride];

  // matrix blockIdx.z of the batch
  boxes += (size_t)blockIdx.z * n * 5;
  query += (size_t)blockIdx.z * k * 5;
  out += (size_t)blockIdx.z * n * k;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < k;
  float g[kStride];
  const float zero[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  stage(live ? query + (size_t)j * 5 : zero, g);

  // union extent of the warp's queries (neutral for threads past k)
  float ue[4] = {live ? g[13] : INFINITY, live ? g[14] : -INFINITY,
                 live ? g[15] : INFINITY, live ? g[16] : -INFINITY};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ue[0] = fminf(ue[0], __shfl_xor_sync(0xffffffffu, ue[0], off));
    ue[1] = fmaxf(ue[1], __shfl_xor_sync(0xffffffffu, ue[1], off));
    ue[2] = fminf(ue[2], __shfl_xor_sync(0xffffffffu, ue[2], off));
    ue[3] = fmaxf(ue[3], __shfl_xor_sync(0xffffffffu, ue[3], off));
  }

  const int n_chunks = (n + chunk - 1) / chunk;
  for (int ch = blockIdx.y; ch < n_chunks; ch += gridDim.y) {
    const int i0 = ch * chunk;
    const int rows = min(chunk, n - i0);
    __syncthreads();  // the previous chunk's targets are no longer read
    for (int r = threadIdx.x; r < rows; r += kThreads)
      stage(boxes + (size_t)(i0 + r) * 5, tgt + r * kStride);
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < rows; ++r) {
      const float* s = tgt + r * kStride;
      // the whole warp skips a target apart from all of its queries (a
      // uniform branch), each thread one apart from its own query
      float inter = 0.f;
      if (!apart(s + 13, ue) && !apart(s + 13, g + 13))
        inter = intersection(g + 5, g + 9, s + 5, s + 9);
      float iou = criterion_iou(inter, g, s, criterion);
      if (same_box_fix && same_box(g, s)) iou = 1.f;
      out[(size_t)(i0 + r) * k + j] = iou;
    }
  }
}

}  // namespace

extern "C" int rotated_iou_matrix(const void* boxes, const void* query, int g,
                                  int n, int k, int criterion,
                                  int same_box_fix, void* out, void* stream) {
  // one query per thread; targets in chunks staged in shared memory,
  // sized so that the grid holds about kTargetBlocks blocks
  if (g < 1 || g > 65535 || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cols = (k + kThreads - 1) / kThreads;
  long long chunk = (static_cast<long long>(n) * cols * g + kTargetBlocks -
                     1) / kTargetBlocks;
  chunk = chunk < 1 ? 1 : (chunk > kMaxChunk ? kMaxChunk : chunk);
  long long rows = (n + chunk - 1) / chunk;
  rows = rows > 65535 ? 65535 : rows;
  dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(rows),
            static_cast<unsigned>(g));
  rotated_iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(query), n,
      k, criterion, same_box_fix, static_cast<int>(chunk),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rotated_iou_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
