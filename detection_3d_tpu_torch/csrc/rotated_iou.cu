// Rotated BEV IoU matrix: out[i, j] = iou(boxes[i] as target,
// query[j] as anchor), boxes [cx, cy, x_d, y_d, angle].
//
// Replaces the Pallas TPU kernel detection_3d_tpu/ops/pallas/
// rotated_iou_kernel.py (_tile_kernel / rotated_iou_matrix_pallas). The
// semantics are those of the plain version detection_3d_tpu_torch/ops/
// rotated_iou.py:rotated_iou_plain, written in the same operation order:
//   * 24 candidate vertices in a fixed order: the 4 query corners inside
//     the target, the 4 target corners inside the query, then the 16
//     query-edge x target-edge intersections (query edge outer);
//   * inclusive point-in-quad test, strict orientation tests;
//   * centroid pseudo-angle key, rank = count of smaller keys with the
//     static "j < i" tie-break (sort-free), shoelace area;
//   * criteria -1 (union), 0 (query area), 1 (target area), 2 (thin-box
//     rule on the target), anything else the raw intersection area.
// same_box_fix (identical boxes forced to 1) stays outside the kernel.
//
// What bounds it on an H100: about two thousand scalar f32 operations
// per pair (the 24 x 24 rank and successor searches dominate) against
// 4 bytes written per pair, so it is bound by operations on the CUDA
// cores. Build with --fmad=false: the orientation tests are strict
// comparisons, and a contracted multiply-add would round differently
// from the plain version and can flip a test on touching boxes.
//
// Design (simple first version): one thread per (target, query) pair;
// the 24 candidates, their keys and ranks live in registers (every loop
// is unrolled over compile-time bounds). Threads of a block share one
// target, so its corners are one broadcast load. The kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kNc = 24;
constexpr float kBig = 1e9f;

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

__global__ void rotated_iou_kernel(const float* __restrict__ boxes,
                                   const float* __restrict__ query, int n,
                                   int k, int criterion,
                                   float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  float q[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) q[t] = query[(size_t)j * 5 + t];
  float qx[4], qy[4];
  corners(q, qx, qy);

  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    float b[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) b[t] = boxes[(size_t)i * 5 + t];
    float bx[4], by[4];
    corners(b, bx, by);

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

    // centroid of the valid candidates
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

    // pseudo-angle keys around the centroid (x, y become the offsets)
    float key[kNc];
#pragma unroll
    for (int t = 0; t < kNc; ++t) {
      x[t] = x[t] - cxm;
      y[t] = y[t] - cym;
      const float d = sqrtf(x[t] * x[t] + y[t] * y[t]);
      const float ds = (d > 0.f) ? d : 1.f;
      const float ux = x[t] / ds;
      const float uy = y[t] / ds;
      const float kk = (uy < 0.f) ? (-2.f - ux) : ux;
      key[t] = (v[t] && d > 0.f) ? kk : kBig;
    }

    int rank[kNc];
#pragma unroll
    for (int a = 0; a < kNc; ++a) {
      int r = 0;
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        if (c == a) continue;
        const bool less = (key[c] < key[a]) || (c < a && key[c] == key[a]);
        r += less ? 1 : 0;
      }
      rank[a] = r;
    }

    // shoelace: the successor of vertex a is the valid vertex of rank+1
    const int nv = static_cast<int>(cnt);
    float area2 = 0.f;
#pragma unroll
    for (int a = 0; a < kNc; ++a) {
      const int nxt = (rank[a] + 1 >= nv) ? 0 : rank[a] + 1;
      float vnx = 0.f, vny = 0.f;
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        if (rank[c] == nxt && v[c]) {
          vnx = x[c];
          vny = y[c];
        }
      }
      const float cross = x[a] * vny - y[a] * vnx;
      area2 = area2 + (v[a] ? cross : 0.f);
    }
    const float inter = 0.5f * fabsf(area2);

    const float area_q = q[2] * q[3];
    const float area_b = b[2] * b[3];
    const float uni = area_q + area_b - inter;
    float iou;
    if (criterion == -1) {
      iou = inter / uni;
    } else if (criterion == 0) {
      iou = inter / area_q;
    } else if (criterion == 1) {
      iou = inter / area_b;
    } else if (criterion == 2) {
      const float mx = fmaxf(b[2], b[3]);
      const float mn = fminf(b[2], b[3]);
      const bool thin = mn / mx < 0.25f;
      const float thin_denom = area_b + fmaxf(0.f, area_q * 0.5f - inter);
      iou = thin ? inter / thin_denom : inter / uni;
    } else {
      iou = inter;
    }
    out[(size_t)i * k + j] = iou;
  }
}

}  // namespace

extern "C" int rotated_iou_matrix(const void* boxes, const void* query, int n,
                                  int k, int criterion, void* out,
                                  void* stream) {
  const int threads = 128;
  const int rows = n < 65535 ? n : 65535;
  dim3 grid((k + threads - 1) / threads, rows);
  rotated_iou_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(query), n,
      k, criterion, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rotated_iou_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
