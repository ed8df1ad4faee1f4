// Native pyramid packer: the host-side sparse-conv metadata build.
//
// C++ twin of data/pyramid_packing.pack_pyramid (the role the
// reference's SCN Metadata C++ plays: voxel tables and every rulebook),
// run in the pipelined serving loader instead of inside the forward.
// Byte-identical to the numpy implementation
// (tests/test_torch_native_packer.py); the submanifold searches are
// spread over a small thread pool.
//
// Every rulebook ships as {prefix}_idx (K, V_out) i32 with its row
// order, which the port's gather-conv kernel reads: {prefix}_perm
// (V_out,) i32, the stable order of the rows by offset mask, and
// {prefix}_masks (V_out,), the masks in that order in the narrowest
// unsigned type that holds K bits (int64 above 32). Bit k of a row's
// mask is set when the row is one of the first num_out and idx[k, row]
// is a real input row (0 <= idx < V_in).
//
// With backward set (a pack for a training step) it also writes what the
// backward books need: {prefix}_entries (nnz, 2) i32, the real entries
// as (input row, output row) pairs, k-major and row-ascending, and
// {prefix}_starts (K + 1,) i32 of every submanifold, downsample (conv
// side) and BEV book, and each BEV book's transpose as a book of its own
// named bev{s}_t (its _idx, _perm, _masks). An _entries buffer is sized
// to the most entries its book can hold; _starts[K] says how many were
// written, and a book with more entries than its buffer holds fails the
// run.
//
// C API (ctypes; see data/native_packer.py):
//   pp_create(X, Y, Z, n_scales, caps[n_scales], kernels[(n-1)*3],
//             strides[(n-1)*3], bev_scales[n_bev], n_bev,
//             n_threads, backward) -> handle
//   pp_set_out(handle, name, ptr, nbytes)  // one per spec array + base
//   pp_run(handle, pts*, feats*, m)    // pts: (m,3) f32 scaled coords
//   pp_run_table(handle, pts*, feats*, m)   // the base table only
//   pp_last_error(handle) -> const char*
//   pp_destroy(handle)
//
// Output names match data/pyramid_packing.pyramid_pack_spec plus the
// base-table fields "vox res_q rgb_q nrm_q num true_num" (gt/origin
// stay python-side — they don't touch the hot path).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Packer {
  int X, Y, Z, n_scales, n_bev, n_threads;
  bool backward = false;
  std::vector<int64_t> caps;
  std::vector<int> kernels, strides, bev_scales;  // bev: scale index
  std::map<std::string, void*> out;
  std::map<std::string, int64_t> out_bytes;
  std::string error;

  void* get(const std::string& name) {
    auto it = out.find(name);
    if (it == out.end()) {
      error = "missing output buffer: " + name;
      return nullptr;
    }
    return it->second;
  }
};

struct Table {  // one scale's voxel table (valid rows only, sorted)
  std::vector<int32_t> vox;  // (num, 3)
  int64_t num = 0;
  int X, Y, Z;
  std::vector<int64_t> keys;  // (num,)
};

inline int64_t key_of(int64_t x, int64_t y, int64_t z, int Y, int Z) {
  return (x * Y + y) * Z + z;
}

// round-half-even, matching np.round
inline double np_round(double v) { return std::nearbyint(v); }

// ---- base table: sort + dedup-average + quantize (pack_table twin) ----
bool build_base(Packer& p, const float* pts, const float* feats,
                int64_t m, Table& t0) {
  const int64_t cap = p.caps[0];
  std::vector<int64_t> vx(m), vy(m), vz(m);
  std::vector<int64_t> rows;
  rows.reserve(m);
  for (int64_t i = 0; i < m; ++i) {
    double x = std::floor((double)pts[3 * i]);
    double y = std::floor((double)pts[3 * i + 1]);
    double z = std::floor((double)pts[3 * i + 2]);
    vx[i] = (int64_t)x; vy[i] = (int64_t)y; vz[i] = (int64_t)z;
    if (vx[i] >= 0 && vx[i] < p.X && vy[i] >= 0 && vy[i] < p.Y &&
        vz[i] >= 0 && vz[i] < p.Z)
      rows.push_back(i);
  }
  const int64_t n = (int64_t)rows.size();
  std::vector<int64_t> key(n);
  for (int64_t j = 0; j < n; ++j) {
    int64_t i = rows[j];
    key[j] = key_of(vx[i], vy[i], vz[i], p.Y, p.Z);
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return key[a] < key[b]; });

  // dedup + strided overflow keep (build_sparse_tensor semantics)
  int64_t num_vox = 0;
  for (int64_t j = 0; j < n; ++j)
    if (j == 0 || key[order[j]] != key[order[j - 1]]) ++num_vox;
  const int64_t stride = std::max<int64_t>((num_vox + cap - 1) / cap, 1);
  const int64_t num = std::min<int64_t>((num_vox + stride - 1) / stride,
                                        cap);

  auto* vox_o = (uint16_t*)p.get("vox");
  auto* res_o = (uint8_t*)p.get("res_q");
  auto* rgb_o = (uint8_t*)p.get("rgb_q");
  auto* nrm_o = (int8_t*)p.get("nrm_q");
  auto* num_o = (int32_t*)p.get("num");
  auto* true_o = (int32_t*)p.get("true_num");
  if (!vox_o || !res_o || !rgb_o || !nrm_o || !num_o || !true_o)
    return false;
  std::memset(vox_o, 0, sizeof(uint16_t) * cap * 3);
  std::memset(res_o, 0, cap * 3);
  std::memset(rgb_o, 0, cap * 3);
  std::memset(nrm_o, 0, cap * 3);
  *num_o = (int32_t)num;
  *true_o = (int32_t)num_vox;

  t0.X = p.X; t0.Y = p.Y; t0.Z = p.Z;
  t0.num = num;
  t0.vox.assign(num * 3, 0);
  t0.keys.assign(num, 0);

  int64_t seg = -1, slot = -1;
  double spx = 0, spy = 0, spz = 0, sr = 0, sg = 0, sb = 0;
  double snx = 0, sny = 0, snz = 0;
  int64_t cnt = 0, first_i = -1;
  bool keeping = false;

  auto flush = [&]() {
    if (!keeping || slot < 0 || slot >= num || cnt == 0) return;
    int64_t fi = first_i;
    int64_t fx = vx[fi], fy = vy[fi], fz = vz[fi];
    t0.vox[slot * 3] = (int32_t)fx;
    t0.vox[slot * 3 + 1] = (int32_t)fy;
    t0.vox[slot * 3 + 2] = (int32_t)fz;
    t0.keys[slot] = key_of(fx, fy, fz, p.Y, p.Z);
    vox_o[slot * 3] = (uint16_t)fx;
    vox_o[slot * 3 + 1] = (uint16_t)fy;
    vox_o[slot * 3 + 2] = (uint16_t)fz;
    double inv = 1.0 / (double)cnt;
    double rx = spx * inv - (double)fx;
    double ry = spy * inv - (double)fy;
    double rz = spz * inv - (double)fz;
    auto q8 = [](double r) {
      double v = std::floor(r * 256.0);
      return (uint8_t)std::min(255.0, std::max(0.0, v));
    };
    res_o[slot * 3] = q8(rx);
    res_o[slot * 3 + 1] = q8(ry);
    res_o[slot * 3 + 2] = q8(rz);
    auto qc = [&](double s) {
      double v = std::min(1.0, std::max(0.0, s * inv)) * 255.0;
      return (uint8_t)np_round(v);
    };
    rgb_o[slot * 3] = qc(sr);
    rgb_o[slot * 3 + 1] = qc(sg);
    rgb_o[slot * 3 + 2] = qc(sb);
    auto qn = [&](double s) {
      double v = std::min(1.0, std::max(-1.0, s * inv)) * 127.0;
      return (int8_t)np_round(v);
    };
    nrm_o[slot * 3] = qn(snx);
    nrm_o[slot * 3 + 1] = qn(sny);
    nrm_o[slot * 3 + 2] = qn(snz);
  };

  for (int64_t j = 0; j < n; ++j) {
    int64_t i = rows[order[j]];
    bool new_seg = (j == 0 || key[order[j]] != key[order[j - 1]]);
    if (new_seg) {
      flush();
      ++seg;
      keeping = (seg % stride) == 0;
      slot = seg / stride;
      spx = spy = spz = sr = sg = sb = snx = sny = snz = 0;
      cnt = 0;
      first_i = i;
    }
    if (keeping) {
      spx += pts[3 * i]; spy += pts[3 * i + 1]; spz += pts[3 * i + 2];
      const float* f = feats + 9 * i;
      sr += f[3]; sg += f[4]; sb += f[5];
      snx += f[6]; sny += f[7]; snz += f[8];
      ++cnt;
    }
  }
  flush();
  return true;
}

// ---- a rulebook and its row order (np_row_order twin) ----
// idx: (kvol, v_out) with missing == v_in. Writes {prefix}_idx, and the
// row masks' stable order by an LSD radix sort (8-bit digits, as many
// passes as the masks have bytes) into {prefix}_perm / {prefix}_masks.
template <typename T>
void write_masks(void* out, const std::vector<uint64_t>& keys) {
  auto* o = (T*)out;
  for (size_t i = 0; i < keys.size(); ++i) o[i] = (T)keys[i];
}

bool book_out(Packer& p, const std::string& prefix,
              const std::vector<int32_t>& idx, int kvol, int64_t v_out,
              int64_t num_out, int64_t v_in) {
  auto* oidx = (int32_t*)p.get(prefix + "_idx");
  auto* operm = (int32_t*)p.get(prefix + "_perm");
  void* omask = p.get(prefix + "_masks");
  if (!oidx || !operm || !omask) return false;
  if (kvol > 64) {
    p.error = prefix + ": row masks take at most 64 offsets";
    return false;
  }
  std::memcpy(oidx, idx.data(), sizeof(int32_t) * kvol * v_out);

  std::vector<uint64_t> key(v_out, 0);
  const int64_t rows = std::min(num_out, v_out);
  for (int k = 0; k < kvol; ++k) {
    const int32_t* row = idx.data() + (int64_t)k * v_out;
    for (int64_t r = 0; r < rows; ++r)
      if (row[r] >= 0 && row[r] < v_in) key[r] |= uint64_t(1) << k;
  }
  // the device orders int64 masks: a 64-offset mask's top bit is a sign
  const uint64_t flip = kvol == 64 ? uint64_t(1) << 63 : 0;
  for (auto& x : key) x ^= flip;
  std::vector<int32_t> perm(v_out), perm2(v_out);
  std::vector<uint64_t> key2(v_out);
  std::iota(perm.begin(), perm.end(), 0);
  const int passes = (kvol + 7) / 8;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 8 * pass;
    int64_t count[257] = {0};
    for (int64_t i = 0; i < v_out; ++i) ++count[((key[i] >> shift) & 255) + 1];
    for (int d = 0; d < 256; ++d) count[d + 1] += count[d];
    for (int64_t i = 0; i < v_out; ++i) {
      int64_t at = count[(key[i] >> shift) & 255]++;
      key2[at] = key[i];
      perm2[at] = perm[i];
    }
    key.swap(key2);
    perm.swap(perm2);
  }
  for (auto& x : key) x ^= flip;
  std::memcpy(operm, perm.data(), sizeof(int32_t) * v_out);
  if (kvol <= 8) write_masks<uint8_t>(omask, key);
  else if (kvol <= 16) write_masks<uint16_t>(omask, key);
  else if (kvol <= 32) write_masks<uint32_t>(omask, key);
  else write_masks<uint64_t>(omask, key);
  return true;
}

// ---- a rulebook's entry lists (ops/sparse_conv.rulebook_entries twin) --
// The real entries of idx (kvol, v_out): idx[k, i] in [0, v_in) and
// i < num_out, as (idx[k, i], i) pairs, k-major, i ascending.
bool entries_out(Packer& p, const std::string& prefix,
                 const std::vector<int32_t>& idx, int kvol, int64_t v_out,
                 int64_t num_out, int64_t v_in) {
  auto* oent = (int32_t*)p.get(prefix + "_entries");
  auto* ostart = (int32_t*)p.get(prefix + "_starts");
  if (!oent || !ostart) return false;
  const int64_t room = p.out_bytes[prefix + "_entries"] /
                       (int64_t)(2 * sizeof(int32_t));
  const int64_t rows = std::min(num_out, v_out);
  int64_t n = 0;
  ostart[0] = 0;
  for (int k = 0; k < kvol; ++k) {
    const int32_t* row = idx.data() + (int64_t)k * v_out;
    for (int64_t r = 0; r < rows; ++r)
      if (row[r] >= 0 && row[r] < v_in) {
        if (n == room) {
          p.error = prefix + "_entries: more entries than its buffer of " +
                    std::to_string(room) + " holds";
          return false;
        }
        oent[2 * n] = row[r];
        oent[2 * n + 1] = (int32_t)r;
        ++n;
      }
    ostart[k + 1] = (int32_t)n;
  }
  return true;
}

// ---- a rulebook's transpose as a book of its own (transpose_rulebook) --
// t (kvol, v_in) with t[k, idx[k, i]] = i for each real entry, v_out
// elsewhere; every row of t is wanted. Fails when two real entries of
// one offset read the same input row.
bool transpose_out(Packer& p, const std::string& prefix,
                   const std::vector<int32_t>& idx, int kvol,
                   int64_t v_out, int64_t num_out, int64_t v_in) {
  std::vector<int32_t> t((int64_t)kvol * v_in, (int32_t)v_out);
  const int64_t rows = std::min(num_out, v_out);
  for (int k = 0; k < kvol; ++k) {
    const int32_t* row = idx.data() + (int64_t)k * v_out;
    int32_t* trow = t.data() + (int64_t)k * v_in;
    for (int64_t r = 0; r < rows; ++r)
      if (row[r] >= 0 && row[r] < v_in) {
        if (trow[row[r]] != (int32_t)v_out) {
          p.error = prefix + ": two entries of one offset read the same "
                    "input row";
          return false;
        }
        trow[row[r]] = (int32_t)r;
      }
  }
  return book_out(p, prefix + "_t", t, kvol, v_in, v_in, v_out);
}

// ---- downsample + conv/deconv rulebooks ----
bool build_down(Packer& p, const Table& in, int level, Table& out) {
  const int* ks = &p.kernels[3 * level];
  const int* st = &p.strides[3 * level];
  int reach[3], osz[3];
  for (int a = 0; a < 3; ++a) {
    reach[a] = std::max(1, (ks[a] + st[a] - 1) / st[a]);
    int d = a == 0 ? in.X : (a == 1 ? in.Y : in.Z);
    osz[a] = (d + st[a] - 1) / st[a];
  }
  const int kvol = ks[0] * ks[1] * ks[2];
  const int64_t v_in = p.caps[level];       // parent capacity
  const int64_t cap = p.caps[level + 1];

  struct Cand { int64_t key; int64_t cidx; };  // cidx = rep*v_in + row
  std::vector<Cand> cands;
  const int n_rep = reach[0] * reach[1] * reach[2];
  cands.reserve(in.num * n_rep);
  std::vector<int32_t> koffs((int64_t)n_rep * v_in, 0);
  std::vector<int32_t> cox((int64_t)n_rep * v_in), coy((int64_t)n_rep * v_in),
      coz((int64_t)n_rep * v_in);
  int rep = 0;
  for (int ax = 0; ax < reach[0]; ++ax)
    for (int ay = 0; ay < reach[1]; ++ay)
      for (int az = 0; az < reach[2]; ++az, ++rep) {
        for (int64_t i = 0; i < in.num; ++i) {
          int64_t x = in.vox[3 * i], y = in.vox[3 * i + 1],
                  z = in.vox[3 * i + 2];
          int64_t ox = x / st[0] - ax, oy = y / st[1] - ay,
                  oz = z / st[2] - az;
          int64_t kx = x - ox * st[0], ky = y - oy * st[1],
                  kz = z - oz * st[2];
          bool ok = kx < ks[0] && ox >= 0 && ky < ks[1] && oy >= 0 &&
                    kz < ks[2] && oz >= 0;
          int64_t c = (int64_t)rep * v_in + i;
          if (ok) {
            cox[c] = (int32_t)ox; coy[c] = (int32_t)oy;
            coz[c] = (int32_t)oz;
            koffs[c] = (int32_t)((kx * ks[1] + ky) * ks[2] + kz);
            cands.push_back({key_of(ox, oy, oz, osz[1], osz[2]), c});
          }
        }
      }
  std::stable_sort(cands.begin(), cands.end(),
                   [](const Cand& a, const Cand& b) {
                     return a.key < b.key;
                   });
  int64_t num_vox = 0;
  for (size_t j = 0; j < cands.size(); ++j)
    if (j == 0 || cands[j].key != cands[j - 1].key) ++num_vox;
  const int64_t stride = std::max<int64_t>((num_vox + cap - 1) / cap, 1);
  const int64_t num = std::min<int64_t>((num_vox + stride - 1) / stride,
                                        cap);
  out.X = osz[0]; out.Y = osz[1]; out.Z = osz[2];
  out.num = num;
  out.vox.assign(num * 3, 0);
  out.keys.assign(num, 0);

  const std::string dn = "down" + std::to_string(level);
  const std::string un = "up" + std::to_string(level);
  std::vector<int32_t> crb((int64_t)kvol * cap, (int32_t)v_in);
  std::vector<int32_t> drb((int64_t)kvol * v_in, (int32_t)cap);

  auto* vox_o = (uint16_t*)p.get("t" + std::to_string(level + 1) + "_vox");
  auto* num_o = (int32_t*)p.get("t" + std::to_string(level + 1) + "_num");
  if (!vox_o || !num_o) return false;
  std::memset(vox_o, 0, sizeof(uint16_t) * cap * 3);
  *num_o = (int32_t)num;

  int64_t seg = -1, slot = -1;
  bool keeping = false;
  for (size_t j = 0; j < cands.size(); ++j) {
    if (j == 0 || cands[j].key != cands[j - 1].key) {
      ++seg;
      keeping = (seg % stride) == 0;
      slot = seg / stride;
      if (keeping && slot < num) {
        int64_t c = cands[j].cidx;
        out.vox[slot * 3] = cox[c];
        out.vox[slot * 3 + 1] = coy[c];
        out.vox[slot * 3 + 2] = coz[c];
        out.keys[slot] = cands[j].key;
        vox_o[slot * 3] = (uint16_t)cox[c];
        vox_o[slot * 3 + 1] = (uint16_t)coy[c];
        vox_o[slot * 3 + 2] = (uint16_t)coz[c];
      }
    }
    if (keeping && slot < num) {
      int64_t c = cands[j].cidx;
      int32_t src = (int32_t)(c % v_in);
      int32_t ko = koffs[c];
      crb[(int64_t)ko * cap + slot] = src;
      drb[(int64_t)ko * v_in + src] = (int32_t)slot;
    }
  }
  if (!book_out(p, dn, crb, kvol, cap, num, v_in)) return false;
  if (!book_out(p, un, drb, kvol, v_in, in.num, cap)) return false;
  if (p.backward && !entries_out(p, dn, crb, kvol, cap, num, v_in))
    return false;
  return true;
}

// ---- submanifold 27-neighbor rulebook (threaded over offsets) ----
bool build_subm(Packer& p, const Table& t, int scale) {
  const int64_t v = p.caps[scale];
  std::vector<int32_t> idx((int64_t)27 * v, (int32_t)v);
  const int64_t n = t.num;
  int offs[27][3];
  {
    int k = 0;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz, ++k) {
          offs[k][0] = dx; offs[k][1] = dy; offs[k][2] = dz;
        }
  }
  auto work = [&](int k0, int k1) {
    for (int k = k0; k < k1; ++k) {
      int dx = offs[k][0], dy = offs[k][1], dz = offs[k][2];
      int64_t dkey = key_of(dx, dy, dz, t.Y, t.Z);
      int32_t* row = idx.data() + (int64_t)k * v;
      // queries q_i = keys[i] + dkey are sorted (keys sorted, constant
      // shift), so the lookup is a sequential two-pointer MERGE —
      // O(n) streaming reads instead of n binary searches of random
      // cache misses (the same monotonicity the device match kernel
      // exploits, ops/pallas/match_kernel.py)
      int64_t j = 0;
      for (int64_t i = 0; i < n; ++i) {
        int64_t qx = t.vox[3 * i] + dx, qy = t.vox[3 * i + 1] + dy,
                qz = t.vox[3 * i + 2] + dz;
        if (qx < 0 || qx >= t.X || qy < 0 || qy >= t.Y || qz < 0 ||
            qz >= t.Z)
          continue;
        int64_t qk = t.keys[i] + dkey;
        while (j < n && t.keys[j] < qk) ++j;
        if (j < n && t.keys[j] == qk) row[i] = (int32_t)j;
      }
    }
  };
  int T = std::max(1, std::min(p.n_threads, 27));
  std::vector<std::thread> th;
  int per = (27 + T - 1) / T;
  for (int g = 0; g < T; ++g) {
    int k0 = g * per, k1 = std::min(27, k0 + per);
    if (k0 < k1) th.emplace_back(work, k0, k1);
  }
  for (auto& x : th) x.join();
  const std::string name = "subm" + std::to_string(scale);
  if (!book_out(p, name, idx, 27, v, t.num, v)) return false;
  return !p.backward || entries_out(p, name, idx, 27, v, t.num, v);
}

}  // namespace

extern "C" {

void* pp_create(int X, int Y, int Z, int n_scales, const int64_t* caps,
                const int* kernels, const int* strides,
                const int* bev_scales, int n_bev, int n_threads,
                int backward) {
  auto* p = new Packer();
  p->X = X; p->Y = Y; p->Z = Z; p->n_scales = n_scales;
  p->caps.assign(caps, caps + n_scales);
  p->kernels.assign(kernels, kernels + 3 * (n_scales - 1));
  p->strides.assign(strides, strides + 3 * (n_scales - 1));
  p->bev_scales.assign(bev_scales, bev_scales + n_bev);
  p->n_bev = n_bev;
  p->n_threads = n_threads;
  p->backward = backward != 0;
  return p;
}

void pp_set_out(void* h, const char* name, void* ptr, int64_t nbytes) {
  ((Packer*)h)->out[name] = ptr;
  ((Packer*)h)->out_bytes[name] = nbytes;
}

const char* pp_last_error(void* h) {
  return ((Packer*)h)->error.c_str();
}

int pp_run(void* h, const float* pts, const float* feats, int64_t m) {
  auto& p = *(Packer*)h;
  p.error.clear();
  std::vector<Table> tables(p.n_scales);
  if (!build_base(p, pts, feats, m, tables[0])) return 1;
  for (int k = 1; k < p.n_scales; ++k)
    if (!build_down(p, tables[k - 1], k - 1, tables[k])) return 2;
  for (int k = 0; k < p.n_scales; ++k)
    if (!build_subm(p, tables[k], k)) return 3;

  for (int s = 0; s < p.n_bev; ++s) {
    const Table& t = tables[p.bev_scales[s]];
    const int64_t cap = p.caps[p.bev_scales[s]];
    const int64_t v_in = cap;
    const std::string pre = "bev" + std::to_string(s);
    auto* vox_o = (uint16_t*)p.get(pre + "_vox");
    auto* num_o = (int32_t*)p.get(pre + "_num");
    if (!vox_o || !num_o) return 4;
    std::memset(vox_o, 0, sizeof(uint16_t) * cap * 3);
    // parent is (x, y, z)-sorted => z=0 projection already sorted
    std::vector<int32_t> rb((int64_t)t.Z * cap, (int32_t)v_in);
    int64_t num_vox = 0;
    for (int64_t i = 0; i < t.num; ++i)
      if (i == 0 || t.vox[3 * i] != t.vox[3 * (i - 1)] ||
          t.vox[3 * i + 1] != t.vox[3 * (i - 1) + 1])
        ++num_vox;
    const int64_t stride =
        std::max<int64_t>((num_vox + cap - 1) / cap, 1);
    const int64_t numb =
        std::min<int64_t>((num_vox + stride - 1) / stride, cap);
    *num_o = (int32_t)numb;
    int64_t seg = -1, slot = -1;
    bool keeping = false;
    for (int64_t i = 0; i < t.num; ++i) {
      if (i == 0 || t.vox[3 * i] != t.vox[3 * (i - 1)] ||
          t.vox[3 * i + 1] != t.vox[3 * (i - 1) + 1]) {
        ++seg;
        keeping = (seg % stride) == 0;
        slot = seg / stride;
        if (keeping && slot < numb) {
          vox_o[slot * 3] = (uint16_t)t.vox[3 * i];
          vox_o[slot * 3 + 1] = (uint16_t)t.vox[3 * i + 1];
          vox_o[slot * 3 + 2] = 0;
        }
      }
      if (keeping && slot < numb)
        rb[(int64_t)t.vox[3 * i + 2] * cap + slot] = (int32_t)i;
    }
    if (!book_out(p, pre, rb, t.Z, cap, numb, v_in)) return 5;
    if (p.backward && (!entries_out(p, pre, rb, t.Z, cap, numb, v_in) ||
                       !transpose_out(p, pre, rb, t.Z, cap, numb, v_in)))
      return 6;
  }
  return 0;
}

// Table-only pack: just the input layer (sort + dedup-average +
// quantize, data/packing.pack_table twin). The per-scale metadata then
// builds in-graph ("table" serving mode) — this is the host's entire
// per-building cost on that path, so it must be far under device time.
// Needs only the vox/res_q/rgb_q/nrm_q/num/true_num outputs set.
int pp_run_table(void* h, const float* pts, const float* feats,
                 int64_t m) {
  auto& p = *(Packer*)h;
  p.error.clear();
  Table t0;
  if (!build_base(p, pts, feats, m, t0)) return 1;
  return 0;
}

void pp_destroy(void* h) { delete (Packer*)h; }

}  // extern "C"
