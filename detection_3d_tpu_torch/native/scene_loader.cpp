// Native scene-pack loader: threaded prefetching reader for training IO.
//
// The port's copy of the JAX package's native/scene_loader.cpp. It plays
// the role of the reference's torch DataLoader worker pool (reference
// data3d/data.py:14-41; maskrcnn_benchmark/data/build.py num_workers):
// scene files are read and decoded on a C++ thread pool ahead of the
// training step, so host IO overlaps the card's compute.
//
// File format ("scene pack", written by data/scene_pack.py):
//   magic "SPK1" | u32 n_arrays | per array:
//     u32 name_len | name bytes | u32 dtype_code | u32 ndim |
//     u64 dims[ndim] | u64 byte_len | data bytes
// dtype codes: 0=f32 1=f64 2=i32 3=i64 4=u8 5=bool
//
// C API (ctypes-friendly, see data/native_loader.py):
//   sl_open(paths, n, n_prefetch, n_threads) -> handle
//   sl_set_order(handle, order, n)  (epoch permutation; re-queues)
//   sl_next(handle) -> scene*      (blocks; NULL at end of epoch)
//   scene introspection: sl_scene_n_arrays / name / dtype / ndim /
//     dims / data / byte_len
//   sl_release(scene), sl_close(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Array {
  std::string name;
  uint32_t dtype;
  std::vector<uint64_t> dims;
  std::vector<uint8_t> data;
};

struct Scene {
  std::vector<Array> arrays;
  bool ok = false;
  std::string error;
};

Scene* load_scene_file(const std::string& path) {
  auto* s = new Scene();
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    s->error = "open failed: " + path;
    return s;
  }
  char magic[4];
  uint32_t n_arrays = 0;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "SPK1", 4) ||
      std::fread(&n_arrays, 4, 1, f) != 1) {
    s->error = "bad header: " + path;
    std::fclose(f);
    return s;
  }
  s->arrays.resize(n_arrays);
  for (uint32_t i = 0; i < n_arrays; ++i) {
    Array& a = s->arrays[i];
    uint32_t name_len = 0, ndim = 0;
    uint64_t byte_len = 0;
    if (std::fread(&name_len, 4, 1, f) != 1 || name_len > 4096) goto fail;
    a.name.resize(name_len);
    if (std::fread(&a.name[0], 1, name_len, f) != name_len) goto fail;
    if (std::fread(&a.dtype, 4, 1, f) != 1) goto fail;
    if (std::fread(&ndim, 4, 1, f) != 1 || ndim > 16) goto fail;
    a.dims.resize(ndim);
    if (ndim && std::fread(a.dims.data(), 8, ndim, f) != ndim) goto fail;
    if (std::fread(&byte_len, 8, 1, f) != 1) goto fail;
    a.data.resize(byte_len);
    if (byte_len && std::fread(a.data.data(), 1, byte_len, f) != byte_len)
      goto fail;
  }
  s->ok = true;
  std::fclose(f);
  return s;
fail:
  s->error = "truncated pack: " + path;
  std::fclose(f);
  return s;
}

struct Loader {
  std::vector<std::string> paths;
  std::vector<int> order;     // epoch order (indices into paths)
  size_t next_to_schedule = 0;  // position in `order`
  size_t next_to_emit = 0;
  size_t n_prefetch;
  std::map<size_t, Scene*> ready;  // position -> loaded scene
  std::deque<size_t> work;         // positions to load
  std::mutex mu;
  std::condition_variable cv_work, cv_ready;
  std::vector<std::thread> threads;
  uint64_t generation = 0;  // bumped by set_order
  bool stop = false;

  void worker() {
    for (;;) {
      size_t pos;
      uint64_t gen;
      std::string path;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !work.empty(); });
        if (stop) return;
        pos = work.front();
        work.pop_front();
        gen = generation;
        path = paths[order[pos]];
      }
      Scene* s = load_scene_file(path);
      {
        std::lock_guard<std::mutex> lk(mu);
        // a load started before set_order belongs to the old order
        if (gen != generation) {
          delete s;
          continue;
        }
        ready[pos] = s;
      }
      cv_ready.notify_all();
    }
  }

  void schedule_upto_locked() {
    while (next_to_schedule < order.size() &&
           next_to_schedule < next_to_emit + n_prefetch) {
      work.push_back(next_to_schedule++);
    }
    cv_work.notify_all();
  }

  Scene* next() {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_emit >= order.size()) return nullptr;
    schedule_upto_locked();
    size_t pos = next_to_emit;
    cv_ready.wait(lk, [&] { return ready.count(pos) > 0; });
    Scene* s = ready[pos];
    ready.erase(pos);
    ++next_to_emit;
    schedule_upto_locked();
    return s;
  }

  void set_order(const int* idx, int n) {
    std::lock_guard<std::mutex> lk(mu);
    // drop any queued-but-unclaimed work; loaded-but-unclaimed scenes
    // are freed
    work.clear();
    for (auto& kv : ready) delete kv.second;
    ready.clear();
    order.assign(idx, idx + n);
    ++generation;
    next_to_schedule = 0;
    next_to_emit = 0;
    schedule_upto_locked();
  }
};

}  // namespace

extern "C" {

void* sl_open(const char** paths, int n, int n_prefetch, int n_threads) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->order.resize(n);
  for (int i = 0; i < n; ++i) L->order[i] = i;
  L->n_prefetch = n_prefetch > 0 ? n_prefetch : 2;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->threads.emplace_back([L] { L->worker(); });
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->schedule_upto_locked();
  }
  return L;
}

void sl_set_order(void* h, const int* idx, int n) {
  static_cast<Loader*>(h)->set_order(idx, n);
}

void* sl_next(void* h) { return static_cast<Loader*>(h)->next(); }

int sl_scene_ok(void* sc) { return static_cast<Scene*>(sc)->ok ? 1 : 0; }

const char* sl_scene_error(void* sc) {
  return static_cast<Scene*>(sc)->error.c_str();
}

int sl_scene_n_arrays(void* sc) {
  return static_cast<int>(static_cast<Scene*>(sc)->arrays.size());
}

const char* sl_scene_name(void* sc, int i) {
  return static_cast<Scene*>(sc)->arrays[i].name.c_str();
}

int sl_scene_dtype(void* sc, int i) {
  return static_cast<int>(static_cast<Scene*>(sc)->arrays[i].dtype);
}

int sl_scene_ndim(void* sc, int i) {
  return static_cast<int>(static_cast<Scene*>(sc)->arrays[i].dims.size());
}

const uint64_t* sl_scene_dims(void* sc, int i) {
  return static_cast<Scene*>(sc)->arrays[i].dims.data();
}

const void* sl_scene_data(void* sc, int i) {
  return static_cast<Scene*>(sc)->arrays[i].data.data();
}

uint64_t sl_scene_byte_len(void* sc, int i) {
  return static_cast<Scene*>(sc)->arrays[i].data.size();
}

void sl_release(void* sc) { delete static_cast<Scene*>(sc); }

void sl_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_work.notify_all();
  for (auto& t : L->threads) t.join();
  for (auto& kv : L->ready) delete kv.second;
  delete L;
}

}  // extern "C"
