// Native sparse-row KV store — the C++ hot path behind LargeScaleKV.
//
// Reference counterpart: paddle/fluid/operators/distributed/large_scale_kv.h
// (in-memory sharded sparse table with init rules serving the PS runtime).
// This implementation keeps the same contract as the Python LargeScaleKV
// (batched pull initialises missing rows once per unique key; push is an
// SGD-style scatter-accumulate over possibly-duplicated keys) but runs the
// id->slot mapping in an open-addressing hash table and the row math over
// a contiguous float arena, so million-row pulls don't touch the Python
// interpreter per key.
//
// C ABI only (ctypes binding in native/__init__.py) — no pybind11 in the
// image by design.

#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

constexpr int64_t kEmpty = INT64_MIN;  // not a legal key (checked in
                                        // the ctypes wrapper) — -1 IS a
                                        // legal id (padding indices)

struct KvStore {
  int64_t dim;
  float init_std;
  uint64_t seed;
  // open addressing, power-of-two capacity, empty = kEmpty
  std::vector<int64_t> keys;
  std::vector<int64_t> slots;
  int64_t size = 0;
  std::vector<float> data;  // arena: size*dim floats
  std::mt19937_64 rng;

  explicit KvStore(int64_t d, float std_, uint64_t seed_)
      : dim(d), init_std(std_), seed(seed_), keys(1024, kEmpty),
        slots(1024, 0), rng(seed_) {}

  static uint64_t hash(int64_t k) {
    uint64_t x = static_cast<uint64_t>(k);
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
  }

  void grow() {
    std::vector<int64_t> old_keys = std::move(keys);
    std::vector<int64_t> old_slots = std::move(slots);
    size_t cap = old_keys.size() * 2;
    keys.assign(cap, kEmpty);
    slots.assign(cap, 0);
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] == kEmpty) continue;
      size_t j = hash(old_keys[i]) & (cap - 1);
      while (keys[j] != kEmpty) j = (j + 1) & (cap - 1);
      keys[j] = old_keys[i];
      slots[j] = old_slots[i];
    }
  }

  // slot for key, creating (and initialising) the row if absent
  int64_t ensure(int64_t k) {
    if (size * 4 >= static_cast<int64_t>(keys.size()) * 3) grow();
    size_t cap = keys.size();
    size_t j = hash(k) & (cap - 1);
    while (keys[j] != kEmpty && keys[j] != k) j = (j + 1) & (cap - 1);
    if (keys[j] == k) return slots[j];
    keys[j] = k;
    slots[j] = size;
    data.resize((size + 1) * dim);
    float* row = data.data() + size * dim;
    if (init_std > 0.f) {
      std::normal_distribution<float> nd(0.f, init_std);
      for (int64_t c = 0; c < dim; ++c) row[c] = nd(rng);
    } else {
      std::memset(row, 0, sizeof(float) * dim);
    }
    return size++;
  }

};

}  // namespace

extern "C" {

void* kv_create(int64_t dim, float init_std, uint64_t seed) {
  return new KvStore(dim, init_std, seed);
}

void kv_destroy(void* h) { delete static_cast<KvStore*>(h); }

int64_t kv_size(void* h) { return static_cast<KvStore*>(h)->size; }

// out: [n, dim] row-major float32
void kv_pull(void* h, const int64_t* ks, int64_t n, float* out) {
  auto* s = static_cast<KvStore*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t slot = s->ensure(ks[i]);
    std::memcpy(out + i * s->dim, s->data.data() + slot * s->dim,
                sizeof(float) * s->dim);
  }
}

// grads: [n, dim]; applies row -= lr * grad (duplicates accumulate)
void kv_push(void* h, const int64_t* ks, int64_t n, const float* grads,
             float lr) {
  auto* s = static_cast<KvStore*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t slot = s->ensure(ks[i]);
    float* row = s->data.data() + slot * s->dim;
    const float* g = grads + i * s->dim;
    for (int64_t c = 0; c < s->dim; ++c) row[c] -= lr * g[c];
  }
}

// export for snapshot: keys_out [size], rows_out [size, dim]
void kv_export(void* h, int64_t* keys_out, float* rows_out) {
  auto* s = static_cast<KvStore*>(h);
  for (size_t j = 0; j < s->keys.size(); ++j) {
    if (s->keys[j] == kEmpty) continue;
    int64_t slot = s->slots[j];
    keys_out[slot] = s->keys[j];
    std::memcpy(rows_out + slot * s->dim, s->data.data() + slot * s->dim,
                sizeof(float) * s->dim);
  }
}

// bulk import (load): n rows with given keys
void kv_import(void* h, const int64_t* ks, int64_t n, const float* rows) {
  auto* s = static_cast<KvStore*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t slot = s->ensure(ks[i]);
    std::memcpy(s->data.data() + slot * s->dim, rows + i * s->dim,
                sizeof(float) * s->dim);
  }
}

}  // extern "C"
