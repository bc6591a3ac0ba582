// Host-side native data engine for doubly-stochastic VI (the port's copy of
// advancedvi_jl_tpu/ops/cpp/reshuffle.cc: the same permutations and gathers).
//
// The reference has no data loader at all — its datasets are in-memory Julia
// vectors shuffled with Random.shuffle (reference: src/reshuffling.jl:32-36).
// On TPU the device-side schedule (subsampling.py) covers datasets that fit
// in HBM; THIS library is the native path for datasets that do not: epoch
// permutations and threaded minibatch row-gathers run on the host CPU off the
// GIL, producing pinned staging buffers the runtime feeds to the device.
//
// Exposed via ctypes (no pybind11 in this image): plain C ABI.
//
// Build (utils/data.py does it at first use, into build/native/):
//   g++ -O3 -march=native -shared -fPIC -o libreshuffle.so reshuffle.cc -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64 — tiny, high-quality stream for seeding/shuffling.
static inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// Lemire's unbiased bounded random.
static inline uint64_t bounded(uint64_t& state, uint64_t range) {
  __uint128_t m = (__uint128_t)splitmix64(state) * (__uint128_t)range;
  return (uint64_t)(m >> 64);
}

}  // namespace

extern "C" {

// Fisher–Yates permutation of [0, n) into out (int32), seeded determinstically.
void avt_fill_permutation(uint64_t seed, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = (int32_t)i;
  uint64_t st = seed ^ 0xD1B54A32D192ED03ull;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = bounded(st, (uint64_t)(i + 1));
    int32_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

// Threaded gather of rows: dst[k, :] = src[idx[k], :], float32.
void avt_gather_rows_f32(const float* src, const int32_t* idx, float* dst,
                         int64_t n_idx, int64_t row_len, int32_t n_threads) {
  if (n_threads <= 1 || n_idx < 1024) {
    for (int64_t k = 0; k < n_idx; ++k) {
      std::memcpy(dst + k * row_len, src + (int64_t)idx[k] * row_len,
                  sizeof(float) * row_len);
    }
    return;
  }
  std::vector<std::thread> workers;
  std::atomic<int64_t> next(0);
  const int64_t chunk = 256;
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        int64_t start = next.fetch_add(chunk);
        if (start >= n_idx) break;
        int64_t end = start + chunk < n_idx ? start + chunk : n_idx;
        for (int64_t k = start; k < end; ++k) {
          std::memcpy(dst + k * row_len, src + (int64_t)idx[k] * row_len,
                      sizeof(float) * row_len);
        }
      }
    });
  }
  for (auto& w : workers) w.join();
}

// Epoch batch schedule: permutation truncated to n_batches*batchsize and
// reshaped row-major to (n_batches, batchsize) — the exact static-shape
// contract of subsampling.py.
void avt_epoch_batches(uint64_t seed, int64_t n_data, int64_t batchsize,
                       int32_t* out /* (n_data/batchsize)*batchsize */) {
  int64_t n_keep = (n_data / batchsize) * batchsize;
  std::vector<int32_t> perm(n_data);
  avt_fill_permutation(seed, n_data, perm.data());
  std::memcpy(out, perm.data(), sizeof(int32_t) * n_keep);
}

}  // extern "C"
