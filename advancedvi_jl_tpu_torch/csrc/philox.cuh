// Step-indexed Philox4x32-10 normals, shared by the port's CUDA kernels.
//
// Replaces the TPU's on-chip PRNG draws of ops/pallas/location_scale_kernels.py
// (_uniform01, _box_muller, _mix_seed) and the per-step reseed of
// ops/pallas/fused_advi.py (_kernel, the prng_seed call).  The TPU PRNG has no
// counterpart here; Philox4x32-10 (Salmon et al., SC'11) is a counter-based
// generator, so a draw is a pure function of (key, counter) and any thread can
// make any element without carrying generator state:
//
//   key     = the two uint32 seed words;
//   counter = (global iteration, sample row, lane group j / 4, stream),
//             stream 0 gives the four u1 uniforms of a lane group and
//             stream 1 the four u2 uniforms (Box-Muller's two); the
//             low-rank sampler's factor draws (K7c, csrc/lowrank_sample.cu)
//             take streams 2 and 3, so its diagonal draws are the mean-field
//             draws of the same key and its factor draws are independent of
//             them.  The chain keys of a multi-chain run are Philox of the
//             run's key at counter (chain, 0, 0, 0x63686E73), computed on the
//             host (chain_seed_words); no draw uses that stream word.
//
// The counter holds the GLOBAL iteration, never a chunk-local step, so a run
// split into chunks draws exactly what one run draws.  The plain PyTorch
// version of the same function is philox4x32_reference in
// ops/cuda/location_scale_kernels.py; the two agree bit for bit.
//
// Uniforms take the top 23 bits by the mantissa trick, normals are
// sqrt(-2 log(u1 + 2^-24)) * cos(2 pi u2).  The kernels must be built without
// --use_fast_math: __logf/__cosf would move the normals away from the plain
// version's by far more than an ulp.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace avi {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// [0, 1) from 32 random bits: (bits >> 9) | 0x3F800000 is a float in [1, 2).
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Box-Muller, the form of the reference sampler (2^-24 keeps the log finite).
// Single multiplies only, so no FMA contraction can change the rounding.
__device__ __forceinline__ float box_muller(float u1, float u2) {
  return sqrtf(-2.0f * logf(u1 + 5.9604644775390625e-08f)) *
         cosf(6.2831854820251465f * u2);
}

// The four normals of lanes 4 * group .. 4 * group + 3 of sample row `row` at
// iteration `it`, from streams `stream` and `stream + 1` (0 for every draw
// but the low-rank factor draws, 2).
__device__ __forceinline__ void normals4(uint32_t k0, uint32_t k1, uint32_t it,
                                         uint32_t row, uint32_t group,
                                         float out[4], uint32_t stream = 0u) {
  const Philox4 a = philox4x32_10(it, row, group, stream, k0, k1);
  const Philox4 b = philox4x32_10(it, row, group, stream + 1u, k0, k1);
#pragma unroll
  for (int p = 0; p < 4; ++p) out[p] = box_muller(uniform01(a.w[p]), uniform01(b.w[p]));
}

}  // namespace avi
