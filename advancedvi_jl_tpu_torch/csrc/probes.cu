// K9: the four lowering probes of _pallas_probe.py (probe1-probe4, :25-104),
// the access patterns the fused kernels are built from, as one small kernel
// with a probe switch:
//
//   1  a loop of dynamic row loads: step i sums rows 8i .. 8i+7 of x
//      (the injected-noise path);
//   2  a loop of dynamic row stores: step i stores the running count into
//      row i of out (the ELBO trace);
//   3  a store guarded every other step: odd steps i store the count into
//      row i / 2 (the old traced mode's conditional store);
//   4  a rem-scheduled row load: step i sums rows 8k .. 8k+7 of x with
//      k = i mod nb (the minibatch window).
//
// Probes 1 and 4 write their total into every lane of out's one row.  The
// plain PyTorch versions are in ops/cuda/probe_kernels.py.
//
// What bounds it on an H100: latency.  A launch moves at most 16 x 8 x 128
// floats (64 KB) and does as many additions, well under a microsecond of
// the card's bandwidth; the 16 steps are sequential, each a block reduction
// with two barriers.  Design: one block, one thread a lane; a step's rows
// are summed down each lane's column, then across the lanes in a fixed
// order (warp butterflies, then the warps' totals in order), so a launch is
// deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;  // rows a step loads (the TPU's sublane tile)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void probes_kernel(int probe, const float* __restrict__ x, float* __restrict__ out,
                              int steps, int lanes, int nb) {
  __shared__ float red[32];
  const int t = threadIdx.x;
  const int warps = blockDim.x / 32;
  float acc = 0.0f;
  for (int i = 0; i < steps; ++i) {
    if (probe == 2) {
      acc += 1.0f;
      out[static_cast<size_t>(i) * lanes + t] = acc;
    } else if (probe == 3) {
      acc += 1.0f;
      if (i % 2 == 1) out[static_cast<size_t>(i / 2) * lanes + t] = acc;
    } else {
      const int row0 = kRows * (probe == 4 ? i % nb : i);
      float col = 0.0f;
      for (int r = 0; r < kRows; ++r) col += x[static_cast<size_t>(row0 + r) * lanes + t];
      col = warp_sum(col);
      if ((t & 31) == 0) red[t >> 5] = col;
      __syncthreads();
      float total = 0.0f;
      for (int w = 0; w < warps; ++w) total += red[w];
      acc += total;
      __syncthreads();  // red is rewritten next step
    }
  }
  if (probe == 1 || probe == 4) out[t] = acc;
}

}  // namespace

// probe 1-4; x: (steps * 8, lanes) for probe 1, (nb * 8, lanes) for probe 4,
// unused otherwise; out: (1, lanes) for probes 1 and 4, (steps, lanes) for
// probe 2, (steps / 2, lanes) for probe 3, zeroed by the caller.  lanes: a
// multiple of 32 up to 1024.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probes(int probe, const float* x, float* out, int steps, int lanes, int nb,
                      cudaStream_t stream) {
  if (probe < 1 || probe > 4 || steps < 0 || lanes < 32 || lanes > 1024 || lanes % 32 != 0 ||
      (probe == 4 && nb < 1) || ((probe == 1 || probe == 4) && x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  probes_kernel<<<1, lanes, 0, stream>>>(probe, x, out, steps, lanes, nb);
  return static_cast<int>(cudaGetLastError());
}
