// K9: the four lowering probes of _pallas_probe.py (probe1-probe4, :25-104),
// the access patterns the fused kernels are built from, as one small kernel
// a pattern:
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
// the card's bandwidth (but all of it into one SM).
//
// Design, probes 1 and 4: the 8-row blocks a probe reads are its units (a
// step of probe 1; a window of probe 4, read once however many steps take
// it).  Warp w of the block takes units w, w + warps, ... (the launch plan
// of probe_kernels.probe_plan, which sizes the block and the shared
// memory), and loads a unit's rows for four 32-lane groups at once into
// registers (through L2: each row is read once), so all of a step's loads
// are in flight together and the steps' loads overlap across the warps.  A unit's total is formed as one step's was in a
// thread-a-lane loop: each lane's 8 rows summed down its column in order,
// a warp butterfly over each group of 32 lanes, the groups' totals in
// order.  The units' totals meet in shared memory behind one barrier, and
// each thread adds them in step order (a unit index that wraps at nb, no
// division), so the probe's total has the bits of the sequential loop.  Probes 2 and 3 stay a store loop, one thread a
// lane: they are a chain of dependent stores with no read to overlap.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;             // rows a step loads (the TPU's sublane tile)
constexpr int kGroupsInFlight = 4;   // 32-lane groups a warp loads at once
constexpr int kStaticSmem = 48 * 1024;  // dynamic shared memory a launch takes unasked

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void probe_loads_kernel(int probe, const float* __restrict__ x,
                                   float* __restrict__ out, int steps, int lanes, int nb,
                                   int units) {
  extern __shared__ float unit_total[];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int groups = lanes >> 5;
  for (int k = threadIdx.x >> 5; k < units; k += warps) {
    const float* rows = x + static_cast<size_t>(kRows) * k * lanes + lane;
    float total = 0.0f;
    for (int g0 = 0; g0 < groups; g0 += kGroupsInFlight) {
      float v[kGroupsInFlight][kRows];
#pragma unroll
      for (int j = 0; j < kGroupsInFlight; ++j)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          v[j][r] = g0 + j < groups ? __ldcg(rows + r * lanes + 32 * (g0 + j)) : 0.0f;
#pragma unroll
      for (int j = 0; j < kGroupsInFlight; ++j) {
        float col = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) col += v[j][r];
        if (g0 + j < groups) total += warp_sum(col);
      }
    }
    if (lane == 0) unit_total[k] = total;
  }
  __syncthreads();
  float acc = 0.0f;
  const int period = probe == 4 ? nb : steps;
  int at = 0;
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
    acc += unit_total[at];
    if (++at == period) at = 0;
  }
  for (int t = threadIdx.x; t < lanes; t += blockDim.x) out[t] = acc;
}

__global__ void probe_stores_kernel(int probe, float* __restrict__ out, int steps,
                                    int lanes) {
  const int t = threadIdx.x;
  float acc = 0.0f;
  for (int i = 0; i < steps; ++i) {
    acc += 1.0f;
    if (probe == 2)
      out[static_cast<size_t>(i) * lanes + t] = acc;
    else if (i % 2 == 1)
      out[static_cast<size_t>(i / 2) * lanes + t] = acc;
  }
}

}  // namespace

// probe 1-4; x: (steps * 8, lanes) for probe 1, (nb * 8, lanes) for probe 4,
// unused otherwise; out: (1, lanes) for probes 1 and 4, (steps, lanes) for
// probe 2, (steps / 2, lanes) for probe 3, every element written.  lanes: a
// multiple of 32 up to 1024.  units, threads, smem_bytes: probe_plan's (the
// 8-row blocks read, steps for probe 1 and min(nb, steps) for probe 4, 0
// otherwise; the block's threads, a multiple of 32, lanes for probes 2 and
// 3; the units' shared memory).  Returns the launch's CUDA error, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probes(int probe, const float* x, float* out, int steps, int lanes, int nb,
                      int units, int threads, int smem_bytes, cudaStream_t stream) {
  const bool loads = probe == 1 || probe == 4;
  const int want_units = probe == 1 ? steps : probe == 4 ? min(nb, steps) : 0;
  if (probe < 1 || probe > 4 || steps < 0 || lanes < 32 || lanes > 1024 || lanes % 32 != 0 ||
      (probe == 4 && nb < 1) || (units > 0 && x == nullptr) || units != want_units ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || (!loads && threads != lanes) ||
      smem_bytes < 4 * units)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!loads) {
    probe_stores_kernel<<<1, threads, 0, stream>>>(probe, out, steps, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem_bytes > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_loads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_loads_kernel<<<1, threads, smem_bytes, stream>>>(probe, x, out, steps, lanes, nb,
                                                         units);
  return static_cast<int>(cudaGetLastError());
}
