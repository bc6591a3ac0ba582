// K7c: the low-rank reparameterised sampler, z = u1 * D + u2 U^T + m.
//
// Replaces ops/pallas/location_scale_kernels.py::_lowrank_sample_raw (the
// pallas_call over _lowrank_kernel, :135-177).  The plain PyTorch version is
// lowrank_sample_reference in ops/cuda/location_scale_kernels.py; the VJP
// (dm = sum ct, dD = sum ct u1, dU = ct^T u2) runs outside the kernel, as the
// reference's _lr_bwd does.
//
// What bounds it on an H100: bytes.  At the sampler shape n = 65,536,
// d = 256, r = 8 it writes z and u1 (67 MB each) and u2 (2 MB), 0.04 ms at
// 3.35 TB/s; the work is two Philox4x32-10 blocks and four Box-Muller
// normals per four lanes and r multiply-adds per element (0.27 GFLOP, under
// 0.005 ms at the float32 peak).
//
// Design: a block owns 128 lanes (32 lane groups of four) of a tile of 64
// sample rows; 256 threads, each one lane group of eight rows of the tile.
// The block keeps its 128-lane slice of U (r x 128, transposed) and the
// tile's factor draws u2 (64 x r) in shared memory: a thread reads four U
// entries as one float4 and the u2 entry of its row as a warp-wide
// broadcast.  u1 comes from csrc/philox.cuh's counter (iteration, row, lane
// group, streams 0 and 1), the same function as the mean-field sampler, so
// u1 equals K7a's u bit for bit; u2 from (iteration, row, factor group,
// streams 2 and 3), drawn by every block of the tile's rows and stored by
// the blocks of the first lane slice.  z is formed with explicit
// round-to-nearest multiply and adds in the plain version's order ((u1 D +
// u2 U^T) + m), so with U = 0 it equals the mean-field sampler's z bit for
// bit; otherwise only the r-term sum's order differs from the plain product.
// u1 and z are written with float4 stores when d is a multiple of 4.  Sample
// row i of a launch draws from counter row first_row + i (u1 and u2 alike),
// so a launch at (first_row, n) writes rows [first_row, first_row + n) of any
// larger draw bit for bit; first_row enters only the counters, never the
// tiling.
#include "philox.cuh"

namespace {

constexpr int kGroups = 32;           // threadIdx.x: lane groups of four
constexpr int kLanes = 4 * kGroups;   // lanes a block owns
constexpr int kRowsPerPass = 8;       // threadIdx.y
constexpr int kTileRows = 64;         // sample rows of one tile
constexpr int kThreads = kGroups * kRowsPerPass;
constexpr int kMaxGridRows = 65535;   // gridDim.y limit
constexpr uint32_t kFactorStream = 2u;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block

__global__ void __launch_bounds__(kThreads)
    lowrank_sample_kernel(const float* __restrict__ loc, const float* __restrict__ D,
                          const float* __restrict__ U, float* __restrict__ z,
                          float* __restrict__ u1, float* __restrict__ u2, int n, int d, int r,
                          uint32_t k0, uint32_t k1, uint32_t it, uint32_t first_row) {
  extern __shared__ float smem[];
  float* us = smem;                  // (kTileRows, r): the tile's factor draws
  float* fs = smem + kTileRows * r;  // (r, kLanes): fs[k][c] = U[col0 + c, k]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kGroups + tx;
  const int col0 = blockIdx.x * kLanes;
  const int g = blockIdx.x * kGroups + tx;  // this thread's lane group
  const int groups = (d + 3) / 4;
  const int rgroups = (r + 3) / 4;
  for (int e = tid; e < r * kLanes; e += kThreads) {
    const int k = e / kLanes;
    const int col = col0 + (e - k * kLanes);
    fs[e] = col < d ? U[static_cast<size_t>(col) * r + k] : 0.0f;
  }
  const int j0 = 4 * g;
  const int cnt = g < groups ? min(4, d - j0) : 0;
  float m[4], s[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    m[p] = p < cnt ? loc[j0 + p] : 0.0f;
    s[p] = p < cnt ? D[j0 + p] : 0.0f;
  }
  const bool vec = (cnt == 4) && (d % 4 == 0);
  const bool store_u2 = blockIdx.x == 0;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int row0 = t * kTileRows;
    __syncthreads();  // the previous tile's reads of us are done; fs has landed
    for (int e = tid; e < kTileRows * rgroups; e += kThreads) {
      const int i = e / rgroups;
      const int q = e - i * rgroups;
      const int row = row0 + i;
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < n)
        avi::normals4(k0, k1, it, first_row + static_cast<uint32_t>(row),
                      static_cast<uint32_t>(q), w, kFactorStream);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int k = 4 * q + p;
        if (k < r) {
          us[i * r + k] = w[p];
          if (store_u2 && row < n) u2[static_cast<size_t>(row) * r + k] = w[p];
        }
      }
    }
    __syncthreads();
    if (cnt == 0) continue;
    for (int i = ty; i < kTileRows; i += kRowsPerPass) {
      const int row = row0 + i;
      if (row >= n) break;
      float w[4];
      avi::normals4(k0, k1, it, first_row + static_cast<uint32_t>(row),
                    static_cast<uint32_t>(g), w);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* ur = us + i * r;
      for (int k = 0; k < r; ++k) {
        const float a = ur[k];
        const float4 f = reinterpret_cast<const float4*>(fs + k * kLanes)[tx];
        acc[0] = fmaf(a, f.x, acc[0]);
        acc[1] = fmaf(a, f.y, acc[1]);
        acc[2] = fmaf(a, f.z, acc[2]);
        acc[3] = fmaf(a, f.w, acc[3]);
      }
      float zz[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        zz[p] = __fadd_rn(__fadd_rn(__fmul_rn(w[p], s[p]), acc[p]), m[p]);
      const size_t base = static_cast<size_t>(row) * d + j0;
      if (vec) {
        *reinterpret_cast<float4*>(u1 + base) = make_float4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<float4*>(z + base) = make_float4(zz[0], zz[1], zz[2], zz[3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p < cnt) {
            u1[base + p] = w[p];
            z[base + p] = zz[p];
          }
        }
      }
    }
  }
}

}  // namespace

// The dynamic shared memory of a launch at rank r.
extern "C" size_t lowrank_sample_smem_bytes(int r) {
  return sizeof(float) * static_cast<size_t>(r) * (kTileRows + kLanes);
}

// z, u1: (n, d) float32, row-major, 16-byte aligned; u2: (n, r); loc, D:
// (d,); U: (d, r) row-major; row i takes counter row first_row + i.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a rank the kernel does not take.
extern "C" int lowrank_sample(const float* loc, const float* D, const float* U, float* z,
                              float* u1, float* u2, int n, int d, int r, uint32_t seed0,
                              uint32_t seed1, uint32_t it, uint32_t first_row,
                              cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = lowrank_sample_smem_bytes(r);
  if (r < 1 || smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lowrank_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const dim3 grid((d + kLanes - 1) / kLanes, min(tiles, kMaxGridRows));
  const dim3 block(kGroups, kRowsPerPass);
  lowrank_sample_kernel<<<grid, block, smem, stream>>>(loc, D, U, z, u1, u2, n, d, r, seed0,
                                                       seed1, it, first_row);
  return static_cast<int>(cudaGetLastError());
}
