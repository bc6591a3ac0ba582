// K7a: the mean-field reparameterised sampler, z = u * sigma + m.
//
// Replaces ops/pallas/location_scale_kernels.py::_meanfield_sample_raw (the
// pallas_call over _meanfield_kernel).  The plain PyTorch version is
// meanfield_sample_reference in ops/cuda/location_scale_kernels.py.
//
// What bounds it on an H100: bytes.  Each element costs two Philox4x32-10
// blocks shared by four lanes (about 5 integer multiplies per lane and round)
// and one log, one cos and one sqrt, against 8 bytes written (z and u); at the
// main path's shapes (10 x 62) the launch itself is the cost.
//
// Design: a 2-D grid over (lane groups x sample rows).  A thread owns one
// group of four lanes of one row, makes the group's four normals from two
// Philox blocks, and writes u and z with float4 stores when the row width
// allows it, so a warp writes 512 contiguous bytes.  m and sigma are read once
// per thread and reused down the rows of a grid-stride loop.  Nothing is
// carried between threads, so the draw of (iteration, row, lane) does not
// depend on the launch geometry.  z is formed with explicit round-to-nearest
// multiply and add (no FMA contraction), the plain version's two roundings,
// so z agrees bit for bit with the plain version wherever u does.
#include "philox.cuh"

namespace {

constexpr int kGroupsPerBlock = 32;  // threadIdx.x: lane groups of four
constexpr int kRowsPerBlock = 8;     // threadIdx.y: sample rows
constexpr int kMaxGridRows = 65535;  // gridDim.y limit

__global__ void __launch_bounds__(kGroupsPerBlock * kRowsPerBlock)
    meanfield_sample_kernel(const float* __restrict__ loc,
                            const float* __restrict__ scale,
                            float* __restrict__ z, float* __restrict__ u, int n,
                            int d, uint32_t k0, uint32_t k1, uint32_t it) {
  const int groups = (d + 3) / 4;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const int j0 = 4 * g;
  const int cnt = min(4, d - j0);
  float m[4], s[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    m[p] = p < cnt ? loc[j0 + p] : 0.0f;
    s[p] = p < cnt ? scale[j0 + p] : 0.0f;
  }
  const bool vec = (cnt == 4) && (d % 4 == 0);
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < n;
       row += gridDim.y * blockDim.y) {
    float w[4];
    avi::normals4(k0, k1, it, static_cast<uint32_t>(row),
                  static_cast<uint32_t>(g), w);
    float zz[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) zz[p] = __fadd_rn(__fmul_rn(w[p], s[p]), m[p]);
    const size_t base = static_cast<size_t>(row) * d + j0;
    if (vec) {
      *reinterpret_cast<float4*>(u + base) = make_float4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<float4*>(z + base) =
          make_float4(zz[0], zz[1], zz[2], zz[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p < cnt) {
          u[base + p] = w[p];
          z[base + p] = zz[p];
        }
      }
    }
  }
}

}  // namespace

// z, u: (n, d) float32, row-major, 16-byte aligned; loc, scale: (d,) float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int meanfield_sample(const float* loc, const float* scale, float* z,
                                float* u, int n, int d, uint32_t seed0,
                                uint32_t seed1, uint32_t it,
                                cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int groups = (d + 3) / 4;
  const dim3 block(kGroupsPerBlock, kRowsPerBlock);
  const int row_blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid((groups + kGroupsPerBlock - 1) / kGroupsPerBlock,
                  min(row_blocks, kMaxGridRows));
  meanfield_sample_kernel<<<grid, block, 0, stream>>>(loc, scale, z, u, n, d,
                                                      seed0, seed1, it);
  return static_cast<int>(cudaGetLastError());
}
