// K7b: the full-rank reparameterised sampler, z = u tril(C)^T + m.
//
// Replaces ops/pallas/location_scale_kernels.py::_fullrank_sample_raw (the
// pallas_call over _fullrank_kernel).  The plain PyTorch version is
// fullrank_sample_reference in ops/cuda/location_scale_kernels.py.
//
// What bounds it on an H100: at the main path's shape (n = 256 samples,
// d = 1024) it is a float32 product of 256 x 1024 by the lower triangle of a
// 1024 x 1024 factor, about 134M multiply-adds after the skip below, against
// 4 MB of C read (it stays in the 50 MB L2) and 2 MB of z and u written: the
// FMA pipes bound it, 2 us at the 67 TFLOP/s float32 peak.  The draws add
// 262k normals (two Philox blocks per four lanes, one log, cos and sqrt per
// lane).  At the fused-comparison shape (10 x 62) the launch is the cost.
//
// Design: an output tile of 32 sample rows x 64 columns per block, 256
// threads of 2 x 4 outputs each, walking the sum index k in steps of 32
// through shared memory.  z[i, c] = sum_{k <= c} u[i, k] C[c, k], so a block
// stops at the end of its own column tile: tiles wholly above the diagonal
// of C are never loaded, which halves the work, and entries above the
// diagonal inside the last tile are read as zero (only the lower triangle of
// C is read).  The u tile is drawn in the block from Philox with the counter
// (iteration, row, lane group, stream) of csrc/philox.cuh, the same function
// as the mean-field sampler, so u equals K7a's u bit for bit.  A block draws
// the u it needs for every k below its column tile; it stores only the
// lanes of its own column tile, so every element of u is written once.  C
// is stored transposed in shared memory with one word of padding, so both
// the coalesced load and the reads of the product are free of bank
// conflicts.  Tensor cores are not used: this slice keeps full float32 (no
// TF32 rounding) and makes the kernel right first.
#include "philox.cuh"

namespace {

constexpr int kBM = 32;   // sample rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 32;   // depth of one shared-memory step
constexpr int kThreads = 256;
constexpr int kMaxGridRows = 65535;

__global__ void __launch_bounds__(kThreads)
    fullrank_sample_kernel(const float* __restrict__ loc,
                           const float* __restrict__ C, float* __restrict__ z,
                           float* __restrict__ u, int n, int d, uint32_t k0,
                           uint32_t k1, uint32_t it) {
  __shared__ float us[kBM][kBK + 1];
  __shared__ float cs[kBK][kBN + 1];  // cs[k][c] = C[col0 + c][k0 + k]
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx + 16 q, q = 0..3
  const int ty = tid >> 4;  // rows ty and ty + 16
  const int col0 = blockIdx.x * kBN;
  const int kend = min(d, col0 + kBN);
  const int row_tiles = (n + kBM - 1) / kBM;

  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const int row0 = rt * kBM;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kb = 0; kb < kend; kb += kBK) {
      // the u tile: one group of four lanes per thread
      {
        const int r = tid >> 3;
        const int g = tid & 7;
        const int row = row0 + r;
        const int j0 = kb + 4 * g;
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < n && j0 < d)
          avi::normals4(k0, k1, it, static_cast<uint32_t>(row),
                        static_cast<uint32_t>(j0 / 4), w);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int j = j0 + p;
          const float v = j < d ? w[p] : 0.0f;
          us[r][4 * g + p] = v;
          if (row < n && j < d && j >= col0)
            u[static_cast<size_t>(row) * d + j] = v;
        }
      }
      // the C tile, lower triangle only: 64 rows of C x 32 columns
      for (int e = tid; e < kBN * kBK; e += kThreads) {
        const int c = e / kBK;
        const int k = e - c * kBK;
        const int row = col0 + c;
        const int col = kb + k;
        cs[k][c] = (row < d && col <= row) ? C[static_cast<size_t>(row) * d + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float a0 = us[ty][k];
        const float a1 = us[ty + 16][k];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float b = cs[k][tx + 16 * q];
          acc[0][q] = fmaf(a0, b, acc[0][q]);
          acc[1][q] = fmaf(a1, b, acc[1][q]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + ty + 16 * r;
      if (row >= n) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = col0 + tx + 16 * q;
        if (col < d) z[static_cast<size_t>(row) * d + col] = __fadd_rn(acc[r][q], loc[col]);
      }
    }
  }
}

}  // namespace

// z, u: (n, d) float32, row-major; loc: (d,); C: (d, d) row-major, only its
// lower triangle is read.  Returns cudaGetLastError() after the launch.
extern "C" int fullrank_sample(const float* loc, const float* C, float* z, float* u,
                               int n, int d, uint32_t seed0, uint32_t seed1,
                               uint32_t it, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int row_tiles = (n + kBM - 1) / kBM;
  const dim3 grid((d + kBN - 1) / kBN, min(row_tiles, kMaxGridRows));
  fullrank_sample_kernel<<<grid, kThreads, 0, stream>>>(loc, C, z, u, n, d, seed0,
                                                        seed1, it);
  return static_cast<int>(cudaGetLastError());
}
