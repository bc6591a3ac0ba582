// K7a: the mean-field reparameterised sampler, z = u * sigma + m.
//
// Replaces ops/pallas/location_scale_kernels.py::_meanfield_sample_raw (the
// pallas_call over _meanfield_kernel).  The plain PyTorch version is
// meanfield_sample_reference in ops/cuda/location_scale_kernels.py.
//
// What bounds it on an H100: at the main path's shapes (10 x 62) the launch
// and one warp's instructions: a lane group of four normals costs two
// Philox4x32-10 blocks and four Box-Muller normals (one log, one cos and one
// sqrt each), against 8 bytes an element written (z and u).  Large shapes
// are bound by those instructions, not by bytes.
//
// Design: a 2-D grid over (lane groups x sample rows), two threads a lane
// group.  Thread h of a pair makes the group's Philox block of stream h (the
// four u1 words for h = 0, the four u2 words for h = 1), the pair swaps two
// words by a shuffle, and each thread forms two of the group's four normals
// with the same box_muller as csrc/philox.cuh's normals4: the same bits as
// one thread making all four, from half the instructions a thread, so a
// warp's dependent chain is half as long.  A warp covers 16 groups (64
// lanes) of one row and writes u and z with float2 stores when the row
// width allows it.  m, sigma (and the iteration word) are loaded first, so
// their latency hides behind the draws.  Nothing is carried between pairs,
// so the draw of (iteration, row, lane) does not depend on the launch
// geometry.  z is formed with explicit round-to-nearest multiply and add (no
// FMA contraction), the plain version's two roundings, so z agrees bit for
// bit with the plain version wherever u does.  A programmatic dependent
// launch (the draws before griddepcontrol.wait, m and sigma after it) was
// tried on the card: faster between two sampler launches, slower behind a
// torch kernel that writes m, which is the general step's case, so this is
// a plain launch.
//
// Row offset: sample row i of a launch draws from counter row first_row + i,
// so a launch at (first_row, n) writes rows [first_row, first_row + n) of
// any larger draw bit for bit (the rows one rank of a device mesh's "mc"
// axis draws).  first_row enters only the counter, never the grid.
//
// The iteration is a host value, or a device word plus a host offset: with
// `it_base` given, the draws are those of iteration (low 32 bits of
// *it_base) + it.  A CUDA graph of K such launches with offsets 0 .. K-1, and
// one advance of the word by K, replays K new iterations each time.
#include "philox.cuh"

namespace {

constexpr int kGroupsPerBlock = 32;  // threadIdx.x / 2: lane groups of four
constexpr int kRowsPerBlock = 4;     // threadIdx.y: sample rows
constexpr int kMaxGridRows = 65535;  // gridDim.y limit

__global__ void __launch_bounds__(2 * kGroupsPerBlock * kRowsPerBlock)
    meanfield_sample_kernel(const float* __restrict__ loc, const float* __restrict__ scale,
                            float* __restrict__ z, float* __restrict__ u, int n, int d,
                            uint32_t k0, uint32_t k1, uint32_t it, uint32_t first_row,
                            const long long* __restrict__ it_base) {
  const int groups = (d + 3) / 4;
  const int g = blockIdx.x * kGroupsPerBlock + (threadIdx.x >> 1);
  const uint32_t h = threadIdx.x & 1;
  int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool active = g < groups && row < n;  // the same for both threads of a pair
  const unsigned pairs = __ballot_sync(0xffffffffu, active);
  if (!active) return;
  const int j0 = 4 * g + 2 * static_cast<int>(h);  // this thread's two lanes
  float m[2], s[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    m[p] = j0 + p < d ? loc[j0 + p] : 0.0f;
    s[p] = j0 + p < d ? scale[j0 + p] : 0.0f;
  }
  if (it_base != nullptr) it += static_cast<uint32_t>(*it_base);
  const bool vec = j0 + 1 < d && d % 2 == 0;
  const int stride = gridDim.y * blockDim.y;
  for (; row < n; row += stride) {  // rows past the grid's 65535 x 4
    const avi::Philox4 mine = avi::philox4x32_10(it, first_row + static_cast<uint32_t>(row),
                                                 static_cast<uint32_t>(g), h, k0, k1);
    // thread 0 keeps u1 words 0, 1 and sends 2, 3; thread 1 keeps u2 words
    // 2, 3 and sends 0, 1
    const uint32_t r0 = __shfl_xor_sync(pairs, h ? mine.w[0] : mine.w[2], 1);
    const uint32_t r1 = __shfl_xor_sync(pairs, h ? mine.w[1] : mine.w[3], 1);
    const uint32_t a0 = h ? r0 : mine.w[0], a1 = h ? r1 : mine.w[1];
    const uint32_t b0 = h ? mine.w[2] : r0, b1 = h ? mine.w[3] : r1;
    const float w0 = avi::box_muller(avi::uniform01(a0), avi::uniform01(b0));
    const float w1 = avi::box_muller(avi::uniform01(a1), avi::uniform01(b1));
    const float z0 = __fadd_rn(__fmul_rn(w0, s[0]), m[0]);
    const float z1 = __fadd_rn(__fmul_rn(w1, s[1]), m[1]);
    const size_t base = static_cast<size_t>(row) * d + j0;
    if (vec) {
      *reinterpret_cast<float2*>(u + base) = make_float2(w0, w1);
      *reinterpret_cast<float2*>(z + base) = make_float2(z0, z1);
    } else {
      if (j0 < d) {
        u[base] = w0;
        z[base] = z0;
      }
      if (j0 + 1 < d) {
        u[base + 1] = w1;
        z[base + 1] = z1;
      }
    }
  }
}

}  // namespace

// z, u: (n, d) float32, row-major, 8-byte aligned where d is even (the
// float2 stores); loc, scale: (d,) float32.  Row i takes counter row
// first_row + i.  it_base: null (the draws of
// iteration `it`), or a device int64 whose low 32 bits plus `it` (mod 2^32)
// are the iteration.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int meanfield_sample(const float* loc, const float* scale, float* z, float* u,
                                int n, int d, uint32_t seed0, uint32_t seed1, uint32_t it,
                                uint32_t first_row, const long long* it_base,
                                cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int groups = (d + 3) / 4;
  const dim3 block(2 * kGroupsPerBlock, kRowsPerBlock);
  const int row_blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid((groups + kGroupsPerBlock - 1) / kGroupsPerBlock,
                  min(row_blocks, kMaxGridRows));
  meanfield_sample_kernel<<<grid, block, 0, stream>>>(loc, scale, z, u, n, d, seed0, seed1,
                                                      it, first_row, it_base);
  return static_cast<int>(cudaGetLastError());
}
