// K8: batched right division by a lower-triangular factor C (d x d).
//
//   mode C : W = V C^{-1}  (W C = V):    w_c = (v_c - sum_{k>c} w_k C[k,c]) / C[c,c]
//   mode CT: W = V C^{-T}  (W C^T = V):  w_c = (v_c - sum_{k<c} C[c,k] w_k) / C[c,c]
//
// Replaces ops/pallas/trisolve_kernels.py::_solve_raw (the pallas_call over
// _kernel).  The plain PyTorch version is solve_right_reference in
// ops/cuda/trisolve_kernels.py.  The JAX kernel inverts 128-wide diagonal
// blocks by Newton iterations and updates at full width, a design shaped
// for the TPU's 128 x 128 matrix unit; this one is a plain substitution.
//
// What bounds it on an H100: the dependency chain along d.  The rows of V
// are independent, but within a row each w_c needs every w_k solved before
// it: d sequential steps.  The arithmetic is small (n d^2 / 2 multiply-adds,
// 134M at the main path's n = 256, d = 1024) and C (4 MB at d = 1024) stays
// in the 50 MB L2 across blocks.
//
// Design: a block owns 8 rows of V, held in shared memory (8 d floats), and
// solves them with avi::solve_right_rows (trisolve_rows.cuh): C in panels
// of 32 columns, each panel's diagonal block staged in shared memory so the
// sequential chain of one warp per row runs on shuffles and shared memory
// only, then one block-wide update of the still-unsolved columns.  C (4 MB
// at d = 1024) is read from L2, once per block.  The block has 1,024
// threads although only 8 warps run the chains: the panel updates, which
// wait on L2 reads of C, took three quarters of the solve with 256 threads
// (H100, 256 x 1024), and more threads in flight hide more of that latency
// (0.40 ms with 256 threads, 0.28 with 512, 0.25 with 1,024, mode C).
#include "trisolve_rows.cuh"

namespace {

constexpr int kRows = 8;  // rows of V per block: one warp each for the chains
constexpr int kThreads = 1024;
constexpr int kMaxGridRows = 65535;

// one block of 1,024 threads per SM: up to 64 registers a thread
template <bool kCT>
__global__ void __launch_bounds__(kThreads, 1)
    trisolve_kernel(const float* __restrict__ C, const float* __restrict__ V,
                    float* __restrict__ W, int n, int d) {
  extern __shared__ float smem[];  // (kRows, d) rows, then the panel scratch
  float* rs = smem;
  float* dblk = smem + kRows * d;
  const int row_tiles = (n + kRows - 1) / kRows;
  for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int row0 = rt * kRows;
    const int rows = min(kRows, n - row0);
    for (int e = threadIdx.x; e < rows * d; e += kThreads)
      rs[e] = V[static_cast<size_t>(row0) * d + e];
    __syncthreads();
    avi::solve_right_rows<kCT>(C, d, rs, rows, dblk, W + static_cast<size_t>(row0) * d);
  }
}

}  // namespace

extern "C" size_t trisolve_smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(kRows) * d + avi::kTriScratch);
}

// C: (d, d) row-major, only its lower triangle is read; V, W: (n, d)
// row-major float32.  transpose != 0 selects mode CT.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int trisolve(const float* C, const float* V, float* W, int n, int d,
                        int transpose, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = trisolve_smem_bytes(d);
  const int blocks = min((n + kRows - 1) / kRows, kMaxGridRows);
  cudaError_t err;
  if (transpose) {
    err = cudaFuncSetAttribute(trisolve_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    trisolve_kernel<true><<<blocks, kThreads, smem, stream>>>(C, V, W, n, d);
  } else {
    err = cudaFuncSetAttribute(trisolve_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    trisolve_kernel<false><<<blocks, kThreads, smem, stream>>>(C, V, W, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
