// The batched right division by a lower-triangular C that the triangular
// solve kernel (trisolve.cu, K8) runs, as a block-level device function the
// fused full-rank kernel (fused_advi_fullrank.cu) runs too, for its
// whitening C^{-T} u_i = (u C^{-1})_i:
//
//   mode C : W = V C^{-1}  (W C = V):    w_c = (v_c - sum_{k>c} w_k C[k,c]) / C[c,c]
//   mode CT: W = V C^{-T}  (W C^T = V):  w_c = (v_c - sum_{k<c} C[c,k] w_k) / C[c,c]
//
// The rows of V are independent, but within a row each unknown needs every
// unknown solved before it: d sequential steps, which bound the solve.  C
// is walked in panels of 32 columns in the order of the substitution
// (backward for mode C, forward for CT).  For each panel the block stages
// the 32 x 32 diagonal block of C in shared memory; one warp per row then
// solves the panel's 32 unknowns with warp shuffles (lane l owns column
// c0 + l; the owner of the next unknown divides by the diagonal and
// broadcasts; every lane with an unsolved column subtracts its share), so
// the sequential chain touches only registers and shared memory.  Then the
// whole block subtracts the panel's solved unknowns from every unsolved
// column of every row at once (one thread per column, eight rows at a
// time), reading C from wherever it lies (column-coalesced in mode C, 128
// contiguous bytes a thread in mode CT).  The sequential depth is d shuffle
// steps plus 3 d / 32 block barriers.  Only the lower triangle of C is read.
#pragma once

#include <cuda_runtime.h>

namespace avi {

constexpr int kTriPanel = 32;                             // unknowns per panel: one a lane
constexpr int kTriScratch = kTriPanel * (kTriPanel + 1);  // floats of `dblk`

// Weight of the solved unknown k in the equation of column c.
template <bool kCT>
__device__ __forceinline__ float tri_coef(const float* C, int d, int k, int c) {
  return kCT ? C[static_cast<size_t>(c) * d + k] : C[static_cast<size_t>(k) * d + c];
}

// Solves `rows` rows of V held in shared memory (rs, leading dimension d) in
// place: on return rs holds W.  When `out` is not null, row r of W is also
// written to out[r * d ...].  dblk: kTriScratch floats of shared memory.
// Every thread of the block must call it (it holds block barriers), with
// the block's data ready (a barrier before the call).
template <bool kCT>
__device__ void solve_right_rows(const float* C, int d, float* rs, int rows, float* dblk,
                                 float* out) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  const int panels = (d + kTriPanel - 1) / kTriPanel;
  for (int step = 0; step < panels; ++step) {
    const int p = kCT ? step : panels - 1 - step;
    const int c0 = p * kTriPanel;
    const int pw = min(kTriPanel, d - c0);

    // the panel's diagonal block: dblk[k][c] = C[c0 + k][c0 + c], lower part
    for (int e = tid; e < kTriPanel * kTriPanel; e += threads) {
      const int k = e / kTriPanel;
      const int c = e - k * kTriPanel;
      dblk[k * (kTriPanel + 1) + c] =
          (k < pw && c <= k) ? C[static_cast<size_t>(c0 + k) * d + c0 + c] : 0.0f;
    }
    __syncthreads();

    // in-panel substitution, one warp per row
    for (int r = warp; r < rows; r += warps) {
      float* rrow = rs + r * d;
      float x = lane < pw ? rrow[c0 + lane] : 0.0f;
      for (int s = 0; s < pw; ++s) {
        const int jl = kCT ? s : pw - 1 - s;  // panel lane of the next unknown
        const float wj = __shfl_sync(0xffffffffu, x / dblk[jl * (kTriPanel + 1) + jl], jl);
        if (lane == jl) x = wj;
        // mode C: unknown jl enters column lane < jl with C[jl][lane];
        // mode CT: it enters column lane > jl with C[lane][jl]
        const bool open = kCT ? (lane > jl && lane < pw) : (lane < jl);
        const float g = kCT ? dblk[lane * (kTriPanel + 1) + jl] : dblk[jl * (kTriPanel + 1) + lane];
        if (open) x = fmaf(-g, wj, x);
      }
      if (lane < pw) {
        rrow[c0 + lane] = x;
        if (out != nullptr) out[static_cast<size_t>(r) * d + c0 + lane] = x;
      }
    }
    __syncthreads();

    // subtract the panel's unknowns from every unsolved column
    const int lo = kCT ? c0 + pw : 0;
    const int hi = kCT ? d : c0;
    for (int c = lo + tid; c < hi; c += threads) {
      for (int r0 = 0; r0 < rows; r0 += 8) {
        float acc[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
        for (int k = 0; k < pw; ++k) {
          const float g = tri_coef<kCT>(C, d, c0 + k, c);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (r0 + q < rows) acc[q] = fmaf(rs[(r0 + q) * d + c0 + k], g, acc[q]);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (r0 + q < rows) rs[(r0 + q) * d + c] -= acc[q];
      }
    }
    __syncthreads();
  }
}

}  // namespace avi
