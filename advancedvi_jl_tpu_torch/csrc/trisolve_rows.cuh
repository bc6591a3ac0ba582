// The blocked right division by a lower-triangular C that the triangular
// solve kernel (trisolve.cu, K8) and the fused full-rank kernel's whitening
// (fused_advi_fullrank.cu, C^{-T} u_i = (u C^{-1})_i) share:
//
//   mode C : W = V C^{-1}  (W C = V)
//   mode CT: W = V C^{-T}  (W C^T = V)
//
// C is cut into panels of 32 columns, D_p the 32 x 32 diagonal block of
// panel p.  Panel by panel (backward in mode C, forward in CT):
//
//   mode C : W_p = (V_p - sum_{q > p} W_q C[q, p])   D_p^{-1}
//   mode CT: W_p = (V_p - sum_{q < p} W_q C[p, q]^T) D_p^{-T}
//
// Each D_p is inverted once, exactly as substitution would (one warp, lane
// l one column of the panel's operator, the 32 diagonal reciprocals formed
// once, no division and no cross-lane chain: diag_block_inverse), and kept
// as M_p = D_p^{-1} (mode C) or D_p^{-T} (CT), so that the panel's unknowns
// are w_j = sum_k r_k M_p[k][j]: 32 independent products a row.  Then the
// solved panel is subtracted from the unsolved columns.  The sequential
// depth is d / 32 panels of one product and one update each, where a
// per-row substitution takes d dependent steps, each a division.  Every
// sum runs over k in a fixed order (the result does not depend on the
// thread mapping), in float32 FMAs.  Only the lower triangle of C is read.
// What bounds it is the panel walk's latency, not arithmetic: in the fused
// full-rank single-block kernel (C read through a generic pointer) the
// whitening takes 7.4 us a step at d = 62 (C in shared memory) and 121 us
// at d = 512 (C in L2), H100 80GB HBM3 at 700 W.  The fused cluster kernel
// (fused_advi_fullrank.cu) walks the same panels over a thread-block
// cluster, a panel's owner solving it with diag_block_inverse's operator
// and the same sums in the same order; its times are in PERF.md.
#pragma once

#include <cuda_runtime.h>

namespace avi {

constexpr int kTriPanel = 32;                      // unknowns per panel: one a lane
constexpr int kTriBlock = kTriPanel * kTriPanel;  // floats of one panel's operator

__host__ __device__ inline int tri_panels(int d) { return (d + kTriPanel - 1) / kTriPanel; }

// Warp-level: writes panel p's operator M_p (row-major, 32 x 32) to M
// (shared or device memory), first using M to stage D_p.  Past the ragged
// edge of the last panel D_p is padded with the identity, so M_p[k][j] = 0
// for k < pw <= j.  Every lane of the warp must call it.
template <bool kCT>
__device__ void diag_block_inverse(const float* C, int d, int p, float* M, int lane) {
  const int c0 = p * kTriPanel;
  const int pw = min(kTriPanel, d - c0);
  for (int i = 0; i < kTriPanel; ++i) {  // D_p[i][lane], one coalesced row a step
    float v = i == lane ? 1.0f : 0.0f;
    if (i < pw && lane < pw)
      v = lane <= i ? C[static_cast<size_t>(c0 + i) * d + c0 + lane] : 0.0f;
    M[i * kTriPanel + lane] = v;
  }
  __syncwarp();
  const float rinv = 1.0f / M[lane * kTriPanel + lane];  // lane l: 1 / D[l][l]
  float x[kTriPanel];
  if (!kCT) {
    // lane l: column l of X = D^{-1},
    //   X[i][l] = (delta_il - sum_{k<i} D[i][k] X[k][l]) / D[i][i]
#pragma unroll
    for (int i = 0; i < kTriPanel; ++i) {
      float acc = i == lane ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < i; ++k) acc = fmaf(-M[i * kTriPanel + k], x[k], acc);
      x[i] = acc * __shfl_sync(0xffffffffu, rinv, i);
    }
  } else {
    // lane l: row l of X, which is column l of X^T = D^{-T},
    //   X[l][j] = (delta_lj - sum_{k>j} X[l][k] D[k][j]) / D[j][j]
#pragma unroll
    for (int j = kTriPanel - 1; j >= 0; --j) {
      float acc = j == lane ? 1.0f : 0.0f;
#pragma unroll
      for (int k = kTriPanel - 1; k > j; --k) acc = fmaf(-M[k * kTriPanel + j], x[k], acc);
      x[j] = acc * __shfl_sync(0xffffffffu, rinv, j);
    }
  }
  __syncwarp();
  for (int i = 0; i < kTriPanel; ++i) M[i * kTriPanel + lane] = x[i];  // column `lane` of M_p
}

// Mode C for `rows` rows of V held in shared memory (rs, leading dimension
// d), solved in place: on return rs holds W = V C^{-1}.  C may lie in
// shared or device memory; M: tri_panels(d) * kTriBlock floats (shared or
// device memory) for the panel operators, formed here (C changes between
// calls).  Every thread of the block must call it, with rs ready (a
// barrier before the call); it ends with a barrier.
__device__ void solve_right_rows(const float* C, int d, float* rs, int rows, float* M) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  const int panels = tri_panels(d);
  for (int p = warp; p < panels; p += warps)
    diag_block_inverse<false>(C, d, p, M + p * kTriBlock, lane);
  __syncthreads();
  for (int p = panels - 1; p >= 0; --p) {
    const int c0 = p * kTriPanel;
    const int pw = min(kTriPanel, d - c0);
    const float* Mp = M + p * kTriBlock;
    // the panel's unknowns, one warp per row: w_j = sum_k r_k M_p[k][j]
    for (int r = warp; r < rows; r += warps) {
      float* rr = rs + r * d + c0;
      float w = 0.0f;
      for (int k = 0; k < pw; ++k) w = fmaf(rr[k], Mp[k * kTriPanel + lane], w);
      __syncwarp();
      if (lane < pw) rr[lane] = w;
    }
    __syncthreads();
    if (c0 == 0) break;
    // subtract them from the unsolved columns c < c0: a thread per (column,
    // group of rows), up to 8 rows of its group at once per read of C
    // (more rows, or an unrolled k loop, made the fused full-rank kernel
    // spill under its 88-register cap and run slower)
    const int groups = max(1, min(rows, threads / c0));
    for (int e = tid; e < c0 * groups; e += threads) {
      const int g = e / c0;
      const int c = e - g * c0;
      for (int r0 = g; r0 < rows; r0 += 8 * groups) {
        float acc[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
        for (int k = 0; k < pw; ++k) {
          const float cv = C[static_cast<size_t>(c0 + k) * d + c];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int r = r0 + q * groups;
            if (r < rows) acc[q] = fmaf(rs[r * d + c0 + k], cv, acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int r = r0 + q * groups;
          if (r < rows) rs[r * d + c] -= acc[q];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace avi
