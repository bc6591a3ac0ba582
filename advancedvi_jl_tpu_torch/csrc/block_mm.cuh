// One block product for the fused kernels' thread block: C (M x N) =
// A (M x K) B (K x N), every operand in shared memory or behind a generic
// pointer, A(i, k) = A[i * sam + k * sak] and B(k, j) = B[k * sbk + j * sbn].
// The hand logreg body (fused_common.cuh: its logits and its likelihood
// gradient) and K5's generated body (ops/cuda/ad_body.py, every mm and mv
// node, with literal shapes and strides) call it.
//
// What bounds such a product on an H100 at the fused kernels' widths (the
// flagship's 10 x 208 x 61 and 10 x 61 x 208, one SM): the bytes shared
// memory delivers to the lanes (every lane's, a broadcast too) and the
// latency of the k loop, not multiply-adds.  One output a thread with a
// k-long fmaf chain loads two floats a multiply-add; here a thread owns a
// TM x TN tile of outputs in registers, so one load of B feeds TM
// multiply-adds.  Where the operand's k-stride is 1 and its rows 16-byte
// aligned (kVecA, kVecB), four k are one float4 load (fewer instructions).
//
// Where M x N / tile leaves threads idle, KS consecutive lanes split k: k is
// cut into units of four (the last may be shorter), lane s of a group takes
// units s, s + KS, s + 2 KS, ... in order, each unit's terms in order, into
// one fmaf chain per output; the KS partial sums then meet in an xor
// butterfly over the group's lanes, so every lane ends with the same bits.
// The order of every sum is fixed by (K, KS): each launch gives the same
// bits, and two callers with the same (K, KS) give the same bits.  Float32
// on the CUDA cores throughout (no TF32: the fused kernels hold float32
// parity with their plain versions).
//
// epi(i, j, v) stores output (i, j), once, from the group's lane s = 0.
// Every thread of the block calls it with the same arguments; no barrier
// inside: the caller puts one before (A and B written) and after (C read).
#pragma once

#include <cuda_runtime.h>

namespace avi {

// Floats rounded up to whole float4s: the offset or row stride of an array
// that block_mm reads four k at a time.
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

template <int kThreads, int TM, int TN, int KS, bool kVecA, bool kVecB, class Epi>
__device__ __forceinline__ void block_mm(int M, int N, int K, const float* A, int sam, int sak,
                                         const float* B, int sbk, int sbn, int tid, Epi epi) {
  static_assert(KS >= 1 && KS <= 32 && (KS & (KS - 1)) == 0, "KS: a power of two, at most 32");
  static_assert(kThreads % 32 == 0, "whole warps");
  const int NB = (N + TN - 1) / TN;
  const int slots = ((M + TM - 1) / TM) * NB * KS;
  const int full = K / 4;         // whole units of four k
  const int tail = K - 4 * full;  // terms of the last, shorter unit
  const int s = tid & (KS - 1);
  // a trip count uniform over the block, so every lane reaches the butterfly
  for (int base = 0; base < slots; base += kThreads) {
    const int slot = base + tid;
    const bool act = slot < slots;
    const int task = act ? slot / KS : 0;
    const int rb = task / NB;
    const int i0 = rb * TM;
    const int j0 = (task - rb * NB) * TN;
    const int rows = min(TM, M - i0);  // rows of this tile below M
    const int cols = min(TN, N - j0);
    const float* Ar = A + i0 * sam;    // the tile's first row and column
    const float* Bc = B + j0 * sbn;
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
    if (act) {
      for (int u = s; u < full; u += KS) {
        const int k0 = 4 * u;
        float b[4][TN];
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const float* bp = Bc + (c < cols ? c : 0) * sbn;
          if (kVecB) {
            const float4 v = *reinterpret_cast<const float4*>(bp + k0);
            b[0][c] = v.x;
            b[1][c] = v.y;
            b[2][c] = v.z;
            b[3][c] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) b[q][c] = bp[(k0 + q) * sbk];
          }
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          if (r < rows) {
            const float* ap = Ar + r * sam;
            float a[4];
            if (kVecA) {
              const float4 v = *reinterpret_cast<const float4*>(ap + k0);
              a[0] = v.x;
              a[1] = v.y;
              a[2] = v.z;
              a[3] = v.w;
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) a[q] = ap[(k0 + q) * sak];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[q], b[q][c], acc[r][c]);
          }
        }
      }
      if (tail > 0 && s == (full & (KS - 1))) {  // the last unit, after this lane's others
        const int k0 = 4 * full;
        for (int q = 0; q < tail; ++q) {
          float b[TN];
#pragma unroll
          for (int c = 0; c < TN; ++c) b[c] = Bc[(c < cols ? c : 0) * sbn + (k0 + q) * sbk];
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            if (r < rows) {
              const float a = Ar[r * sam + (k0 + q) * sak];
#pragma unroll
              for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a, b[c], acc[r][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int o = KS / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
    if (act && s == 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (r < rows && c < cols) epi(i0 + r, j0 + c, acc[r][c]);
    }
  }
}

}  // namespace avi
