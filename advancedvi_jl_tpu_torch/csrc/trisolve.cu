// K8: batched right division by a lower-triangular factor C (d x d).
//
//   mode C : W = V C^{-1}  (W C = V)
//   mode CT: W = V C^{-T}  (W C^T = V)
//
// Replaces ops/pallas/trisolve_kernels.py::_solve_raw (the pallas_call over
// _kernel).  The plain PyTorch version is solve_right_reference in
// ops/cuda/trisolve_kernels.py.  Like the JAX kernel it inverts each
// diagonal block once and then runs only products, with d / 32 sequential
// panels (trisolve_rows.cuh); the JAX kernel's blocks are 128 wide and
// inverted by Newton iterations on the TPU's matrix unit, these are 32 wide
// (a warp) and inverted by one warp's substitution, exactly.
//
// What bounds it on an H100: n d^2 / 2 multiply-adds (134M at the main
// path's n = 256, d = 1024: 0.004 ms at 67 TFLOP/s) are little; C's lower
// triangle (2 MB at d = 1024) is read from L2 by every block, so the grid
// trades SMs kept busy against L2 traffic (blocks x 2 MB).  Measured
// (H100 80GB HBM3, 700 W, CUDA-graph replay, 256 x 1024): mode C 0.140
// ms, CT 0.141 (cuBLAS trsm 0.263 and 0.282 beside it; the per-row
// substitution this replaced took 0.239 and 0.433).  That is 1.9 TB/s from
// L2, well under its rate: a block of four warps walks ~137 tiles in
// order, a barrier and a cp.async wait each, and that latency sets the
// time.  R rows a block, mode C: R = 1, 2, 4, 8 took 0.147, 0.140, 0.162,
// 0.246 ms; CT 0.152, 0.141, 0.130, 0.176; so R is the least that puts
// every row tile on the 132 SMs at once (R = 2 here).
//
// Design: two launches.  A pre-pass (one warp a panel) writes every panel's
// operator M_p = D_p^{-1} (mode C) or D_p^{-T} (CT) to a scratch tensor
// (d/32 x 32 x 32 floats, 128 KB at d = 1024) that the wrapper allocates.
// Then a block owns R rows of V in shared memory (R = 2 at n = 256: 128
// blocks on the 132 SMs; a grid-stride loop beyond 65,535 row tiles) and
// walks the panels: the panel's unknowns w = r M_p (one warp a row, written
// straight to W), one barrier, then the update of the unsolved columns,
// one thread a column, 128 columns a tile.  Every tile of C and each M_p
// come through shared memory by cp.async, 16 bytes a thread where d is a
// multiple of 4 (else 4), four tiles in flight, so later panels land while
// this one's update runs.  Mode C's tile is 32 rows of C (coalesced along
// the rows); mode CT's is the 32-column strip of 128 remaining rows, each
// row's 128 contiguous bytes copied whole and stored with its eight 16-byte
// chunks XOR-swizzled by the row, so that a thread reads its row as float4s
// free of bank conflicts.  Sequential depth: d / 32 panels of two barriers
// and one tile wait each, plus a barrier a further tile.
#include <cstdint>

#include "trisolve_rows.cuh"

namespace {

using avi::kTriBlock;
using avi::kTriPanel;

constexpr int kThreads = 128;                          // one unsolved column a thread
constexpr int kTileCols = kThreads;                    // unsolved columns a tile covers
constexpr int kTileFloats = kTriPanel * kTileCols;     // a 32 x 128 tile of C (16 KB)
constexpr int kStageFloats = kTileFloats + kTriBlock;  // the tile and a panel operator
constexpr int kStages = 4;                             // tiles in flight
constexpr int kMaxGrid = 65535;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Position of element (row, k) of a mode-CT tile: 32 floats a row, its
// 16-byte chunks XOR-swizzled by the row's low three bits.
__device__ __forceinline__ int ct_slot(int row, int k) {
  return row * kTriPanel + ((((k >> 2) ^ (row & 7))) << 2) + (k & 3);
}

// Step s of the walk: panel p, its first column c0, width pw, and the
// unsolved columns [lo, hi) its update reaches.
template <bool kCT>
struct Panel {
  int p, c0, pw, lo, hi, tiles;
  __device__ Panel(int s, int panels, int d) {
    p = kCT ? s : panels - 1 - s;
    c0 = p * kTriPanel;
    pw = min(kTriPanel, d - c0);
    lo = kCT ? c0 + pw : 0;
    hi = kCT ? d : c0;
    tiles = max(1, (hi - lo + kTileCols - 1) / kTileCols);
  }
};

// Issues the copies of tile t of step s (with the panel operator when t ==
// 0) into one stage buffer, as one commit group (empty past the end).
template <bool kCT>
__device__ void load_tile(const float* __restrict__ C, const float* __restrict__ M, int d,
                          int panels, int s, int t, bool vec4, float* buf) {
  const int tid = threadIdx.x;
  if (s < panels) {
    const Panel<kCT> P(s, panels, d);
    if (t == 0) {
      const float* src = M + static_cast<size_t>(P.p) * kTriBlock;
      for (int q = tid; q < kTriBlock / 4; q += kThreads)
        cp_async16(buf + kTileFloats + 4 * q, src + 4 * q);
    }
    const int col0 = P.lo + t * kTileCols;
    const int cw = min(kTileCols, P.hi - col0);
    if (cw > 0) {
      if (!kCT) {  // rows c0 + k of C, columns [col0, col0 + cw): [k][c - col0]
        const float* src = C + static_cast<size_t>(P.c0) * d + col0;
        if (vec4) {  // cw is a multiple of 32 here: up to 32 chunks a row
          for (int q = tid; q < P.pw * (kTileCols / 4); q += kThreads) {
            const int k = q >> 5;
            const int j = q & 31;
            if (4 * j < cw)
              cp_async16(buf + k * kTileCols + 4 * j, src + static_cast<size_t>(k) * d + 4 * j);
          }
        } else {
          for (int q = tid; q < P.pw * cw; q += kThreads) {
            const int k = q / cw;
            const int j = q - k * cw;
            cp_async4(buf + k * kTileCols + j, src + static_cast<size_t>(k) * d + j);
          }
        }
      } else {  // rows col0 + row of C, columns [c0, c0 + 32): swizzled [row][k]
        const float* src = C + static_cast<size_t>(col0) * d + P.c0;
        if (vec4) {
          for (int q = tid; q < cw * 8; q += kThreads) {
            const int row = q >> 3;
            const int j = q & 7;
            cp_async16(buf + ct_slot(row, 4 * j), src + static_cast<size_t>(row) * d + 4 * j);
          }
        } else {
          for (int q = tid; q < cw * kTriPanel; q += kThreads) {
            const int row = q >> 5;
            const int k = q & 31;
            cp_async4(buf + ct_slot(row, k), src + static_cast<size_t>(row) * d + k);
          }
        }
      }
    }
  }
  cp_async_commit();
}

template <bool kCT, int kR>
__global__ void __launch_bounds__(kThreads)
    trisolve_kernel(const float* __restrict__ C, const float* __restrict__ M,
                    const float* __restrict__ V, float* __restrict__ W, int n, int d,
                    bool vec4) {
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                        // kStages x (tile, operator)
  float* rs = smem + kStages * kStageFloats;  // (kR, d): V, then W
  float* wb = rs + kR * d;                     // (kR, 32): the panel's unknowns
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int panels = avi::tri_panels(d);
  int total = 0;  // tiles of the whole walk
  for (int s = 0; s < panels; ++s) total += Panel<kCT>(s, panels, d).tiles;
  const int row_tiles = (n + kR - 1) / kR;
  for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int row0 = rt * kR;
    const int rows = min(kR, n - row0);
    for (int e = tid; e < rows * d; e += kThreads) rs[e] = V[static_cast<size_t>(row0) * d + e];
    // the producer's cursor (ls, lt) runs kStages - 1 tiles ahead of (s, t)
    int ls = 0, lt = 0;
    for (int i = 0; i < kStages - 1; ++i) {
      load_tile<kCT>(C, M, d, panels, ls, lt, vec4, stages + i * kStageFloats);
      if (ls < panels && ++lt == Panel<kCT>(ls, panels, d).tiles) { ++ls; lt = 0; }
    }
    int s = 0, t = 0;
    for (int i = 0; i < total; ++i) {
      cp_async_wait_stages();  // tile i has landed (this thread's copies)
      __syncthreads();         // everyone's copies; tile i - 1's buffer is free
      load_tile<kCT>(C, M, d, panels, ls, lt, vec4,
                     stages + ((i + kStages - 1) % kStages) * kStageFloats);
      if (ls < panels && ++lt == Panel<kCT>(ls, panels, d).tiles) { ++ls; lt = 0; }
      const float* buf = stages + (i % kStages) * kStageFloats;
      const Panel<kCT> P(s, panels, d);
      if (t == 0) {  // the panel's unknowns: w_j = sum_k r_k M_p[k][j]
        const float* Mp = buf + kTileFloats;
        for (int r = warp; r < rows; r += kThreads / 32) {
          float* rr = rs + r * d + P.c0;
          float w = 0.0f;
#pragma unroll 8
          for (int k = 0; k < P.pw; ++k) w = fmaf(rr[k], Mp[k * kTriPanel + lane], w);
          wb[r * kTriPanel + lane] = w;
          if (lane < P.pw) W[static_cast<size_t>(row0 + r) * d + P.c0 + lane] = w;
        }
        __syncthreads();
      }
      const int c = P.lo + t * kTileCols + tid;
      if (c < P.hi) {  // subtract the panel's unknowns from column c
        float acc[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
        if (!kCT) {
#pragma unroll 8
          for (int k = 0; k < P.pw; ++k) {
            const float cv = buf[k * kTileCols + tid];
#pragma unroll
            for (int r = 0; r < kR; ++r)
              if (r < rows) acc[r] = fmaf(wb[r * kTriPanel + k], cv, acc[r]);
          }
        } else {  // pw == 32 wherever an update is left
#pragma unroll
          for (int j = 0; j < kTriPanel / 4; ++j) {
            const float4 cv = *reinterpret_cast<const float4*>(buf + ct_slot(tid, 4 * j));
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              if (r < rows) {
                const float* wr = wb + r * kTriPanel + 4 * j;
                acc[r] = fmaf(wr[0], cv.x, acc[r]);
                acc[r] = fmaf(wr[1], cv.y, acc[r]);
                acc[r] = fmaf(wr[2], cv.z, acc[r]);
                acc[r] = fmaf(wr[3], cv.w, acc[r]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (r < rows) rs[r * d + c] -= acc[r];
      }
      if (++t == P.tiles) { ++s; t = 0; }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // the empty groups past the end
    __syncthreads();  // rs and the stage buffers are free for the next row tile
  }
}

__global__ void __launch_bounds__(kThreads)
    diag_inverse_kernel(const float* __restrict__ C, float* __restrict__ M, int d,
                        bool transpose) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (p >= avi::tri_panels(d)) return;
  float* Mp = M + static_cast<size_t>(p) * kTriBlock;
  if (transpose)
    avi::diag_block_inverse<true>(C, d, p, Mp, lane);
  else
    avi::diag_block_inverse<false>(C, d, p, Mp, lane);
}

template <bool kCT, int kR>
cudaError_t launch(const float* C, const float* M, const float* V, float* W, int n, int d,
                   bool vec4, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      trisolve_kernel<kCT, kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = min((n + kR - 1) / kR, kMaxGrid);
  trisolve_kernel<kCT, kR><<<blocks, kThreads, smem, stream>>>(C, M, V, W, n, d, vec4);
  return cudaGetLastError();
}

template <bool kCT>
cudaError_t launch_rows(int rows_per_block, const float* C, const float* M, const float* V,
                        float* W, int n, int d, bool vec4, size_t smem, cudaStream_t stream) {
  switch (rows_per_block) {
    case 1: return launch<kCT, 1>(C, M, V, W, n, d, vec4, smem, stream);
    case 2: return launch<kCT, 2>(C, M, V, W, n, d, vec4, smem, stream);
    case 4: return launch<kCT, 4>(C, M, V, W, n, d, vec4, smem, stream);
    case 8: return launch<kCT, 8>(C, M, V, W, n, d, vec4, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of the solve kernel at R rows a block.
extern "C" size_t trisolve_smem_bytes(int d, int rows_per_block) {
  return sizeof(float) * (static_cast<size_t>(kStages) * kStageFloats +
                          static_cast<size_t>(rows_per_block) * (d + kTriPanel));
}

// Rows a block for n rows of V on the current device: the least R of 1, 2,
// 4, 8 whose row tiles fit on the SMs at once (R = 2 at n = 256 on 132).
extern "C" int trisolve_rows_per_block(int n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int r = 1;
  while (r < 8 && (n + r - 1) / r > sms) r *= 2;
  return r;
}

// C: (d, d) row-major, only its lower triangle is read; V, W: (n, d)
// row-major float32; M: scratch of tri_panels(d) x 32 x 32 floats.
// transpose != 0 selects mode CT; rows_per_block is 1, 2, 4 or 8.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int trisolve(const float* C, const float* V, float* W, float* M, int n, int d,
                        int transpose, int rows_per_block, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int panels = avi::tri_panels(d);
  diag_inverse_kernel<<<(panels + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      C, M, d, transpose != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const size_t smem = trisolve_smem_bytes(d, rows_per_block);
  err = transpose ? launch_rows<true>(rows_per_block, C, M, V, W, n, d, vec4, smem, stream)
                  : launch_rows<false>(rows_per_block, C, M, V, W, n, d, vec4, smem, stream);
  return static_cast<int>(err);
}
