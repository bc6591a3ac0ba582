// K4's dense-Gaussian product on one thread block, -grad = diff P with
// diff (M, d) and the precision P (d, d), for the mean-field and chains
// kernels' kMvn instances (fused_meanfield_body.cuh mvnormal_stream_body,
// fused_chains.cu) and its launcher alone (block_mm.cu block_mm_mvnormal).
// Replaces the product of ops/pallas/fused_advi.py::_mvnormal_step_factory
// (fused_advi.py:1253-1263), which the former body ran on block_mm's 10 x 1
// tile with k over 8 lanes, reading P down its columns.
//
// What bounds it on an H100: one SM's FP32 multiply-adds (10 x 512 x 512 is
// 2.6M, 20,480 clocks at 128 a clock: 10.3 us) and P's bytes crossing from
// L2 into that SM (1 MB a step at d = 512, 16 MB at 2,048).  The design:
//
// - P is read by rows.  Its rows have a stride of ld = round4(d) floats
//   (the wrapper's copy, ops/cuda/fused_advi.py kernel_precision, zeros
//   beyond d), so a row is a whole number of 16-byte units.  Where P fits
//   beside the block's other arrays it is staged in shared memory once a
//   chunk (stage_or_start); else a ring of kStages stages of `rows` rows
//   each streams it from device memory: one thread, the producer, issues
//   one TMA bulk copy a stage (cp.async.bulk ... mbarrier::complete_tx::
//   bytes) onto the stage's full mbarrier; the warps with a tile wait on
//   it, read the stage and arrive on its empty mbarrier (the consumers'
//   release); the producer waits on that and refills the stage with the
//   block kStages later.  No block barrier stands between stages, and the
//   producer is the last warp's lane 0 where that warp has no tile (at d =
//   512, n = 10 four warps compute), so no consumer waits for the others to
//   release.  The copies run kStages - 1 stages ahead of the multiply-adds,
//   from one product into the next step's (P does not change), and drain()
//   waits for the last ones before the chunk ends.  A stage takes every row
//   the block's shared memory leaves: one SM's bulk copies land at about
//   one stage every 0.43 us on an H100 whatever the stage's bytes (PERF.md,
//   the ring's rate), so the stream's rate grows with the stage.
// - A thread owns TM rows x 4 columns of the output: P's 4 columns are one
//   float4 a k (neighbouring lanes on neighbouring columns, conflict-free),
//   diff's TM rows a broadcast from the panel, diff transposed (row k holds
//   column k of each tile's rows, a tile padded to tile_pad(TM) floats so
//   its loads are float4s and float2s).  The panel holds the rows one pass
//   over P covers, every tile of the pass a thread; where M needs more,
//   passes repeat and P streams once a pass.  TM is the fewest of 2, 5, 10
//   rows whose tiles fit in four warps, else 10 (tile_rows): small widths
//   take more threads, wide ones read each P row once for every 10 rows.
// - Each output is one fmaf chain over k = 0, 1, ..., d - 1 in order, from
//   0: the bits do not depend on the tile, the panel, the ring or on which
//   block (one chain or several) runs the rows, so K6's chains equal the
//   single-chain kernel bit for bit, and each launch gives the same bits.
//
// Every thread of the block calls product() with the same arguments; it
// has block barriers inside and ends with one.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "block_mm.cuh"

namespace avi {
namespace mvn {

constexpr int kStages = 3;           // ring stages: two in flight while one is read
// A ring stage's least bytes below the last tier: smaller stages stream P
// slower than the last tier's larger ones (about 0.43 us a stage, 8 to 48
// KB, 2 to 8 stages in flight, on an H100).
constexpr int kStageMinBytes = 32768;
constexpr int kTileThreads = 128;    // tiles of TM < 10 fit in four warps
constexpr int kBarFloats = 4 * kStages;  // each stage's two mbarriers, full and empty, 8 bytes each

// Rows of diff a thread owns, for a pass of pm rows at width d: the fewest of
// 2 and 5 that covers pm or whose tiles fit in four warps, else 10.
__host__ __device__ inline int tile_rows(int pm, int d) {
  const int cg = round4(d) / 4;
  if (pm <= 2 || ((pm + 1) / 2) * cg <= kTileThreads) return 2;
  if (pm <= 5 || ((pm + 4) / 5) * cg <= kTileThreads) return 5;
  return 10;
}

// A tile's floats in a panel row: float2 (2), float4 + 1 (5), 2 float4 + float2 (10).
__host__ __device__ inline int tile_pad(int tm) { return tm == 2 ? 2 : tm == 5 ? 8 : 12; }

// Where the product keeps P and diff in shared memory, from offset `at`
// (floats): staged P (d x ld) or the ring (kStages x rows x ld) and its
// mbarriers; the panel (d x ps).  tm rows a thread, pm rows a pass.
struct Stream {
  int tm, pm, ps;  // rows a thread, rows a pass, the panel's row stride (floats)
  int rows;        // P's rows a ring stage (0: P staged whole)
  int P, bars, panel, end;  // offsets (floats); end: past the last
};

__host__ __device__ inline Stream stream_place(int at, int pm, int rows, int d, bool staged) {
  Stream S;
  const int ld = round4(d);
  S.pm = pm;
  S.tm = tile_rows(pm, d);
  S.ps = round4(((pm + S.tm - 1) / S.tm) * tile_pad(S.tm));
  S.rows = staged ? 0 : rows;
  int o = round4(at);
  S.bars = o;
  if (!staged) o += kBarFloats;
  S.P = o;
  o += staged ? d * ld : kStages * rows * ld;
  S.panel = o;
  o += d * S.ps;
  S.end = o;
  return S;
}

// The product's place for M rows at width d from offset `at`, under `limit`
// floats: a pass takes every tile a thread (M rows, or as many as 10-row
// tiles of all ld / 4 column groups allow); a ring stage every row of P
// that the room left holds (at most d).  Without `shrink`, a ring whose
// stages would hold fewer than kStageMinBytes is not taken (end > limit);
// with it, where not even one row a stage fits, the pass takes fewer rows.
// end > limit: it does not fit.  d <= 2,048 (ld / 4 column groups of at
// most 512 threads).
template <int kThreads>
__host__ __device__ inline Stream stream_at(int at, int M, int d, bool staged, int limit,
                                            bool shrink = true) {
  const int ld = round4(d);
  const int pass = 10 * (kThreads / (ld / 4));
  int pm = M < pass ? M : pass;
  for (;;) {
    Stream S = stream_place(at, pm, 1, d, staged);
    int rows = 0;
    if (!staged && S.end <= limit) {
      rows = 1 + (limit - S.end) / (kStages * ld);
      rows = rows < d ? rows : d;
      S = stream_place(at, pm, rows, d, false);
      if (!shrink && rows < d && sizeof(float) * rows * ld < kStageMinBytes) S.end = limit + 1;
    }
    if (S.end <= limit || !shrink || pm == 1) return S;
    pm = pm > 10 ? pm - 10 : pm > 5 ? 5 : pm > 2 ? 2 : 1;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool bar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` of the mbarrier at `bar`; a copy that
// never lands (some 2^26 tries, far beyond any copy's time) fails the launch
// instead of hanging the card.
__device__ __forceinline__ void bar_wait(const float* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t tries = 0; !bar_try(addr, parity);)
    if (++tries == (1u << 26)) __trap();
}

// The mbarriers of ring stage st: `full` (the stage's copy has landed) and
// `empty` (every warp has read it).
__device__ __forceinline__ float* full_bar(const Stream& S, float* smem, int st) {
  return smem + S.bars + 2 * st;
}
__device__ __forceinline__ float* empty_bar(const Stream& S, float* smem, int st) {
  return smem + S.bars + 2 * (kStages + st);
}

// The producer: block b of P's row blocks (b mod nkb; the sequence repeats
// for every pass and step) into ring stage b mod kStages, by one bulk copy
// onto the stage's full mbarrier.
__device__ __forceinline__ void issue(const Stream& S, float* smem, const float* P, int d,
                                      uint32_t b) {
  const int ld = round4(d);
  const int nkb = (d + S.rows - 1) / S.rows;
  const int k0 = static_cast<int>(b % static_cast<uint32_t>(nkb)) * S.rows;
  const uint32_t bytes = static_cast<uint32_t>(sizeof(float) * min(S.rows, d - k0) * ld);
  const int st = static_cast<int>(b % kStages);
  const uint32_t bar = smem_addr(full_bar(S, smem, st));
  // the stage's last reads (generic proxy) before the copy's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem + S.P + st * S.rows * ld)), "l"(P + static_cast<size_t>(k0) * ld),
      "r"(bytes), "r"(bar)
      : "memory");
}

// The ring's blocks one product reads for M rows: every block of P a pass.
__host__ __device__ inline int product_blocks(const Stream& S, int M, int d) {
  return S.rows == 0 ? 0 : ((M + S.pm - 1) / S.pm) * ((d + S.rows - 1) / S.rows);
}

// Before the first product of a chunk: P staged (S.rows == 0), or thread 0
// sets up the ring's mbarriers (full: thread 0's arrival and the copy's
// bytes; empty: one arrival a warp) and issues its first blocks, kStages or
// `blocks` if fewer.  The caller puts a block barrier after it; `fill` (the
// blocks read so far) starts at 0.  P: (d, ld) in device memory, 16-byte
// aligned.
template <int kThreads>
__device__ __forceinline__ void stage_or_start(const Stream& S, float* smem, const float* P,
                                               int d, int tid, uint32_t blocks = kStages) {
  if (S.rows == 0) {
    const float4* src = reinterpret_cast<const float4*>(P);
    float4* dst = reinterpret_cast<float4*>(smem + S.P);
    for (int i = tid; i < d * round4(d) / 4; i += kThreads) dst[i] = src[i];
  } else if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(full_bar(S, smem, st))),
                   "r"(1)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(empty_bar(S, smem, st))),
                   "r"(kThreads / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (uint32_t b = 0; b < kStages && b < blocks; ++b) issue(S, smem, P, d, b);
  }
}

// After the chunk's last product: thread 0 waits for the ring's copies in
// flight (kStages: every product refills the ring for the next), so none
// lands after the block has ended.
__device__ __forceinline__ void drain(const Stream& S, float* smem, uint32_t fill, int tid) {
  if (S.rows == 0 || tid != 0) return;
  for (uint32_t b = fill; b < fill + kStages; ++b)
    bar_wait(full_bar(S, smem, static_cast<int>(b % kStages)), (b / kStages) & 1);
}

template <int TM>
__device__ __forceinline__ void load_tile(const float* a, float (&x)[TM]) {
  if constexpr (TM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(a);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(a);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
    if constexpr (TM == 5) {
      x[4] = a[4];
    } else {
      const float4 w = *reinterpret_cast<const float4*>(a + 4);
      const float2 t = *reinterpret_cast<const float2*>(a + 8);
      x[4] = w.x;
      x[5] = w.y;
      x[6] = w.z;
      x[7] = w.w;
      x[8] = t.x;
      x[9] = t.y;
    }
  }
}

// kn rows of P from p (this thread's 4 columns of row k0, stride ld) against
// the panel's rows from a (this thread's tile of row k0, stride ps), k in order.
template <int TM>
__device__ __forceinline__ void fma_rows(float (&acc)[TM][4], const float* p, const float* a,
                                         int kn, int ld, int ps) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(p + k * ld);
    float x[TM];
    load_tile<TM>(a + k * ps, x);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      acc[r][0] = fmaf(x[r], b.x, acc[r][0]);
      acc[r][1] = fmaf(x[r], b.y, acc[r][1]);
      acc[r][2] = fmaf(x[r], b.z, acc[r][2]);
      acc[r][3] = fmaf(x[r], b.w, acc[r][3]);
    }
  }
}

template <int kThreads, int TM, class Epi>
__device__ __forceinline__ void product_tiles(const Stream& S, float* smem, const float* A,
                                              int M, int d, const float* P, uint32_t& fill,
                                              bool refill_all, int tid, Epi epi) {
  const int ld = round4(d);
  const int cg = ld / 4;
  const int tp = tile_pad(TM);
  float* panel = smem + S.panel;
  const int nkb = S.rows == 0 ? 1 : (d + S.rows - 1) / S.rows;
  const int c = tid % cg;  // this thread's column group
  const int t = tid / cg;  // and row tile
  const int warp = tid >> 5;
  // fill counts modulo 2 kStages nkb: its stage, parity and block of P stay
  const uint32_t wrap = 2u * kStages * static_cast<uint32_t>(nkb);
  const int blocks = product_blocks(S, M, d);
  int read = 0;  // blocks this product has read
  for (int p0 = 0; p0 < M; p0 += S.pm) {
    const int pm = min(S.pm, M - p0);
    for (int idx = tid; idx < pm * d; idx += kThreads) {  // diff's rows, transposed
      const int r = idx / d;
      const int k = idx - r * d;
      panel[k * S.ps + (r / TM) * tp + r % TM] = A[(p0 + r) * d + k];
    }
    __syncthreads();
    const int tiles = ((pm + TM - 1) / TM) * cg;
    const bool act = tid < tiles;
    const int warps = (tiles + 31) / 32;  // the warps with a tile: lanes 0.. of each
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    const float* a = panel + t * tp;
    if (S.rows == 0) {
      if (act) fma_rows<TM>(acc, smem + S.P + 4 * c, a, d, ld, S.ps);
    } else {
      // the producer: the last warp's lane 0 where that warp has no tile, else thread 0
      const int producer = warps < kThreads / 32 ? kThreads - 32 : 0;
      for (int kb = 0; kb < nkb; ++kb, ++read) {
        const int st = static_cast<int>(fill % kStages);
        const uint32_t parity = (fill / kStages) & 1;
        if (warp < warps) {  // the warps with a tile read stage st, then release it
          const int k0 = kb * S.rows;
          if (act) {
            bar_wait(full_bar(S, smem, st), parity);
            fma_rows<TM>(acc, smem + S.P + st * S.rows * ld + 4 * c, a + k0 * S.ps,
                         min(S.rows, d - k0), ld, S.ps);
          }
          __syncwarp();
          if ((tid & 31) == 0)  // warp 0 also for the warps without a tile
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n"
                         ::"r"(smem_addr(empty_bar(S, smem, st))),
                         "r"(warp == 0 ? 1 + kThreads / 32 - warps : 1)
                         : "memory");
        }
        if (tid == producer && (refill_all || read + kStages < blocks)) {
          bar_wait(empty_bar(S, smem, st), parity);  // every warp has read it: refill it
          issue(S, smem, P, d, fill + kStages);
        }
        fill = fill + 1 == wrap ? 0 : fill + 1;
      }
    }
    if (act) {
      const int i0 = p0 + t * TM;
      const int rows = min(TM, p0 + pm - i0);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r < rows && 4 * c + q < d) epi(i0 + r, 4 * c + q, acc[r][q]);
    }
    __syncthreads();  // the next pass overwrites the panel
  }
}

// epi(i, j, v) receives (diff P)(i, j) once, for the M rows of A (M, d;
// row-major, in shared or device memory) against P as S places it: staged
// at smem + S.P, or streamed from `P` (d, ld) in device memory through the
// ring, `fill` counting the ring's blocks read (the caller's, kept from the
// chunk's stage_or_start to its drain).  With `refill_all` every block read
// is refilled with the one kStages later, so the next product's first blocks
// are in flight when this one ends (the fused kernels, whose P does not
// change); without it the ring stops at this product's last block (a
// launch of one product, which then needs no drain).
template <int kThreads, class Epi>
__device__ __forceinline__ void product(const Stream& S, float* smem, const float* A, int M,
                                        int d, const float* P, uint32_t& fill, int tid, Epi epi,
                                        bool refill_all = true) {
  if (S.tm == 2)
    product_tiles<kThreads, 2>(S, smem, A, M, d, P, fill, refill_all, tid, epi);
  else if (S.tm == 5)
    product_tiles<kThreads, 5>(S, smem, A, M, d, P, fill, refill_all, tid, epi);
  else
    product_tiles<kThreads, 10>(S, smem, A, M, d, P, fill, refill_all, tid, epi);
}

}  // namespace mvn
}  // namespace avi
