// The full-rank family's bfloat16 sampling product (compute_dtype="bfloat16"):
// z[:, c] = bf16(u) bf16(tril C)[c, :]^T + m[c] for the output columns
// c in [col0, col0 + ncols), the operands rounded to bfloat16 (round to
// nearest even, torch's and XLA's rounding), the sums kept in the parameter
// dtype.
//
// Replaces no Pallas kernel: the JAX package forms this product with XLA
// (families/location_scale.py:259-268, jnp.matmul of bf16 operands with
// preferred_element_type = the parameter dtype), on the path that K7b's
// (ops/pallas/location_scale_kernels.py::_fullrank_sample_raw) f32 product
// takes otherwise.  It runs after K7b's draw launch (csrc/fullrank_sample.cu,
// draws only) or on injected draws (from_base: Student-t, Laplace, noise).
// The plain PyTorch version is fullrank_bf16_reference in
// ops/cuda/location_scale_kernels.py.
//
// What bounds it on an H100: bytes.  At the main path's shape (n = 256,
// d = 1024) u and C's triangle are read as float32 (3 MB) and z written
// (1 MB): 4 MB, 1.25 us at 3.35 TB/s; the triangle's 134.5M multiply-adds
// take 0.27 us at 989 TFLOP/s dense bf16.  The operands sit in L2 (the draws
// were just written), so what a launch pays is the stream of staged tiles
// from L2 into the SMs (64 x 64 tiles read u and C again for every tile:
// 17.8 MB at 256 x 1024), their conversion to bf16, the tiles' epilogues and
// the launch.
//
// Design (float32 parameters):
//
// - The work cut.  z is cut into 64 x 64 tiles summed over k in steps of 32
//   (column tile j of C's rows stops at k = its last row: the triangle).
//   The host's stream-K plan (K7b's fullrank_plan in
//   ops/cuda/location_scale_kernels.py, each tile's epilogue counted as
//   BF16_TILE_COST steps) lays every (tile, step) end to end and gives each
//   persistent block, one an SM, an equal range.
// - The copies.  Route by shape, chosen by the wrapper before the launch
//   (bf16_route).  Where d % 4 == 0 and u and C are 16-byte aligned (TMA):
//   the block's last warp is the producer; one lane walks the block's range
//   and keeps a ring of kStages float32 stages in flight, each u's and C's
//   64-row x 32-k tiles (16 KB) brought by two TMA tensor copies (2-D tensor
//   maps of u and C, cuTensorMapEncodeTiled reached through
//   cudaGetDriverEntryPoint; rows past n or d and k past d come in as
//   zeros) onto the stage's full mbarrier; the consumers release a stage on
//   its empty mbarrier, one arrival a warp.  The ring takes what shared
//   memory leaves (kStages = 10): when every SM streams, one SM's copies
//   land well apart, so a block keeps most of its range in flight and pays
//   L2's latency about once.  Else (d % 4 != 0: the flagship's d = 62,
//   whose rows TMA cannot address; or an operand off 16 bytes) each consumer
//   group loads its own steps' tiles from device memory, 4 bytes a load, all
//   of a step's in flight at once: one warp's 4-byte asynchronous copies
//   were several times slower, held back by how many one warp has in flight.
// - The conversion.  Two consumer warpgroups take the range's steps in
//   turn (step u to group u % 2), so that one converts while the other's
//   chain of waits runs.  A group converts its stage to bf16 (round to
//   nearest even) into 64 x 32 K-major tiles in the 64-byte swizzle (8-row
//   atoms of 64-byte rows, 16-byte chunk q of row r at chunk q ^ ((r >> 1) &
//   3)) that a wgmma descriptor reads.  C's entries above the diagonal
//   (k > c) are written as 0 on the steps that cross it: a box over a
//   diagonal tile brings the upper triangle along, and NaN x 0 is NaN.  The
//   converted tiles are written through the generic proxy and read by wgmma
//   through the async proxy, so each thread fences (fence.proxy.async)
//   before its group's barrier.  Three bf16 buffers a group: the one written
//   at a step was last read by the group's product three steps back, which
//   every thread of the group waited for before the barrier of the step
//   before this one.
// - The product.  wgmma.mma_async m64n64k16 (bf16 from shared memory, f32
//   accumulators), two a step.  Each step's products go into fresh
//   accumulators (scale-d = 0 on its first), which are added to the group's
//   running sums with round-to-nearest float adds: any truncation inside the
//   tensor cores stays within one step, and the error is that of a float32
//   sum.  A group's product of one step runs while it converts its next.
// - The epilogue.  At the end of a tile's piece one group hands its sums to
//   the other through shared memory, and the receiving group (the groups
//   take turns) adds the two in group order and writes the piece out; its
//   64 values of m were fetched by cp.async when the piece began.  z (n,
//   ncols) is written by two TMA tensor stores from a 128-byte-swizzled
//   staging tile where ncols % 4 == 0 (else by the threads).  A tile cut
//   into pieces: pieces 1.. store their sums to their workspace slots, and
//   one thread sets the slot's flag behind a release fence (the barrier
//   before it makes the group's stores its own); piece 0, the last of its
//   block's range and so about the last of the tile's pieces to end, waits
//   for the other pieces' flags (acquire loads), gathers their slots into
//   the ring (idle by then: one round trip to L2), adds the pieces in piece
//   order, so z has the same bits on every call, writes z and clears the
//   flags.  No atomics and no counters to reset: the flags are left at zero,
//   so back to back launches and CUDA-graph replays need no memset, also
//   where no draw launch comes first (injected draws).
// - The launch.  Programmatic Dependent Launch: the blocks start while the
//   launch before them ends and set up their barriers; every thread waits
//   (griddepcontrol.wait) before it reads u, C, m, z or the workspace, since
//   the launch before may have written any of them (K7b's draws write u; the
//   packed layout's unpacking, or a scatter into the scale's diagonal, write
//   C just before the product).  Each block lets the next launch start at
//   once, which then overlaps this one's last blocks (a cut tile's owners).
//
// Float64 parameters (JAX accumulates in f64 there): one thread an output on
// the CUDA cores, the bf16-rounded operands widened to double and summed in
// double.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;    // rows and columns of a z tile
constexpr int kStep = 32;    // k of one staged step: two k16 products
constexpr int kConsumers = 256;            // two warpgroups, each every other step
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kAcc = kTile * kTile / 128;  // 32 accumulators a thread of a warpgroup
constexpr int kOpFloats = kTile * kStep;        // one operand's staged tile
constexpr int kStageBytes = 2 * 4 * kOpFloats;  // u's then C's tile: 16 KB
constexpr int kOpBf16Bytes = 2 * kOpFloats;     // one operand's bf16 tile: 4 KB
constexpr int kBufs = 3;                        // bf16 tile pairs a warpgroup
constexpr int kBf16Bytes = 2 * kBufs * 2 * kOpBf16Bytes;
constexpr int kXBytes = kTile * kTile * 4;      // a piece's sums: handed over, or staged out
constexpr int kLocBytes = 2 * kTile * 4;        // each group's m of a piece
constexpr int kAlign = 1024;                    // the swizzle atoms' and TMA's alignment
constexpr int kSmemLimit = 232448;              // one block's dynamic shared memory (227 KB)
constexpr int kFixed = kAlign + kBf16Bytes + kXBytes + kLocBytes;
// ring stages (float32, each with its two mbarriers): what shared memory leaves
constexpr int kStages = (kSmemLimit - kFixed) / (kStageBytes + 16);
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kSmemBytes = kFixed + kStages * (kStageBytes + 16);  // 231,072
constexpr int kSegWords = 8;  // row0, col0, step0, step1, tile, piece, pieces, slot
// named barriers: 1 + g group g's own; kHanded + (piece parity) a piece's
// sums handed from group to group
constexpr int kHanded = 3;
constexpr int kSlot4 = kTile * kTile / 4;  // a workspace slot in float4s
constexpr int kGather = kStages;  // pieces one gather holds
static_assert(kStages >= 4 && kAcc % 4 == 0, "the layout");

struct Segment {
  int row0, col0, step0, step1, tile, piece, pieces, slot;
};

__device__ __forceinline__ Segment segment(const int* __restrict__ segs, int s) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(segs + s * kSegWords));
  const int4 b = __ldg(reinterpret_cast<const int4*>(segs + s * kSegWords + 4));
  return Segment{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` of the mbarrier at `bar`; a copy
// that never lands (some 2^24 tries, far beyond any copy's time) fails the
// launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !bar_try(bar, parity);)
    if (++tries == (1u << 24)) __trap();
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// Asynchronous stores from shared memory (the async proxy reads it): a 2-D
// box of a tensor map, committed as one bulk group, and the wait for this
// thread's groups to have read their shared memory.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int col, int row,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Named barrier `id` over `count` threads: wait for all, or arrive only.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A K-major bf16 tile of 64 rows x 32 k in the 64-byte swizzle: start
// address, leading offset 1 (unused by a swizzled K-major operand), stride
// 512 bytes between 8-row atoms, layout type 2 (64-byte swizzle).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}

// Byte offset of k = 4 ch .. 4 ch + 3 of row r in such a tile.
__device__ __forceinline__ int sw64_offset(int r, int ch) {
  return r * 64 + ((((ch >> 1) ^ (r >> 1)) & 3) << 4) + ((ch & 1) << 3);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous product's issue and wait.
__device__ __forceinline__ void fence_regs(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = (scale_d ? d : 0) + A B^T over 16 of k: A 64 x 16 and B 64 x 16 of
// the swizzled tiles whose descriptors are da and db.
__device__ __forceinline__ void wgmma_k16(float (&d)[kAcc], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Group-local wait for this group's bulk stores to have read the staging
// tile, before the group writes it again.
__device__ __forceinline__ void staging_free(int g, int t) {
  if (t == 0) bulk_wait_read();
  named_sync(1 + g, 128);
}

// A finished tile piece: its sums (v, thread t of group g's kAcc outputs) go
// to z with m (mloc: m of the tile's 64 columns), through the staging tile
// xb; a tile cut into pieces meets in the workspace (work, flags) as the note
// at the top says.  Every thread of the group calls it.
__device__ __forceinline__ void epilogue(const Segment& sg, float (&v)[kAcc],
                                         const float* mloc, float* __restrict__ z,
                                         const CUtensorMap* tz, bool ztma, float4* work,
                                         int* flags, unsigned char* ring, float* xb, int n,
                                         int zc0, int cend, int g, int t) {
  if (sg.pieces > 1) {
    float4* const slots = work + static_cast<size_t>(sg.slot) * kSlot4;
    int* const full = flags + sg.slot;  // a slot's flag: 1 while it holds this launch's sums
    if (sg.piece > 0) {  // float4 j of thread t at j * 128 + t
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j)
        __stcg(slots + sg.piece * kSlot4 + j * 128 + t,
               make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));
      named_sync(1 + g, 128);
      if (t == 0)  // the group's stores before the flag (cumulative through the barrier)
        asm volatile("fence.acq_rel.gpu;\nst.relaxed.gpu.global.b32 [%0], 1;\n" ::"l"(
                         full + sg.piece)
                     : "memory");
      return;
    }
    for (int q = 1 + t; q < sg.pieces; q += 128)  // wait for every other piece's flag
      for (uint32_t tries = 0;; ++tries) {
        int f;
        asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(f) : "l"(full + q) : "memory");
        if (f) break;
        if (tries == (1u << 22)) __trap();  // a piece that never lands fails the launch
      }
    named_sync(1 + g, 128);
    float4* const ring4 = reinterpret_cast<float4*>(ring);
    for (int q0 = 1; q0 < sg.pieces; q0 += kGather) {
      const int q1 = min(sg.pieces, q0 + kGather);
      for (int q = q0; q < q1; ++q)  // this thread's words of each piece, all in flight
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           smem_addr(ring4 + (q - q0) * kSlot4 + j * 128 + t)),
                       "l"(slots + q * kSlot4 + j * 128 + t)
                       : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      for (int q = q0; q < q1; ++q) {
        const float4* const got = ring4 + (q - q0) * kSlot4 + t;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          const float4 w = got[j * 128];
          v[4 * j] = __fadd_rn(v[4 * j], w.x);
          v[4 * j + 1] = __fadd_rn(v[4 * j + 1], w.y);
          v[4 * j + 2] = __fadd_rn(v[4 * j + 2], w.z);
          v[4 * j + 3] = __fadd_rn(v[4 * j + 3], w.w);
        }
      }
    }
    for (int q = 1 + t; q < sg.pieces; q += 128) full[q] = 0;  // empty for the next launch
  }
  const int warp = t >> 5, lane = t & 31;
  if (ztma) {
    // two 64-row x 32-column boxes, 128-byte swizzle: 16-byte chunk c of row r
    // at chunk c ^ (r & 7), conflict-free float2 writes
    staging_free(g, t);
    unsigned char* const xbb = reinterpret_cast<unsigned char*>(xb);
#pragma unroll
    for (int i = 0; i < kAcc; i += 2) {
      const int r = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int cc = 8 * (i >> 2) + 2 * (lane & 3);
      const int cb = cc & 31;
      *reinterpret_cast<float2*>(xbb + (cc >> 5) * (kXBytes / 2) + r * 128 +
                                 ((((cb >> 2) ^ r) & 7) << 4) + ((cb & 3) << 2)) =
          make_float2(__fadd_rn(v[i], mloc[cc]), __fadd_rn(v[i + 1], mloc[cc + 1]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + g, 128);
    if (t == 0) {  // rows past n and columns past ncols are not written
      tma_store(tz, sg.col0 - zc0, sg.row0, smem_addr(xbb));
      tma_store(tz, sg.col0 - zc0 + 32, sg.row0, smem_addr(xbb + kXBytes / 2));
      bulk_commit();
    }
    return;
  }
  const int ldz = cend - zc0;
  // accumulator i: row 16 warp + lane / 4 + 8 ((i >> 1) & 1), column
  // 8 (i >> 2) + 2 (lane & 3) + (i & 1)
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int row = sg.row0 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int cc = 8 * (i >> 2) + 2 * (lane & 3);
    const int col = sg.col0 + cc;
    if (row >= n || col >= cend) continue;
    float* dst = z + static_cast<size_t>(row) * ldz + (col - zc0);
    dst[0] = __fadd_rn(v[i], mloc[cc]);
    if (col + 1 < cend) dst[1] = __fadd_rn(v[i + 1], mloc[cc + 1]);
  }
}

// kTma: the stages come by TMA (tu, tc: u's and C's tensor maps); else the
// groups load their steps themselves.  ztma: z is written through tz.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tu,
                      const __grid_constant__ CUtensorMap tc,
                      const __grid_constant__ CUtensorMap tz, const float* __restrict__ u,
                      const float* __restrict__ C, const float* __restrict__ loc,
                      float* __restrict__ z, float* work, int* flags,
                      const int* __restrict__ plan, int n, int d, int zc0, int cend, int ztma) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  unsigned char* const bf = ring + kRingBytes;
  float* const xbuf = reinterpret_cast<float*>(bf + kBf16Bytes);
  float* const mlocs = xbuf + kXBytes / 4;
  const uint32_t bars = smem_addr(mlocs + kLocBytes / 4);  // full[kStages], empty[kStages]

  // the next launch on the stream may start its blocks as SMs free up: it
  // waits (griddepcontrol.wait) for this grid before it reads or writes
  // device memory
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int tid = threadIdx.x;
  const int lo = plan[blockIdx.x];
  const int hi = plan[blockIdx.x + 1];
  const int* const segs = plan + ((gridDim.x + 4) & ~3);
  if (lo >= hi) return;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(bars + 8 * st, 1);                     // the producer's lane
      bar_init(bars + 8 * (kStages + st), 128 / 32);  // one arrival a warp of the group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer (TMA route): every step of the block's range, in order,
    // into the ring, from one lane
    if (!kTma || (tid & 31) != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tu)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tc)) : "memory");
    // u and C may be outputs of the launch before this one (K7b's draws, a
    // kernel that just wrote the factor): no copy before the wait
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    uint32_t unit = 0;
    for (int s = lo; s < hi; ++s) {
      const Segment sg = segment(segs, s);
      for (int step = sg.step0; step < sg.step1; ++step, ++unit) {
        const int st = static_cast<int>(unit % kStages);
        const uint32_t full = bars + 8 * st;
        const uint32_t dst = smem_addr(ring + st * kStageBytes);
        if (unit >= kStages) {
          // the consumers have released the stage's last use; their reads
          // (generic proxy) before the copies' writes
          bar_wait(bars + 8 * (kStages + st), (unit / kStages - 1) & 1);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full),
                     "r"(kStageBytes)
                     : "memory");
        tma_load(dst + 4 * kOpFloats, &tc, step * kStep, sg.col0, full);
        tma_load(dst, &tu, step * kStep, sg.row0, full);
      }
    }
    return;
  }

  // the consumer warpgroups: group g takes the range's steps unit with
  // unit % 2 == g, and the epilogue of every other piece
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // u, C, m, z and the workspace are ready
  const int g = tid >> 7;   // this warpgroup
  const int t = tid & 127;  // this thread in it
  const int lane = t & 31;
  unsigned char* const mine = bf + g * kBufs * 2 * kOpBf16Bytes;
  float* const mloc = mlocs + g * kTile;
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;
  uint32_t unit = 0, own = 0;  // the range's steps so far, and this group's
  for (int s = lo; s < hi; ++s) {
    const Segment sg = segment(segs, s);
    const bool epi = ((s - lo) & 1) == g;  // this group writes the piece
    if (epi && t < kTile) {  // m of the piece's columns, fetched long before its epilogue
      const int col = sg.col0 + t;
      const uint32_t dst = smem_addr(mloc + t);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                   "l"(col < cend ? loc + col : loc), "r"(col < cend ? 4 : 0)
                   : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    bool pending = false;  // this group's product of its previous step is in flight
    for (int step = sg.step0; step < sg.step1; ++step, ++unit) {
      if (static_cast<int>(unit & 1) != g) continue;
      const int st = static_cast<int>(unit % kStages);
      unsigned char* const au = mine + (own % kBufs) * 2 * kOpBf16Bytes;
      unsigned char* const bc = au + kOpBf16Bytes;
      ++own;
      const int k0 = step * kStep;
      const bool diag = k0 + kStep - 1 > sg.col0;  // C's tile crosses its diagonal
      // float4 p of thread t: k0 + 4 (e & 7) .. + 3 of row e >> 3, e = 128 p + t;
      // all loads in flight at once
      float4 a4[kOpFloats / 4 / 128], b4[kOpFloats / 4 / 128];
      if (kTma) {
        bar_wait(bars + 8 * st, (unit / kStages) & 1);
        const float* su = reinterpret_cast<const float*>(ring + st * kStageBytes);
#pragma unroll
        for (int p = 0; p < kOpFloats / 4 / 128; ++p) {
          a4[p] = *reinterpret_cast<const float4*>(su + 4 * (p * 128 + t));
          b4[p] = *reinterpret_cast<const float4*>(su + kOpFloats + 4 * (p * 128 + t));
        }
      } else {  // straight from device memory: rows past n or d, k >= d and k > c as 0
#pragma unroll
        for (int p = 0; p < kOpFloats / 4 / 128; ++p) {
          const int e = p * 128 + t;
          const int row = sg.row0 + (e >> 3), c = sg.col0 + (e >> 3), k = k0 + 4 * (e & 7);
          float x[4], y[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[q] = row < n && k + q < d ? __ldg(u + static_cast<size_t>(row) * d + k + q) : 0.f;
            y[q] = c < d && k + q <= c ? __ldg(C + static_cast<size_t>(c) * d + k + q) : 0.f;
          }
          a4[p] = make_float4(x[0], x[1], x[2], x[3]);
          b4[p] = make_float4(y[0], y[1], y[2], y[3]);
        }
      }
#pragma unroll
      for (int p = 0; p < kOpFloats / 4 / 128; ++p) {
        const int e = p * 128 + t;
        const int r = e >> 3, ch = e & 7;
        const float4 a = a4[p];
        *reinterpret_cast<uint2*>(au + sw64_offset(r, ch)) =
            make_uint2(bf16x2(a.x, a.y), bf16x2(a.z, a.w));
        float4 b = b4[p];
        if (diag) {  // k > c is above the diagonal: 0, whatever the box brought
          const int over = k0 + 4 * ch - (sg.col0 + r);
          if (over > 0) b.x = 0.f;
          if (over > -1) b.y = 0.f;
          if (over > -2) b.z = 0.f;
          if (over > -3) b.w = 0.f;
        }
        *reinterpret_cast<uint2*>(bc + sw64_offset(r, ch)) =
            make_uint2(bf16x2(b.x, b.y), bf16x2(b.z, b.w));
      }
      if (kTma) {
        __syncwarp();
        if (lane == 0) bar_arrive(bars + 8 * (kStages + st));  // the stage is free
      }
      // the bf16 tiles (generic proxy) before wgmma reads them (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + g, 128);
      if (pending) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }
      const uint64_t da = sw64_desc(smem_addr(au));
      const uint64_t db = sw64_desc(smem_addr(bc));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      fence_regs(part);
      wgmma_k16(part, da, db, 0);          // this step's fresh sums
      wgmma_k16(part, da + 2, db + 2, 1);  // k 16..31: 32 bytes on
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      pending = true;
    }
    if (pending) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    // the piece's sums: the other group hands its own over; the piece's
    // group adds them, group 0's first.  The groups swap roles every piece,
    // so a group writes xbuf only after it read (or staged out) the last
    // one; consecutive pieces take two barriers, or a group that arrives for
    // one piece and waits at the next could meet itself there.
    const int handed = kHanded + ((s - lo) & 1);
    if (!epi) {
      staging_free(g, t);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) xbuf[i * 128 + t] = acc[i];
      named_arrive(handed, 256);
    } else {
      named_sync(handed, 256);
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = g == 0 ? __fadd_rn(acc[i], xbuf[i * 128 + t])
                        : __fadd_rn(xbuf[i * 128 + t], acc[i]);
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // the group's m (and xbuf read)
      named_sync(1 + g, 128);
      epilogue(sg, acc, mloc, z, &tz, ztma != 0, reinterpret_cast<float4*>(work), flags, ring,
               xbuf, n, zc0, cend, g, t);
      named_sync(1 + g, 128);  // m read before the group's next piece refills it
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  }
  if (t == 0) bulk_wait_read();  // this group's stores have read shared memory before it ends
}

__device__ __forceinline__ double bf16_wide(double x) {
  return static_cast<double>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(x))));
}

// Float64 parameters: one thread an output of z, summed in double.
__global__ void __launch_bounds__(256)
    bf16_product_f64_kernel(const double* __restrict__ u, const double* __restrict__ C,
                            const double* __restrict__ loc, double* __restrict__ z, int n,
                            int d, int col0, int ncols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (j >= ncols) return;
  const int c = col0 + j;
  const double* ur = u + static_cast<size_t>(row) * d;
  const double* cr = C + static_cast<size_t>(c) * d;
  double s = 0.0;
  for (int k = 0; k <= c; ++k) s = __fma_rn(bf16_wide(ur[k]), bf16_wide(cr[k]), s);
  z[static_cast<size_t>(row) * ncols + j] = s + loc[c];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime (so
// the library links nothing beyond it).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) float32 row-major matrix as boxes of box_cols x box_rows,
// zeros read out of bounds (and nothing written there), with `swizzle`.
bool tensor_map(CUtensorMap* map, const float* base, int rows, int cols, int box_cols,
                int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// u: (n, d) float32 row-major; C: (d, d) row-major, only its lower triangle
// read; loc: (d,); z: (n, ncols), columns col0 .. col0 + ncols - 1 of the
// product.  plan: a fullrank_plan table (tile_cost BF16_TILE_COST) of that
// range for `blocks` blocks (the block offsets, padded to four words, then
// eight words a segment), on the card; work: its slots x 64 x 64 floats,
// 16-byte aligned; flags: its slots ints, zero (and left so).  tma: the TMA
// route (d % 4 == 0, u and C 16-byte aligned), else the loads.  z is written
// by TMA where ncols % 4 == 0 and z is 16-byte aligned.  Returns the first
// CUDA error (0 on success).
extern "C" int fullrank_bf16(const float* u, const float* C, const float* loc, float* z,
                             float* work, int* flags, const int* plan, int blocks, int n, int d,
                             int col0, int ncols, int tma, cudaStream_t stream) {
  if (n <= 0 || ncols <= 0) return static_cast<int>(cudaSuccess);
  CUtensorMap tu = {}, tc = {}, tz = {};
  if (tma) {
    if ((d & 3) != 0 || (reinterpret_cast<uintptr_t>(u) & 15) != 0 ||
        (reinterpret_cast<uintptr_t>(C) & 15) != 0 ||
        !tensor_map(&tu, u, n, d, kStep, kTile, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !tensor_map(&tc, C, d, d, kStep, kTile, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ztma = (ncols & 3) == 0 && (reinterpret_cast<uintptr_t>(z) & 15) == 0;
  if (ztma && !tensor_map(&tz, z, n, ncols, 32, kTile, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tma ? bf16_wgmma_kernel<true> : bf16_wgmma_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Programmatic Dependent Launch: the blocks may start while the launch
  // before them ends (its draws, or this product's last launch)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tu, tc, tz, u, C, loc, z, work, flags, plan, n, d, col0,
                           col0 + ncols, ztma ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The same function on float64 tensors (n rows of the grid's y: n <= 65,535).
extern "C" int fullrank_bf16_f64(const double* u, const double* C, const double* loc, double* z,
                                 int n, int d, int col0, int ncols, cudaStream_t stream) {
  if (n <= 0 || ncols <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((ncols + 255) / 256, n);
  bf16_product_f64_kernel<<<grid, 256, 0, stream>>>(u, C, loc, z, n, d, col0, ncols);
  return static_cast<int>(cudaGetLastError());
}
