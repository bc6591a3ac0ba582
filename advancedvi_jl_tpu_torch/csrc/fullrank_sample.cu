// K7b: the full-rank reparameterised sampler, z = u tril(C)^T + m.
//
// Replaces ops/pallas/location_scale_kernels.py::_fullrank_sample_raw (the
// pallas_call over _fullrank_kernel).  The plain PyTorch version is
// fullrank_sample_reference in ops/cuda/location_scale_kernels.py.
//
// What bounds it on an H100: at the main path's shape (n = 256 samples,
// d = 1024) the float32 product of 256 x 1024 by the lower triangle of a
// 1024 x 1024 factor, 134.5M multiply-adds, and the 262,144 normals (388
// instructions a lane group of four): 4.8 us at the card's issue rate.  The
// bytes (C's triangle, 2 MB, read; z and u, 2 MB, written) take a quarter of
// that at 3.35 TB/s.
//
// Design: two launches on one stream.
//
// 1. fullrank_draw_kernel draws u, each normal once, with the counter
//    (iteration, row, lane group, stream) of csrc/philox.cuh and K7a's
//    geometry (32 lane groups x 8 rows a block), so u equals K7a's u bit for
//    bit.  It also zeroes the product's tile counters.  Sample row i of a
//    launch draws from counter row first_row + i, so a launch at
//    (first_row, n) draws rows [first_row, first_row + n) of any larger draw
//    bit for bit; first_row enters only the counter, never the product's
//    tile walk.
//
// 2. fullrank_product_kernel computes z from u (1 MB, still in L2) and C.
//    Output tiles are 64 rows x 64 columns; tile (i, j) sums over k below the
//    end of its column tile only (C's row c has k <= c), in steps of 32, so
//    column tile j takes 2 (j + 1) steps: the triangle is unbalanced by
//    nature.  The host cuts the whole list of (tile, step) into one equal
//    range a block (stream-K: at most one step apart), one block an SM
//    (fullrank_plan in ops/cuda/location_scale_kernels.py, uploaded once a
//    shape).  A range may start or end inside a tile: each piece of such a
//    tile writes its partial sum to a workspace slot, and the piece that
//    arrives last (an integer counter a tile) stages the pieces in shared
//    memory (cp.async, one trip to L2 for up to six), adds them in piece
//    order and writes z, so the bits never depend on which block finishes
//    first.  No float atomics.
//
//    A block is 256 threads in four k-groups of 64; in each step of 32, group
//    g sums k = 8 g .. 8 g + 7 into 8 x 8 outputs a thread in registers
//    (float4 shared loads, 16 a thread for 256 FMAs), and at the end of a
//    piece the four groups' sums meet in shared memory in group order.  u's
//    and C's tiles are staged by cp.async in four buffers, so three steps'
//    loads fly during this step's FMAs, with one barrier a step; C's entries
//    above the diagonal are never read (cp.async's source size zero-fills
//    them).  The product waits for the draws by Programmatic Dependent
//    Launch: its blocks start while the draws run and fetch their first C
//    tile before the wait.
//
// A column range [col0, col0 + ncols) (one rank's share under the family's
// tp_axis) draws the whole u (column c of z needs u's columns 0 .. c) and
// walks only the range's column tiles (C's rows col0 ..), storing the
// columns below col0 + ncols into an (n, ncols) z.  The whole product is
// the range [0, d).  The lower rows of C are longer, so an even cut of
// the columns is uneven work; nothing rebalances it.  With product = 0 the
// entry draws u alone, for the bfloat16 product of csrc/fullrank_bf16.cu.
//
// Full float32 FMAs throughout (TF32 would miss the 1e-6 contract).
#include "philox.cuh"

namespace {

constexpr int kDrawGroups = 32;  // threadIdx.x: lane groups of four (K7a's block)
constexpr int kDrawRows = 8;     // threadIdx.y: sample rows
constexpr int kMaxGridRows = 65535;

constexpr int kTile = 64;                 // output tile: rows and columns of z
constexpr int kStep = 32;                 // depth of one staged step
constexpr int kGroups = 4;                // k-groups a block
constexpr int kGroupK = kStep / kGroups;  // 8: k of a step a group sums
constexpr int kThreads = 256;             // 4 groups x 8 x 8 threads
constexpr int kPad = kStep + 4;           // staged row stride: 144 bytes, conflict-free
constexpr int kRed = kTile + 8;           // k-group sums' row stride: conflict-free
constexpr int kStage = kTile * kPad;      // floats of one staged operand
constexpr int kStages = 4;                // steps staged at once
constexpr int kFixSlots = 6;              // partial sums a last piece stages at once
// after the staged steps: the k-groups' sums, or the staged partials
constexpr int kTail = kGroups * kTile * kRed > kFixSlots * kTile * kTile
                          ? kGroups * kTile * kRed
                          : kFixSlots * kTile * kTile;
constexpr int kSmemBytes =
    static_cast<int>(sizeof(float)) * (2 * kStages * kStage + kTail);  // 172,032
constexpr int kSegWords = 8;  // row0, col0, step0, step1, tile, piece, pieces, slot

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// the oldest of the kStages - 1 steps in flight has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kDrawGroups * kDrawRows)
    fullrank_draw_kernel(float* __restrict__ u, int* __restrict__ counters, int tiles, int n,
                         int d, uint32_t k0, uint32_t k1, uint32_t it,
                         uint32_t first_row) {
  // the product may launch now: it waits (griddepcontrol.wait) for this grid
  // to finish before it reads u or the counters
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int t = threadIdx.y * kDrawGroups + threadIdx.x; t < tiles; t += kDrawGroups * kDrawRows)
      counters[t] = 0;
  const int group = blockIdx.x * kDrawGroups + threadIdx.x;
  const int j0 = 4 * group;
  if (j0 >= d) return;
  for (int row = blockIdx.y * kDrawRows + threadIdx.y; row < n; row += gridDim.y * kDrawRows) {
    float w[4];
    avi::normals4(k0, k1, it, first_row + static_cast<uint32_t>(row),
                  static_cast<uint32_t>(group), w);
    float* dst = u + static_cast<size_t>(row) * d + j0;
    if ((d & 3) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (j0 + p < d) dst[p] = w[p];
    }
  }
}

// Stage step `step` of the tile at (row0, col0): u's rows row0.. and C's rows
// col0.., k = 32 step .. + 31.  Out-of-range rows, k >= d and (for C) k > c
// come in as zeros without being read.  kVec: 16-byte copies (d % 4 == 0 and
// aligned rows), else 4-byte ones.
template <bool kVec, bool kIsC>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows, int d, int r0,
                                      int step, int tid) {
  const int k0 = step * kStep;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kTile * kStep / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e >> 3;
      const int kc = (e & 7) * 4;
      const int r = r0 + row;
      const int lim = kIsC ? min(r + 1, d) : d;
      const int bytes = r < rows ? 4 * max(0, min(4, lim - (k0 + kc))) : 0;
      cp_async16(dst + row * kPad + kc, bytes ? src + static_cast<size_t>(r) * d + k0 + kc : src,
                 bytes);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kTile * kStep / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e >> 5;
      const int kc = e & 31;
      const int r = r0 + row;
      const int lim = kIsC ? min(r + 1, d) : d;
      const int bytes = (r < rows && k0 + kc < lim) ? 4 : 0;
      cp_async4(dst + row * kPad + kc, bytes ? src + static_cast<size_t>(r) * d + k0 + kc : src,
                bytes);
    }
  }
}

struct Segment {
  int row0, col0, step0, step1, tile, piece, pieces, slot;
};

__device__ __forceinline__ Segment segment(const int* __restrict__ segs, int s) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(segs + s * kSegWords));
  const int4 b = __ldg(reinterpret_cast<const int4*>(segs + s * kSegWords + 4));
  return Segment{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// The product over the plan's tiles, output columns [zc0, cend) (C's rows
// zc0 ..) into an (n, cend - zc0) z (the whole product: zc0 = 0, cend = d).
// C's tiles are staged up to row d as for the whole product, so the tile
// walk is the same code either way: a range's last tile may compute
// columns past cend, which are not stored.  kVec also needs zc0 and cend -
// zc0 multiples of 4 (float4 stores of z).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    fullrank_product_kernel(const float* __restrict__ loc, const float* __restrict__ C,
                            const float* u, float* __restrict__ z, float* partial,
                            int* counters, const int* __restrict__ plan, int n, int d,
                            int cend, int zc0) {
  const int ldz = cend - zc0;
  extern __shared__ float4 smem4[];
  // [kStages][u's rows, C's rows][64][kPad], then the k-groups' sums [4][64][kRed]
  float* const ops = reinterpret_cast<float*>(smem4);
  float* const red = ops + 2 * kStages * kStage;
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int g = tid >> 6;         // k-group
  const int ty = (tid >> 3) & 7;  // rows ty + 8 i
  const int tx = tid & 7;         // columns tx + 8 j
  const int lo = plan[blockIdx.x];
  const int hi = plan[blockIdx.x + 1];
  const int* const segs = plan + ((gridDim.x + 4) & ~3);
  if (lo >= hi) return;

  // the step being computed (segment cur) and the step being staged (pre)
  int cur = lo;
  Segment sc = segment(segs, cur);
  int step = sc.step0;
  int pre = lo, pstep = sc.step0;
  Segment sp = sc;
  auto advance = [&]() {
    if (++pstep == sp.step1 && ++pre < hi) {
      sp = segment(segs, pre);
      pstep = sp.step0;
    }
  };

  // the first step's C does not depend on the draws: stage it before
  // waiting for them; then the rest of the first kStages - 1 steps
  stage<kVec, true>(ops + kStage, C, d, d, sp.col0, pstep, tid);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  stage<kVec, false>(ops, u, n, d, sp.row0, pstep, tid);
  cp_async_commit();
  advance();
  for (int b = 1; b < kStages - 1; ++b) {
    if (pre < hi) {
      stage<kVec, false>(ops + 2 * b * kStage, u, n, d, sp.row0, pstep, tid);
      stage<kVec, true>(ops + (2 * b + 1) * kStage, C, d, d, sp.col0, pstep, tid);
      advance();
    }
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int buf = 0;  // the step being computed; the next staged step goes to buf - 1
  while (true) {
    cp_async_wait_oldest();
    __syncthreads();  // this step has landed for everyone, and buf - 1 is free
    if (pre < hi) {
      const int fill = (buf + kStages - 1) % kStages;
      stage<kVec, false>(ops + 2 * fill * kStage, u, n, d, sp.row0, pstep, tid);
      stage<kVec, true>(ops + (2 * fill + 1) * kStage, C, d, d, sp.col0, pstep, tid);
      advance();
    }
    cp_async_commit();
    const float* A = ops + 2 * buf * kStage + ty * kPad + g * kGroupK;
    const float* B = ops + (2 * buf + 1) * kStage + tx * kPad + g * kGroupK;
#pragma unroll
    for (int h = 0; h < kGroupK; h += 4) {
      float4 av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(A + 8 * i * kPad + h);
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float4*>(B + 8 * j * kPad + h);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
    buf = (buf + 1) % kStages;
    if (++step < sc.step1) continue;

    // the end of a piece: the four k-groups' sums, in group order
    float* rg = red + g * kTile * kRed;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rg[(ty + 8 * i) * kRed + tx + 8 * j] = acc[i][j];
        acc[i][j] = 0.0f;
      }
    __syncthreads();
    float4 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = tid + r * kThreads;
      const int off = (p >> 4) * kRed + (p & 15) * 4;
      float4 s = *reinterpret_cast<const float4*>(red + off);
#pragma unroll
      for (int q = 1; q < kGroups; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(red + q * kTile * kRed + off);
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      v[r] = s;
    }
    bool write = true;
    if (sc.pieces > 1) {
      // a piece of a split tile: publish the partial sum; the last piece to
      // arrive adds all of them in piece order
      float4* mine = reinterpret_cast<float4*>(partial) +
                     static_cast<size_t>(sc.slot + sc.piece) * (kTile * kTile / 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) __stcg(mine + tid + r * kThreads, v[r]);
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(counters + sc.tile, 1) == sc.pieces - 1;
      __syncthreads();
      write = s_last;
      if (write) {
        // stage the pieces' partial sums in shared memory, kFixSlots at a
        // time (one round trip to L2 a round), and add them in piece order;
        // each thread reads back only what it staged
        __threadfence();
        const float4* slots = reinterpret_cast<const float4*>(partial) +
                              static_cast<size_t>(sc.slot) * (kTile * kTile / 4);
        float4* fix = reinterpret_cast<float4*>(red);
        float4 s[4];
        for (int q0 = 0; q0 < sc.pieces; q0 += kFixSlots) {
          const int q1 = min(sc.pieces, q0 + kFixSlots);
          for (int q = q0; q < q1; ++q)
            if (q != sc.piece)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int p = tid + r * kThreads;
                cp_async16(reinterpret_cast<float*>(fix + (q - q0) * (kTile * kTile / 4) + p),
                           reinterpret_cast<const float*>(slots + q * (kTile * kTile / 4) + p),
                           16);
              }
          cp_async_commit();
          cp_async_wait_all();
          for (int q = q0; q < q1; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float4 t =
                  q == sc.piece ? v[r] : fix[(q - q0) * (kTile * kTile / 4) + tid + r * kThreads];
              if (q == 0) {
                s[r] = t;
              } else {
                s[r].x += t.x;
                s[r].y += t.y;
                s[r].z += t.z;
                s[r].w += t.w;
              }
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = s[r];
      }
    }
    if (write) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = tid + r * kThreads;
        const int row = sc.row0 + (p >> 4);
        const int col = sc.col0 + (p & 15) * 4;
        if (row >= n || col >= cend) continue;
        const size_t at = static_cast<size_t>(row) * ldz + (col - zc0);
        if (kVec) {
          const float4 m = *reinterpret_cast<const float4*>(loc + col);
          // indexed in float4s: the compiler keeps the one 16-byte store
          reinterpret_cast<float4*>(z)[at >> 2] =
              make_float4(v[r].x + m.x, v[r].y + m.y, v[r].z + m.z, v[r].w + m.w);
        } else {
          float* dst = z + at;
          const float w[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col + q < cend) dst[q] = w[q] + loc[col + q];
        }
      }
    }
    if (++cur == hi) break;
    sc = segment(segs, cur);
    step = sc.step0;
  }
}

}  // namespace

// z: (n, ncols) and u: (n, d) float32, row-major, 16-byte aligned; loc: (d,);
// C: (d, d) row-major, only its lower triangle is read.  z's columns are the
// product's columns col0 .. col0 + ncols - 1 (rows col0.. of C; the whole
// product: col0 = 0, ncols = d).  plan: fullrank_plan's table of that range
// for `blocks` blocks (the block offsets, padded to four words, then eight
// words a segment), on the card; partial: its slots x 64 x 64 floats;
// counters: its `tiles` ints.  Row i of u takes counter row first_row + i.
// With product = 0 it draws u alone (the bfloat16 product follows,
// csrc/fullrank_bf16.cu) and reads neither the plan nor C.  Returns the
// first CUDA error (0 on success): a card without kSmemBytes of shared
// memory a block refuses the launch.
extern "C" int fullrank_sample(const float* loc, const float* C, float* z, float* u,
                               float* partial, int* counters, const int* plan, int blocks,
                               int tiles, int n, int d, uint32_t seed0, uint32_t seed1,
                               uint32_t it, uint32_t first_row, int col0, int ncols,
                               int product, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int groups = (d + 3) / 4;
  const dim3 draw_grid((groups + kDrawGroups - 1) / kDrawGroups,
                       min((n + kDrawRows - 1) / kDrawRows, kMaxGridRows));
  fullrank_draw_kernel<<<draw_grid, dim3(kDrawGroups, kDrawRows), 0, stream>>>(
      u, counters, product ? tiles : 0, n, d, seed0, seed1, it, first_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !product || ncols <= 0) return static_cast<int>(err);

  const bool vec = (d & 3) == 0 && (col0 & 3) == 0 && (ncols & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(loc) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(C) & 15) == 0;
  auto kernel = vec ? fullrank_product_kernel<true> : fullrank_product_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  err = cudaLaunchKernelEx(&cfg, kernel, loc, C, static_cast<const float*>(u), z, partial,
                           counters, plan, n, d, col0 + ncols, col0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
