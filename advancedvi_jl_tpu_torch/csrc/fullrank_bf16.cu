// The full-rank family's bfloat16 sampling product (compute_dtype="bfloat16"):
// z[:, c] = bf16(u) bf16(tril C)[c, :]^T + m[c] for the output columns
// c in [col0, col0 + ncols), the operands rounded to bfloat16 (round to
// nearest even, torch's and XLA's rounding), the sums kept in the parameter
// dtype.
//
// Replaces no Pallas kernel: the JAX package forms this product with XLA
// (families/location_scale.py:255-268, jnp.matmul of bf16 operands with
// preferred_element_type = the parameter dtype), on the path that K7b's
// (ops/pallas/location_scale_kernels.py::_fullrank_sample_raw) f32 product
// takes otherwise.  It runs after K7b's draw launch (csrc/fullrank_sample.cu,
// draws only) or on injected draws (from_base: Student-t, Laplace, noise).
// The plain PyTorch version is fullrank_bf16_reference in
// ops/cuda/location_scale_kernels.py.
//
// What bounds it on an H100: at the main path's shape (n = 256, d = 1024)
// 134.5M multiply-adds of the lower triangle, 0.27 us at 989 TFLOP/s dense
// bf16; the bytes (u and C's triangle read as float32, 3 MB, z written,
// 1 MB) take 1.2 us at 3.35 TB/s.  So it is bound by bytes.
//
// Design (float32 parameters): a block computes 32 rows x 64 columns of z
// with four warps, warp w columns 16 w .. 16 w + 15, each as 2 x 2 tiles of
// mma.sync.aligned.m16n8k16 (bf16 operands, f32 accumulators).  A step is
// 32 of k: u's and C's float32 tiles are staged by cp.async in three
// buffers (two steps' loads fly while one step multiplies, one barrier a
// step; 160-byte rows, so the fragments' float2 loads hit distinct banks),
// and converted to bf16 as the fragments are built.  Column tile j sums
// k < min(c_end, its last column + 1) only (C's row c stops at k = c);
// entries above the diagonal are never read (cp.async's source size
// zero-fills them), so NaN there stays out of z.  The tensor cores may
// truncate their adds, so each step's two products go into fresh
// accumulators that are added to the running sums with round-to-nearest
// float adds: the error stays that of an f32 sum.  No wgmma, no TMA.
//
// Float64 parameters (JAX accumulates in f64 there): one thread an output on
// the CUDA cores, the bf16-rounded operands widened to double and summed in
// double.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 32;        // rows of z a block
constexpr int kBN = 64;        // columns of z a block (rows of C)
constexpr int kBK = 32;        // depth of one staged step: two k16 products
constexpr int kThreads = 128;  // four warps
constexpr int kLd = kBK + 8;   // staged row stride in floats: 160 bytes, conflict-free float2s
constexpr int kStages = 3;     // steps in flight: two load while one multiplies
constexpr int kStageFloats = (kBM + kBN) * kLd;  // u's then C's tile of one step

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

// Stage `rows` x 32 of k from k0 of the matrix's rows r0.. (u, or C's rows
// with kIsC): rows past `rend`, k >= d and, for C, k > c (above the
// diagonal, never read) land as zeros.  kVec: 16-byte copies (d % 4 == 0
// and 16-byte aligned rows), else 4-byte ones.
template <bool kVec, bool kIsC, int kRows>
__device__ __forceinline__ void stage(float* dst, const float* src, int rend, int d, int r0,
                                      int k0, int tid) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kRows * kBK / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e >> 3, kc = (e & 7) * 4;
      const int r = r0 + row;
      const int lim = kIsC ? min(r + 1, d) : d;
      const int bytes = r < rend ? 4 * max(0, min(4, lim - (k0 + kc))) : 0;
      cp_async16(dst + row * kLd + kc, bytes ? src + static_cast<size_t>(r) * d + k0 + kc : src,
                 bytes);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kRows * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e >> 5, kc = e & 31;
      const int r = r0 + row;
      const int lim = kIsC ? min(r + 1, d) : d;
      const int bytes = (r < rend && k0 + kc < lim) ? 4 : 0;
      cp_async4(dst + row * kLd + kc, bytes ? src + static_cast<size_t>(r) * d + k0 + kc : src,
                bytes);
    }
  }
}

// Two consecutive float32 values of a staged row as a bf16 pair (the lower
// k in the low half, as the mma fragments hold them).
__device__ __forceinline__ uint32_t pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    bf16_product_kernel(const float* __restrict__ u, const float* __restrict__ C,
                        const float* __restrict__ loc, float* __restrict__ z, int n, int d,
                        int col0, int ncols) {
  __shared__ __align__(16) float smem[kStages * kStageFloats];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row group and pair
  const int r0 = blockIdx.y * kBM;
  const int c0 = col0 + blockIdx.x * kBN;
  const int cend = col0 + ncols;
  const int kend = min(cend, c0 + kBN);  // C's rows c0 .. c0 + 63 stop at k = c
  const int steps = (kend + kBK - 1) / kBK;

  auto fill = [&](int step) {
    float* buf = smem + (step % kStages) * kStageFloats;
    stage<kVec, false, kBM>(buf, u, n, d, r0, step * kBK, tid);
    stage<kVec, true, kBN>(buf + kBM * kLd, C, cend, d, c0, step * kBK, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) fill(s);
    cp_async_commit();
  }

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait_oldest();
    __syncthreads();  // this step has landed for everyone; the oldest buffer is free
    if (step + kStages - 1 < steps) fill(step + kStages - 1);
    cp_async_commit();
    const float* As = smem + (step % kStages) * kStageFloats;
    const float* Bs = As + kBM * kLd;
    float part[2][2][4];  // this step's sums: the tensor cores' adds stay inside one step
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = As + (16 * i + g) * kLd + ks + 2 * t;
        a[i][0] = pair(p);
        a[i][1] = pair(p + 8 * kLd);
        a[i][2] = pair(p + 8);
        a[i][3] = pair(p + 8 * kLd + 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* p = Bs + (16 * warp + 8 * j + g) * kLd + ks + 2 * t;
        b[j][0] = pair(p);
        b[j][1] = pair(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(part[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = __fadd_rn(acc[i][j][v], part[i][j][v]);
  }

  // fragment element v: row g (+8 for v >= 2), column 2 t + (v & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int row = r0 + 16 * i + g + (v >= 2 ? 8 : 0);
        const int col = c0 + 16 * warp + 8 * j + 2 * t + (v & 1);
        if (row < n && col < cend)
          z[static_cast<size_t>(row) * ncols + (col - col0)] =
              __fadd_rn(acc[i][j][v], loc[col]);
      }
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

}  // namespace

// u: (n, d) float32 row-major; C: (d, d) row-major, only its lower triangle
// read; loc: (d,); z: (n, ncols), columns col0 .. col0 + ncols - 1 of the
// product.  Returns the first CUDA error (0 on success).
extern "C" int fullrank_bf16(const float* u, const float* C, const float* loc, float* z, int n,
                             int d, int col0, int ncols, cudaStream_t stream) {
  if (n <= 0 || ncols <= 0) return static_cast<int>(cudaSuccess);
  const bool vec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(C) & 15) == 0;
  const dim3 grid((ncols + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  if (vec)
    bf16_product_kernel<true><<<grid, kThreads, 0, stream>>>(u, C, loc, z, n, d, col0, ncols);
  else
    bf16_product_kernel<false><<<grid, kThreads, 0, stream>>>(u, C, loc, z, n, d, col0, ncols);
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
