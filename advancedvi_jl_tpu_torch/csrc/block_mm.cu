// The block product of csrc/block_mm.cuh alone, for its card tests: it has
// no TPU kernel of its own (it runs inside the fused kernels, in K1+K2's
// and K4's minibatch logreg bodies, fused_common.cuh, and in K5's
// generated body), so this file only launches it.  One block of 512
// threads copies A (M, lda) and B into
// shared memory and writes C = A B (M, N), row-major, to device memory.
// B is (K, N) row-major with row stride ldb, or, with trans_b, B^T (N, K)
// with row stride ldb.  `config` picks block_mm's tile as its callers emit
// it (ops/cuda/block_mm_kernels.py CONFIGS): 0 and 1 the hand logits' and
// gradient's (10 rows x 1 column a thread, k over 2 and 8 lanes, A read as
// float4s), 2 and 3 the same tiles on the plain layout (scalar loads), 4
// and 5 K5's flagship logits' and gradient's (5 x 2 and 2 x 2, k in order,
// A as float4s), 6 and 7 the minibatch body's logits and gradient (10 x 4
// over 4 lanes and 10 x 2 over 16, A as float4s).  Bound on an H100:
// shared-memory loads (see block_mm.cuh); the copies in and out are a few
// KB.  block_mm_mvnormal runs the dense-Gaussian body's product
// (csrc/mvnormal_product.cuh, fused_common.cuh mvnormal_stream_body) on the
// layout the mean-field kernel's kMvn instance takes at n = M rows and 8
// state rows (fused_meanfield_body.cuh mvn_layout): A in shared memory
// below tier 3 (where the body keeps z), else read in device memory; P
// staged at tier 0, else streamed through the TMA ring; the same plan, so
// its time is the body's product's.  Bound on an H100: one SM's
// multiply-adds, and from tier 1 P's bytes from L2 (mvnormal_product.cuh).
#include <cuda_runtime.h>

#include "block_mm.cuh"
#include "fused_meanfield_body.cuh"

namespace {

constexpr int kThreads = 512;
constexpr size_t kSmemLimit = 232448;

template <int TM, int TN, int KS, bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads)
    block_mm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ C, int M, int N, int K, int lda, int ldb, int trans_b,
                    int b_in_place) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + avi::round4(M * lda);
  const int b_floats = trans_b ? N * ldb : K * ldb;
  const int tid = threadIdx.x;
  for (int i = tid; i < M * lda; i += kThreads) As[i] = A[i];
  if (!b_in_place)
    for (int i = tid; i < b_floats; i += kThreads) Bs[i] = B[i];
  __syncthreads();
  avi::block_mm<kThreads, TM, TN, KS, kVecA, kVecB>(
      M, N, K, As, lda, 1, b_in_place ? B : Bs, trans_b ? 1 : ldb, trans_b ? ldb : 1, tid,
      [=](int i, int j, float v) { C[i * N + j] = v; });
}

// One block: C (M, d) = A (M, d) P (d, ld) by the kMvn body's product.
__global__ void __launch_bounds__(kThreads, 1)
    block_mm_mvnormal_kernel(const float* __restrict__ A, const float* __restrict__ P,
                             float* __restrict__ C, int M, int d) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const avi::mf::MvnLayout V = avi::mf::mvn_layout(M, d, 8);
  const int tid = threadIdx.x;
  float* As = smem + V.W.L.z;
  if (V.W.tier < 3)
    for (int i = tid; i < M * d; i += kThreads) As[i] = A[i];
  uint32_t fill = 0;
  // the ring reads this product's blocks alone: nothing is left in flight
  avi::mvn::stage_or_start<kThreads>(V.S, smem, P, d, tid, avi::mvn::product_blocks(V.S, M, d));
  __syncthreads();
  avi::mvn::product<kThreads>(
      V.S, smem, V.W.tier < 3 ? As : A, M, d, P, fill, tid,
      [=](int i, int j, float v) { C[i * d + j] = v; }, false);
}

template <int TM, int TN, int KS, bool kVecA, bool kVecB>
cudaError_t launch(const float* A, const float* B, float* C, int M, int N, int K, int lda,
                   int ldb, int trans_b, size_t smem, int b_in_place, cudaStream_t stream) {
  const auto kernel = block_mm_kernel<TM, TN, KS, kVecA, kVecB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, stream>>>(A, B, C, M, N, K, lda, ldb, trans_b, b_in_place);
  return cudaGetLastError();
}

}  // namespace

// C (M, N) = A (M, K; row stride lda) B (see above).  Configs 0, 1, 4, 5,
// 6 and 7 need lda % 4 == 0.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a call the kernel does not take.
extern "C" int block_mm_run(const float* A, const float* B, float* C, int M, int N, int K,
                            int lda, int ldb, int trans_b, int config, cudaStream_t stream) {
  const bool vec_a = config != 2 && config != 3;
  if (M < 1 || N < 1 || K < 1 || lda < K || ldb < (trans_b ? K : N) || config < 0 ||
      config > 7 || (vec_a && lda % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(avi::round4(M * lda)) + (trans_b ? N : K) * ldb);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto kernel_launch) {
    return kernel_launch(A, B, C, M, N, K, lda, ldb, trans_b, smem, 0, stream);
  };
  switch (config) {
    case 0: return static_cast<int>(args(launch<10, 1, 2, true, false>));
    case 1: return static_cast<int>(args(launch<10, 1, 8, true, false>));
    case 2: return static_cast<int>(args(launch<10, 1, 2, false, false>));
    case 3: return static_cast<int>(args(launch<10, 1, 8, false, false>));
    case 4: return static_cast<int>(args(launch<5, 2, 1, true, false>));
    case 5: return static_cast<int>(args(launch<2, 2, 1, true, false>));
    case 6: return static_cast<int>(args(launch<10, 4, 4, true, false>));
    default: return static_cast<int>(args(launch<10, 2, 16, true, false>));
  }
}

// C (M, d) = A (M, d) P, as mvnormal_stream_body forms -grad: A row-major,
// P (d, d) with rows of round4(d) floats, 16-byte aligned, on the kMvn
// layout at n = M (block_mm_mvnormal_layout).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a call the kernel does not
// take.
extern "C" int block_mm_mvnormal(const float* A, const float* P, float* C, int M, int d,
                                 cudaStream_t stream) {
  if (M < 1 || d < 1 || d > 4 * kThreads || reinterpret_cast<uintptr_t>(P) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(avi::mf::mvn_layout(M, d, 8).S.end);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(block_mm_mvnormal_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  block_mm_mvnormal_kernel<<<1, kThreads, smem, stream>>>(A, P, C, M, d);
  return static_cast<int>(cudaGetLastError());
}

// The plan block_mm_mvnormal runs at (M, d), the kMvn body's at n = M:
// out = {tier, rows a thread, rows a pass, P's rows a ring stage (0: staged),
// shared bytes}.
extern "C" void block_mm_mvnormal_layout(int M, int d, long long* out) {
  const avi::mf::MvnLayout V = avi::mf::mvn_layout(M, d, 8);
  out[0] = V.W.tier;
  out[1] = V.S.tm;
  out[2] = V.S.pm;
  out[3] = V.S.rows;
  out[4] = static_cast<long long>(sizeof(float)) * V.S.end;
}
