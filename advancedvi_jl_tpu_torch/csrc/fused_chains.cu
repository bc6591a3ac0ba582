// K6: C independent mean-field chains, each the whole optimisation loop of
// csrc/fused_advi_meanfield.cu, in one launch.
//
// Replaces ops/pallas/fused_chains.py::_run_chains_chunk (both pallas_calls,
// plain :525 and traced grid :561) with its body _chains_kernel (:109-464):
// per chain, the draw, the model's log density and gradient (logreg, the
// diagonal Gaussian, the three minibatch transports), the STL / zero-gradient
// entropies or VarGrad, Adam / descent / DoWG / DoG / COCOB, ClipScale / prox
// / none, polynomial averaging and the per-chain ELBO and trace, with a
// per-chain learning rate (lr sweeps) and a per-chain rule code (mixed
// sweeps, RULE_CODES).  The plain PyTorch version is
// fused_chains_run_chunk_reference in ops/cuda/fused_chains.py.
//
// What bounds it on an H100: latency, as the single-chain kernel.  One
// chain's step at the flagship width is about 254k multiply-adds from shared
// memory with five block-wide barriers between its phases, a few
// microseconds of one SM; chains share nothing but the model's data, so C
// chains are C times that work with no communication.
//
// Design: one thread block per chain, grid = C; the TPU kernel's (R, D_PAD)
// row blocks (row r of chain r % C_PAD) and its chain_sum / rows broadcasts
// exist to fill the TPU's vector unit and are gone.  Each block runs the
// single-chain body (csrc/fused_meanfield_body.cuh, the very code of
// fused_advi_meanfield.cu) on its chain's state, keyed by its chain's seed
// words (chain_seed_words, computed on the host), with its chain's lr and,
// in a mixed sweep, its chain's rule: a mixed sweep SELECTS each chain's rule
// where the TPU kernel blends every rule's candidate with 0/1 weights (the
// two agree wherever every candidate is finite; a foreign candidate that is
// inf or NaN makes the blend NaN and leaves the selection alone).  Blocks
// keep the model's data, the draws and the state in their own shared memory
// (about 70 KB at the flagship width); the shared body takes 128 registers a
// thread, so a 512-thread block fills an SM's register file and one chain
// runs on an SM at a time (C <= 132 is one wave).
// Sharing one design read among several chains of a block, and tensor cores
// on the (C n, db) x (db, n_data) product, are later work.
//
// Layouts: state (C, n_rows, d), chain c's rows as the single-chain kernel's;
// elbo (C,); trace (C, steps / log_every), chain-major, so each block writes
// its own row (the wrapper hands out the (steps / log_every, C) view); noise
// (C, steps, n, d); seeds (C, 2); lrs (C,) or null; rules (C,) or null.
#include "fused_meanfield_body.cuh"

namespace {

using avi::mf::kSmemLimit;
using avi::mf::kThreads;
using avi::mf::make_layout;

// One block an SM (minimum 1): left to aim at two, ptxas capped the
// flagship-branch instances at 64 registers and spilled.
template <bool kGeneral, int kGroup>
__global__ void __launch_bounds__(kThreads, 1) fused_chains_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* __restrict__ seeds, unsigned long long it0, const float* __restrict__ lrs,
    const int* __restrict__ rules, avi::Hyper h, avi::Branch br) {
  const int c = blockIdx.x;
  const size_t rows = static_cast<size_t>(n_rows) * d;
  if (lrs != nullptr) h.lr = lrs[c];
  if (rules != nullptr) br.algo = rules[c];
  float* tr = nullptr;
  if (trace != nullptr) tr = trace + static_cast<size_t>(c) * (steps / log_every);
  const float* nz = nullptr;
  if (noise != nullptr) nz = noise + static_cast<size_t>(c) * steps * n * d;
  avi::mf::run_chunk<kGeneral, kGroup>(model, c0, c1, n_data, db, batch, s0, s1,
                                       state_in + c * rows, state_out + c * rows, elbo_out + c,
                                       tr, nz, n, d, n_rows, steps, log_every, seeds[2 * c],
                                       seeds[2 * c + 1], it0, h, br);
}

// The instance of a launch: the flagship branch's (switches constant) or
// the general one, of model group kGroup.
template <int kGroup>
auto kernel_for(bool flagship_branch) {
  return flagship_branch ? fused_chains_kernel<false, kGroup> : fused_chains_kernel<true, kGroup>;
}

}  // namespace

// The dynamic shared memory of one chain's block: the single-chain kernel's.
extern "C" size_t fused_chains_smem_bytes(int model, int n_data, int db, int batch, int n,
                                          int d, int n_rows) {
  return sizeof(float) *
         static_cast<size_t>(make_layout(model, n_data, db, batch, n, d, n_rows).total);
}

// The models, their constants and the state rows of each chain are those of
// fused_advi_meanfield (see there).  n_chains blocks; n_rows is 8, or 14 when
// any chain runs COCOB (the other chains carry the six ext rows through).
// algo: the launch's rule code, ignored when rules is not null (a mixed
// sweep; the caller checks d >= 2 for its DoWG and DoG chains).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a launch
// the kernel does not take.
extern "C" int fused_chains(
    int model, const float* c0, const float* c1, int n_data, int db, int batch, float s0,
    float s1, const float* state_in, float* state_out, float* elbo_out, float* trace,
    const float* noise, int n_chains, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* seeds, unsigned long long it0, const float* lrs, const int* rules,
    float lr, float b1, float b2, float eps, float avg_eta, float clip_eps, int algo,
    int entropy, int grad_est, int op, float cocob_alpha, cudaStream_t stream) {
  const bool dist_rule = rules == nullptr && (algo == avi::kDoWG || algo == avi::kDoG);
  const bool mb = avi::is_minibatch(model);
  bool known = model == avi::kLogReg || model == avi::kGaussian || mb;
#ifdef AVI_AD_BODY  // K5's body is generated for one (n, d), runs alone; its constants are shared
  known = model == avi::kAD && n == avi::ad::kN && d == avi::ad::kD;
#endif
  if (!known || (dist_rule && d < 2) ||
      n_chains < 1 || (n_rows != 8 && n_rows != 14) ||
      (rules == nullptr && algo == avi::kCOCOB && n_rows != 14) ||
      (grad_est == avi::kScoreGrad && n < 2) || (log_every > 0 && steps % log_every != 0) ||
      (mb && (batch < 1 || batch % 8 != 0 || n_data % batch != 0 || n_data < batch ||
              reinterpret_cast<uintptr_t>(c0) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fused_chains_smem_bytes(model, n_data, db, batch, n, d, n_rows);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const bool def = rules == nullptr && avi::is_default(algo, entropy, grad_est, op);
#ifdef AVI_AD_BODY  // the dense instances only: the body runs alone
  const auto kernel = kernel_for<avi::mf::kDense>(def);
#else
  using avi::mf::kDensePlain;
  using avi::mf::kMinibatch;
  const int group = avi::mf::model_group(model, n_data, db, batch, n, d, n_rows);
  const auto kernel = group == kMinibatch    ? kernel_for<kMinibatch>(def)
                      : group == kDensePlain ? kernel_for<kDensePlain>(def)
                                             : kernel_for<avi::mf::kDense>(def);
#endif
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  const avi::Branch br{algo, entropy, grad_est, op, cocob_alpha};
  kernel<<<n_chains, kThreads, smem, stream>>>(
      model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise, n,
      d, n_rows, steps, log_every, seeds, it0, lrs, rules, h, br);
  return static_cast<int>(cudaGetLastError());
}
