// K1+K2 and the mean-field branches of K3, with K4's logreg, minibatch
// logreg, dense-Gaussian and diagonal-Gaussian bodies: the whole
// optimisation loop in one launch,
// mean-field Gaussian family x {Adam, descent, DoWG, DoG, COCOB} x {STL,
// closed-form zero-gradient, STL zero-gradient entropy} x {reparameterization
// gradient, VarGrad} x {ClipScale, entropy prox, identity} x polynomial
// averaging, on hierarchical logistic regression (all data, or a minibatch
// slab a step), a dense Gaussian or a diagonal Gaussian.
//
// Replaces ops/pallas/fused_advi.py::_run_chunk (both pallas_calls, plain and
// traced grid) in every MEANFIELD branch of _kernel (fused_advi.py:356-669),
// with _logreg_step_factory, _logreg_mb_step_factory,
// _logreg_mb_hbm_step_factory, _logreg_mb_hbm_db_step_factory,
// _mvnormal_step_factory or _gaussian_step_factory inlined as the model,
// _adam_candidate, _dowg_step, _dog_step and _cocob_update as the rules, and
// the step-indexed draw of location_scale_kernels.py.  The plain PyTorch
// version is fused_run_chunk_reference in ops/cuda/fused_advi.py.
//
// What bounds it on an H100: latency.  Steps are sequential, and one step at
// the flagship width (n = 10 samples, 208 x 61 design, d = 62) is about
// 2 x 10 x 208 x 61 = 254k multiply-adds, a few microseconds of one SM, with
// five block-wide barriers between its phases (DoWG and DoG add one).  The
// two products run block_mm (csrc/block_mm.cuh): register tiles of 10
// sample rows a thread, float4 loads of the aligned beta copy and of the
// weight rows, k split over 2 and 8 lanes; what bounds them is the bytes
// shared memory delivers to the lanes (PERF.md section 6).
// VarGrad needs only log pi and skips the second product (phase C).  No step
// touches device memory except to read injected noise, the Gaussian's (d,)
// constants or to write a trace entry.
//
// Design: one thread block runs the whole chunk with a loop over steps inside
// the block; this takes the place of the TPU's fori_loop and of the traced
// mode's sequential grid, which existed only to keep Mosaic from compiling a
// dynamic store per step.  Here the ELBO of every log_every-th step is stored
// straight into trace[k], so one kernel serves both modes.  The branch is a
// set of runtime codes (avi::Branch), uniform over the launch: one compiled
// instance serves every branch, and a second one the flagship branch with
// the codes constant (avi::kDefaultBranch).  The design matrix (50,752 bytes at
// the flagship shape, over the 48 KB static limit), the labels, the draws,
// the logits and the 8 (d,) state rows (14 with COCOB's accumulators) live
// in dynamic shared memory for the whole chunk where they fit one block;
// a dense launch that does not fit runs the kWide group instead
// (fused_meanfield_body.cuh wide_layout), and the dense Gaussian its own
// instance of it, kMvn (mvn_layout: its precision staged in shared memory,
// or streamed by rows through the TMA ring of csrc/mvnormal_product.cuh,
// beside u, z and g in shared memory or in the workspace): the state rows and
// row sums stay in shared memory, and the model's data, then the logits
// (K5: its scratch), then u, z and g move to device memory (the last two
// into a workspace the wrapper allocates), each step's phases and sums
// unchanged.  A minibatch launch that does not fit runs the kMbWide group
// (mb_layout): the logits, then the staged slab (read in place), then zb,
// u, z and g leave shared memory in that order.
//
// The minibatch body (fused_common.cuh; its two products on block_mm, as
// the flagship's) reads step it's slab k = it mod nb of the permuted
// design, B rows: in place, from device memory through L1
// and L2 (the JAX resident spec; at n = 16,384 rows the 3.9 MB design sits
// in the 50 MB L2); staged, copied into shared memory with cp.async at the
// top of the step while the draws and the slab-independent sums run (the
// JAX synchronous DMA); or staged with slab it+1 pulled into L2 during
// step it (the JAX double buffer: a second 125 KB slab of 61 features does
// not fit beside the first at B = 512, so the next slab goes to L2, not to
// shared memory).  The window follows the global iteration, so a chunk split
// anywhere, between a prefetch and its use included, changes no bit.  The
// transports' times at 16,384 rows (in L2) and at 500,000 (streamed from
// HBM) are in PERF.md section 5, from chip_smoke.py phase (u).  Each step:
//
//   A  draw u (Philox keyed by the global iteration, or a row of the injected
//      noise) and z = mu + sig * u; one warp per row sums |u|^2 (and, for
//      logreg, |beta|^2); log det of the scale;
//   B  log pi: logreg, logits l = beta X^T (block_mm; phase A also wrote
//      the betas to zb, rows 16-byte aligned, for its float4 loads),
//      then one warp per row forms likeadj (y - sigmoid(l)), the softplus
//      log-likelihood and log pi with the Exp log-det folded in
//      (fused_advi.py:43-51); the minibatch logreg likewise, its logits
//      by block_mm on zb and the slab's rows; Gaussian, one warp per row,
//      with its gradient;
//   C  reparameterization: logreg's grad log pi (block_mm on the weights
//      and X, the log-sigma lane beside it); VarGrad: one thread forms f = log q - log pi, the coefficients
//      (f_i - fbar) / n and the plain ELBO estimate (fused_advi.py:489-507);
//   D  one thread per lane forms dmu and dsig: STL g_z = -(1/n)(grad +
//      u / sig), the closed-form zero-gradient entropy without the u / sig,
//      the STL zero-gradient one with + 1/sig on dsig, or VarGrad's
//      sum_i c_i u / sig and sum_i c_i (u^2 - 1) / sig.  DoWG and DoG need
//      |g|^2 and |x - x0|^2 over every entry before any entry moves: a
//      fixed-order block reduction, then thread 0 forms eta and [v, r];
//      then one thread per lane applies the rule, the operator (ClipScale,
//      or the prox on the post-update sigma with the step's eta) and the
//      averaging with w = (eta_avg + 1) / (c + eta_avg), c = it + 1;
//   E  one thread of the last warp, beside D: the ELBO estimate at the
//      pre-update parameters (STL value, or the closed-form entropy for the
//      closed-form zero-gradient one).
//
// Every sum runs in a fixed order (sequential loops, warp butterflies and a
// warp-ordered block total, no atomics), so a launch is deterministic:
// run_chunk(a + b) equals run_chunk(a) then run_chunk(b) bit for bit.  The
// block uses one of the 132 SMs by nature; spreading a step over several
// SMs is later work.
//
// The body of the kernel is csrc/fused_meanfield_body.cuh, which the chains
// kernel (csrc/fused_chains.cu, K6) instantiates too.  The diagonal Gaussian
// (model 2) runs none of the phases above: its kGauss instance,
// fused_advi_meanfield_gauss_kernel (csrc/fused_gauss_body.cuh), draws,
// forms the gradient and applies the rule column by column in one pass a
// step, with no u, z or g arrays and no workspace at any width.
#include "fused_gauss_body.cuh"

namespace {

using avi::mf::kSmemLimit;
using avi::mf::kThreads;
using avi::mf::make_layout;

// One block an SM (minimum 1): left to aim at two, ptxas capped the
// flagship-branch instances at 64 registers and spilled.
template <bool kGeneral, int kGroup>
__global__ void __launch_bounds__(kThreads, 1) fused_advi_meanfield_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h, avi::Branch br) {
  avi::mf::run_chunk<kGeneral, kGroup>(model, c0, c1, n_data, db, batch, s0, s1, state_in,
                                       state_out, elbo_out, trace, noise, n, d, n_rows, steps,
                                       log_every, k0, k1, it0, h, br);
}

// The instance of a launch: the flagship branch's (switches constant) or
// the general one, of model group kGroup.
template <int kGroup>
auto kernel_for(bool flagship_branch) {
  return flagship_branch ? fused_advi_meanfield_kernel<false, kGroup> : fused_advi_meanfield_kernel<true, kGroup>;
}

// The kWide group (logreg and K5's body where the layout does not fit one
// block: fused_meanfield_body.cuh wide_layout; the Gaussians have their
// kMvn and kGauss instances), every branch by runtime codes,
// with its device workspace `ws` (wide_layout's floats, or null when its
// tier keeps none).  Its own kernel, so the instances above keep their
// signatures and their code.
__global__ void __launch_bounds__(kThreads, 1) fused_advi_meanfield_wide_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h, avi::Branch br,
    float* __restrict__ ws) {
  avi::mf::run_chunk<true, avi::mf::kWide>(model, c0, c1, n_data, db, batch, s0, s1, state_in,
                                           state_out, elbo_out, trace, noise, n, d, n_rows,
                                           steps, log_every, k0, k1, it0, h, br, ws);
}

#ifndef AVI_AD_BODY
// The kMvn group: the dense Gaussian alone (fused_meanfield_body.cuh
// mvn_layout, its product csrc/mvnormal_product.cuh), every branch by runtime
// codes, with its device workspace `ws` (tier 3's u, z and g, or null).
__global__ void __launch_bounds__(kThreads, 1) fused_advi_meanfield_mvn_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h, avi::Branch br,
    float* __restrict__ ws) {
  avi::mf::run_chunk<true, avi::mf::kMvn>(model, c0, c1, n_data, db, batch, s0, s1, state_in,
                                          state_out, elbo_out, trace, noise, n, d, n_rows,
                                          steps, log_every, k0, k1, it0, h, br, ws);
}

// The kMbWide group (a minibatch launch whose layout does not fit one block:
// fused_meanfield_body.cuh mb_layout), every branch by runtime codes, with
// its device workspace `ws` of mb_layout's floats.
__global__ void __launch_bounds__(kThreads, 1) fused_advi_meanfield_mb_wide_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h, avi::Branch br,
    float* __restrict__ ws) {
  avi::mf::run_chunk<true, avi::mf::kMbWide>(model, c0, c1, n_data, db, batch, s0, s1,
                                             state_in, state_out, elbo_out, trace, noise, n, d,
                                             n_rows, steps, log_every, k0, k1, it0, h, br, ws);
}

// The kGauss group: the diagonal Gaussian alone (csrc/fused_gauss_body.cuh,
// one column-fused pass a step; every branch by runtime codes), one chain.
__global__ void __launch_bounds__(kThreads, 1) fused_advi_meanfield_gauss_kernel(
    const float* __restrict__ c0, const float* __restrict__ c1, float s0,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    float* __restrict__ elbo_out, float* __restrict__ trace, const float* __restrict__ noise,
    int n, int d, int n_rows, int steps, int log_every, uint32_t k0, uint32_t k1,
    unsigned long long it0, avi::Hyper h, avi::Branch br) {
  avi::gauss::run_chunk(c0, c1, s0, state_in, state_out, elbo_out, trace, noise, 1, 1, n, d,
                        n_rows, steps, log_every, nullptr, k0, k1, it0, nullptr, nullptr, h, br);
}
#endif

}  // namespace

// The dynamic shared memory of a launch with every array in shared memory
// (make_layout; n_rows is 8, or 14 with COCOB): above the limit, the launch
// takes the kWide group's layout, fused_advi_meanfield_layout.
extern "C" size_t fused_advi_meanfield_smem_bytes(int model, int n_data, int db, int batch,
                                                  int n, int d, int n_rows) {
  if (model == avi::kGaussian) return avi::gauss::smem_bytes(n, d, n_rows, 1);
  return sizeof(float) *
         static_cast<size_t>(make_layout(model, n_data, db, batch, n, d, n_rows).total);
}

// What a launch takes (launch_layout): out[0] its model group, out[1] its
// bytes of dynamic shared memory, out[2] the floats of device workspace the
// caller passes as `ws` (0: none), out[3] the kWide group's tier.
extern "C" void fused_advi_meanfield_layout(int model, int n_data, int db, int batch, int n,
                                            int d, int n_rows, long long* out) {
  avi::mf::launch_layout(model, n_data, db, batch, n, d, n_rows, out);
}

#ifdef AVI_PHASE_CLOCKS
// Copies the instrumented build's avi_mf_phase_cycles (kPhases counters,
// fused_meanfield_body.cuh) to host memory `out` after the work queued so
// far, then zeroes them.  Returns the first CUDA error (0 on success).
extern "C" int fused_advi_meanfield_phase_cycles(unsigned long long* out) {
  using avi::mf::avi_mf_phase_cycles;
  cudaError_t err = cudaMemcpyFromSymbol(out, avi_mf_phase_cycles, sizeof(avi_mf_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[avi::mf::kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(avi_mf_phase_cycles, zero, sizeof(zero)));
}
#endif

// model 0: logreg, c0 = X (n_data, db), c1 = y (n_data,), s0 = likeadj,
// s1 = prior_scale, d = db + 1; model 1: dense Gaussian, c0 = mean (d,), c1
// = precision (d, d) with rows of round4(d) floats, 16-byte aligned, s0 =
// lognorm; model 2: diagonal Gaussian, c0 = mean (d,),
// c1 = inverse variances (d,), s0 = lognorm; models 3-5: minibatch logreg
// (in place, staged, staged + prefetch), c0 = permuted X (n_data, db) with
// n_data a multiple of batch and 16-byte aligned, c1 = yX (n_data / batch,
// db), s0 = likeadj = full n / batch, s1 = prior_scale, d = db + 1.  state_in, state_out: (n_rows,
// d) float32 rows mu sig m_mu v_mu m_sig v_sig avg_mu avg_sig, then with
// COCOB (n_rows = 14) its G, reward, theta of mu and of sig.  elbo_out: one
// float; trace: (steps / log_every,) or null when log_every == 0; noise:
// (steps, n, d) or null for in-kernel Philox.  algo, entropy, grad_est, op:
// the avi::Branch codes.  Model 6 (a library built with AVI_AD_BODY): K5's
// generated body at its (n, d), c0 = packed float constants, c1 = packed
// int32 constants (on the kWide group only a body whose constants are not
// staged, kStage 0).  ws: the kWide or kMbWide group's device workspace of
// fused_advi_meanfield_layout's out[2] floats (null when that is 0).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a launch the kernel does not take.
extern "C" int fused_advi_meanfield(
    int model, const float* c0, const float* c1, int n_data, int db, int batch, float s0,
    float s1, const float* state_in, float* state_out, float* elbo_out, float* trace,
    const float* noise, int n, int d, int steps, int log_every, uint32_t seed0,
    uint32_t seed1, unsigned long long it0, float lr, float b1, float b2, float eps,
    float avg_eta, float clip_eps, int algo, int entropy, int grad_est, int op,
    float cocob_alpha, float* ws, cudaStream_t stream) {
  const int n_rows = algo == avi::kCOCOB ? 14 : 8;
  const bool dist_rule = algo == avi::kDoWG || algo == avi::kDoG;
  const bool mb = avi::is_minibatch(model);
  bool known = model == avi::kLogReg || model == avi::kMvNormal || model == avi::kGaussian || mb;
#ifdef AVI_AD_BODY  // K5's body is generated for one (n, d), and runs alone
  known = model == avi::kAD && n == avi::ad::kN && d == avi::ad::kD;
#endif
  if (!known || (dist_rule && d < 2) ||
      (grad_est == avi::kScoreGrad && n < 2) ||
      (mb && (batch < 1 || batch % 8 != 0 || n_data % batch != 0 || n_data < batch ||
              reinterpret_cast<uintptr_t>(c0) % 16 != 0)) ||
      (model == avi::kMvNormal && (d > kThreads * 4 || reinterpret_cast<uintptr_t>(c1) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  long long lay[4];
  avi::mf::launch_layout(model, n_data, db, batch, n, d, n_rows, lay);
  const size_t smem = static_cast<size_t>(lay[1]);
  if (smem > kSmemLimit || (lay[2] > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool def = avi::is_default(algo, entropy, grad_est, op);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  const avi::Branch br{algo, entropy, grad_est, op, cocob_alpha};
  const int group = static_cast<int>(lay[0]);
#ifndef AVI_AD_BODY
  if (group == avi::mf::kGauss) {
    const auto gk = fused_advi_meanfield_gauss_kernel;
    cudaError_t err = cudaFuncSetAttribute(gk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gk<<<1, kThreads, smem, stream>>>(c0, c1, s0, state_in, state_out, elbo_out, trace, noise, n,
                                      d, n_rows, steps, log_every, seed0, seed1, it0, h, br);
    return static_cast<int>(cudaGetLastError());
  }
#endif
#ifdef AVI_AD_BODY  // the dense and kWide instances only: the body runs alone
  if (group != avi::mf::kDense && (group != avi::mf::kWide || avi::ad::kStage > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto wide = fused_advi_meanfield_wide_kernel;
#else
  const auto wide = group == avi::mf::kWide  ? fused_advi_meanfield_wide_kernel
                    : group == avi::mf::kMvn ? fused_advi_meanfield_mvn_kernel
                                             : fused_advi_meanfield_mb_wide_kernel;
#endif
  if (group == avi::mf::kWide || group == avi::mf::kMbWide || group == avi::mf::kMvn) {
    cudaError_t err = cudaFuncSetAttribute(wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    wide<<<1, kThreads, smem, stream>>>(model, c0, c1, n_data, db, batch, s0, s1, state_in,
                                        state_out, elbo_out, trace, noise, n, d, n_rows, steps,
                                        log_every, seed0, seed1, it0, h, br, ws);
    return static_cast<int>(cudaGetLastError());
  }
#ifdef AVI_AD_BODY
  const auto kernel = kernel_for<avi::mf::kDense>(def);
#else
  using avi::mf::kDensePlain;
  using avi::mf::kMinibatch;
  const auto kernel = group == kMinibatch    ? kernel_for<kMinibatch>(def)
                      : group == kDensePlain ? kernel_for<kDensePlain>(def)
                                             : kernel_for<avi::mf::kDense>(def);
#endif
  // above 48 KB only after this call; without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, stream>>>(
      model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise, n, d,
      n_rows, steps, log_every, seed0, seed1, it0, h, br);
  return static_cast<int>(cudaGetLastError());
}
