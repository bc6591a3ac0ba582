// Pieces shared by the fused whole-loop kernels (fused_advi_meanfield.cu,
// fused_advi_fullrank.cu): the hyperparameters and branch codes, a warp sum
// and a block reduction, the update rules (Adam, descent, DoWG, DoG, COCOB),
// the entropy proximal map, and the model bodies (hierarchical logistic
// regression and the diagonal Gaussian).
//
// A library built with AVI_AD_BODY (ops/cuda/_build.py build_generated)
// also has K5, the generated model body avi::ad::ad_body of a target's
// autograd graph (ops/cuda/ad_body.py), included at the end of this file.
//
// The logreg body replaces ops/pallas/fused_advi.py::_logreg_step_factory,
// the minibatch logreg body _logreg_mb_math (fused_advi.py:925-984) with
// its three slab transports (_logreg_mb_step_factory :987,
// _logreg_mb_hbm_step_factory :997, _logreg_mb_hbm_db_step_factory :1029),
// the diagonal-Gaussian body _gaussian_step_factory (the full-rank
// kernels'; the mean-field and chains kernels' is fused_gauss_body.cuh), the rules
// _adam_candidate, _dowg_step, _dog_step and _cocob_update (fused_advi.py:
// 242-281), and, in the mean-field and chains kernels, the dense-Gaussian
// body _mvnormal_step_factory (mvnormal_stream_body on csrc/
// mvnormal_product.cuh; the full-rank kernel has its own).  The bodies work on one block's shared-memory arrays: samples
// z (n, d) (for logreg d = db + 1, beta in lanes 0..db-1, t = log sigma in
// lane db), and fill per-row log pi and grad log pi (n, d).  Each phase is a
// loop over the block's threads; the caller puts a __syncthreads() between
// phases.  Every sum runs in a fixed order (sequential loops, warp
// butterflies, and block_sum2's warp-ordered total), so a launch is
// deterministic.
#pragma once

#include <cuda_runtime.h>

#include "block_mm.cuh"
#include "mvnormal_product.cuh"

namespace avi {

constexpr float kLog2Pi = 1.8378770664093453f;  // log(2 pi) in float32

// The kernels' switches, with the codes of ops/cuda/fused_advi.py
// (MODEL_CODES, ALGO_CODES, ENTROPY_CODES, GRAD_EST_CODES, OPERATOR_CODES).
// The minibatch logreg body takes three codes, one per slab transport.
enum Model {
  kLogReg = 0,
  kMvNormal = 1,
  kGaussian = 2,
  kMbInPlace = 3,   // the step reads its slab where it lies in device memory
  kMbStaged = 4,    // the block copies the slab into shared memory each step
  kMbPrefetch = 5,  // staged, and slab it+1 is pulled into L2 during step it
  kAD = 6,          // K5's generated body (libraries built with AVI_AD_BODY only)
};

__host__ __device__ inline bool is_minibatch(int model) {
  return model == kMbInPlace || model == kMbStaged || model == kMbPrefetch;
}
__host__ __device__ inline bool slab_staged(int model) {
  return model == kMbStaged || model == kMbPrefetch;
}
enum Algo { kAdam = 0, kDescent = 1, kDoWG = 2, kDoG = 3, kCOCOB = 4 };
enum Entropy { kSTL = 0, kClosedFormZero = 1, kSTLZero = 2 };
enum GradEst { kRepGrad = 0, kScoreGrad = 1 };
enum Operator { kClip = 0, kProx = 1, kNone = 2 };

struct Hyper {
  float lr, b1, b2, eps, avg_eta, clip_eps;
};

// The branch one launch runs; every thread takes the same one, so the
// switches cost no divergence.
struct Branch {
  int algo, entropy, grad_est, op;
  float cocob_alpha;  // COCOB's bet-fraction floor
};

// The flagship branch, STL x Adam x ClipScale.  The mean-field kernel has
// an instance for it with these switches constant, so that the other
// branches' code costs the flagship path nothing, and one for every other
// branch.
constexpr Branch kDefaultBranch{kAdam, kSTL, kRepGrad, kClip, 0.0f};

inline bool is_default(int algo, int entropy, int grad_est, int op) {
  return algo == kAdam && entropy == kSTL && grad_est == kRepGrad && op == kClip;
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same, order-fixed sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block totals of two per-thread partial sums, in a fixed order: a warp
// butterfly each, then thread 0 adds the warps' totals in warp order.  The
// result is valid in thread 0 only.  Every thread calls it; `red` holds
// 2 * warps floats of shared memory; one barrier inside.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red, int warps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[warps + warp] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
  if (threadIdx.x == 0)
    for (int w = 0; w < warps; ++w) {
      t.x += red[w];
      t.y += red[warps + w];
    }
  return t;
}

// optax scale_by_adam followed by scale(-lr), as _adam_candidate; 1 - b is
// formed in float32 from the float32 b, as the JAX fused kernel does.
__device__ __forceinline__ void adam_step(float& x, float& m, float& v, float g,
                                          const Hyper& h, float bc1, float bc2) {
  m = h.b1 * m + (1.0f - h.b1) * g;
  v = h.b2 * v + (1.0f - h.b2) * g * g;
  x = x + -h.lr * (m / bc1) / (sqrtf(v / bc2) + h.eps);
}

// DoWG (_dowg_step) or DoG (_dog_step) from the global sums of one step:
// gsq = |g|^2 and dist2 = |x - x0|^2 over every location and scale entry.
// Updates the accumulator v and the distance r in place; returns eta.  The
// floor on v guards an exactly zero first gradient, as in the reference.
__device__ __forceinline__ float distance_rule_step(int algo, float gsq, float dist2,
                                                    float& v, float& r) {
  r = fmaxf(sqrtf(dist2), r);
  if (algo == kDoWG) {
    v = v + r * r * gsq;
    return r * r / sqrtf(fmaxf(v, 1e-30f));
  }
  v = v + gsq;
  return r / sqrtf(fmaxf(v, 1e-30f));
}

// One COCOB-Backprop coordinate (_cocob_update): x1 rides the m_* slot, L
// the v_* slot, (G, R, theta) the ext slots.  A coordinate that has only
// seen zero gradients keeps x = x1.
__device__ __forceinline__ void cocob_step(float ca, float& x, float x1, float& L, float& G,
                                           float& R, float& th, float g) {
  const float L2 = fmaxf(L, fabsf(g));
  const float G2 = G + fabsf(g);
  const float R2 = fmaxf(R + (x - x1) * (-g), 0.0f);
  const float t2 = th - g;
  const float den = L2 * fmaxf(G2 + L2, ca * L2);
  const float bet = den > 0.0f ? t2 / den : 0.0f;
  x = x1 + bet * (L2 + R2);
  L = L2;
  G = G2;
  R = R2;
  th = t2;
}

// The branch's rule on one entry x with its slots m, v and COCOB's (G, R,
// theta); eta is the step size of descent, DoWG and DoG.
__device__ __forceinline__ void rule_step(const Branch& br, const Hyper& h, float eta,
                                          float bc1, float bc2, float& x, float& m, float& v,
                                          float& G, float& R, float& th, float g) {
  if (br.algo == kAdam)
    adam_step(x, m, v, g, h, bc1, bc2);
  else if (br.algo == kCOCOB)
    cocob_step(br.cocob_alpha, x, m, v, G, R, th, g);
  else
    x = x - eta * g;
}

// The closed-form proximal step of the entropy (ProximalLocationScaleEntropy)
// on one scale-diagonal entry: sigma / 2 + sqrt(sigma^2 + 4 eta) / 2.
__device__ __forceinline__ float entropy_prox(float s, float eta) {
  return 0.5f * s + 0.5f * sqrtf(s * s + 4.0f * eta);
}

// The post-update operator on one scale-diagonal entry.
__device__ __forceinline__ float scale_operator(int op, float s, float eta, const Hyper& h) {
  if (op == kClip) return fmaxf(s, h.clip_eps);
  if (op == kProx) return entropy_prox(s, eta);
  return s;
}

// K4's diagonal-Gaussian body (_gaussian_step_factory) in the full-rank
// kernels, one warp per sample row: log pi = -sum_j (z - m)^2 v / 2 +
// lognorm and, when g is not null, grad = -(z - m) v.  mean and iv (the
// inverse variances) are (d,) arrays.  The mean-field and chains kernels run
// the diagonal Gaussian on their kGauss group instead (csrc/fused_gauss_body.cuh:
// one column-fused pass a step); their kDense instances keep this call
// compiled, though no launch takes it there, so that their code is as before.
__device__ __forceinline__ void gaussian_body(const float* __restrict__ mean,
                                              const float* __restrict__ iv, float lognorm,
                                              const float* z, int n, int d, float* logpi,
                                              float* g, int warp, int warps, int lane) {
  for (int i = warp; i < n; i += warps) {
    float q = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float diff = z[i * d + j] - mean[j];
      q += diff * diff * iv[j];
      if (g != nullptr) g[i * d + j] = -diff * iv[j];
    }
    q = warp_sum(q);
    if (lane == 0) logpi[i] = -0.5f * q + lognorm;
  }
}

// K4's dense-Gaussian body (_mvnormal_step_factory) in the mean-field and
// chains kernels' kMvn instances: diff = z - m in place of the samples z (no
// later phase of those kernels reads z on this model), grad = -diff P by
// mvn::product (csrc/mvnormal_product.cuh: P by rows, staged or streamed
// through the TMA ring as S places it, each output one fmaf chain with k in
// order), then one warp a row: log pi = sum_j diff grad / 2 + lognorm.  z
// and g may lie in shared or device memory; S's plan is for M rows (the
// block's most), of which n run here.  Every thread of the block calls it;
// barriers inside, the caller puts one after.  What bounds it on an H100:
// the product's n d^2 multiply-adds on one SM, and at tiers >= 1 P's d^2
// floats crossing from L2 into the SM each step (1 MB at d = 512).
template <int kThreads>
__device__ __forceinline__ void mvnormal_stream_body(const float* __restrict__ mean,
                                                     const float* P, const mvn::Stream& S,
                                                     float* smem, uint32_t& fill, float lognorm,
                                                     float* z, int n, int d, float* logpi,
                                                     float* g, int tid, int warp, int warps,
                                                     int lane) {
  for (int idx = tid; idx < n * d; idx += kThreads) z[idx] = __fsub_rn(z[idx], mean[idx % d]);
  __syncthreads();
  mvn::product<kThreads>(S, smem, z, n, d, P, fill, tid,
                         [=](int i, int j, float v) { g[i * d + j] = -v; });
  for (int i = warp; i < n; i += warps) {
    float q = 0.0f;
    for (int j = lane; j < d; j += 32) q += z[i * d + j] * g[i * d + j];
    q = warp_sum(q);
    if (lane == 0) logpi[i] = 0.5f * q + lognorm;
  }
}

// The hand logreg body's two products through block_mm: a thread's tile
// (rows x columns) and the lanes that split k.  The logits (n, n_data) over
// db terms take 10 rows x 1 datum a thread, k over 2 lanes (416 threads at
// the flagship); the likelihood gradient (n, db) over n_data terms 10 rows
// x 1 feature a thread, k over 8 lanes (488 threads).  Of the tiles timed
// beside each other on an H100 (PERF.md section 6) these ran the
// flagship chunk fastest: larger tiles load fewer shared-memory bytes a
// multiply-add but leave fewer threads or need more shuffles.  The
// full-rank kernel, capped at 88 registers, keeps the routines below
// (logreg_logits_each, logreg_grad_each): block_mm spilled there.
constexpr int kLogitRows = 10, kLogitCols = 1, kLogitSplit = 2;
constexpr int kGradRows = 10, kGradCols = 1, kGradSplit = 8;

struct LogReg {
  const float* X;  // (n_data, db) shared
  const float* y;  // (n_data,) shared
  float* l;        // (n, ldl) shared: logits, then likelihood weights
  float* zb;       // (n, ldz) shared: the samples' beta lanes, rows 16-byte aligned
  int n_data, db, ldl, ldz;
  float likeadj, prior_scale;
};

// Per-row sums: beta_sq = |beta|^2, t, inv_sig2 = e^{-2t} (one warp a row).
__device__ __forceinline__ void logreg_rows(const LogReg& m, const float* z, int n,
                                            int d, float* beta_sq, float* tcol,
                                            float* inv_sig2, int warp, int warps,
                                            int lane) {
  for (int i = warp; i < n; i += warps) {
    float bsq = 0.0f;
    for (int j = lane; j < m.db; j += 32) {
      const float b = z[i * d + j];
      bsq += b * b;
    }
    bsq = warp_sum(bsq);
    if (lane == 0) {
      const float t = z[i * d + m.db];
      beta_sq[i] = bsq;
      tcol[i] = t;
      inv_sig2[i] = expf(-2.0f * t);
    }
  }
}

// Logits l = beta X^T by block_mm: with kAligned the betas from the aligned
// copy zb (float4 along the features), else from the samples z; X^T is X's
// rows, one load a feature.  Both sum in one order, whatever the tile (TM
// rows x TN data a thread; K6's blocks of several chains take wider ones).
template <int kThreads, bool kAligned, int TM = kLogitRows, int TN = kLogitCols>
__device__ __forceinline__ void logreg_logits(const LogReg& m, const float* z, int n, int d,
                                              int tid) {
  float* l = m.l;
  const int ldl = m.ldl;
  block_mm<kThreads, TM, TN, kLogitSplit, kAligned, false>(
      n, m.n_data, m.db, kAligned ? m.zb : z, kAligned ? m.ldz : d, 1, m.X, 1, m.db, tid,
      [=](int i, int k, float v) { l[i * ldl + k] = v; });
}

// The logits one thread per (row, datum), k in order (the full-rank kernel).
__device__ __forceinline__ void logreg_logits_each(const LogReg& m, const float* z, int n,
                                                   int d, int tid, int threads) {
  for (int idx = tid; idx < n * m.n_data; idx += threads) {
    const int i = idx / m.n_data;
    const int k = idx - i * m.n_data;
    const float* zr = z + i * d;
    const float* xr = m.X + k * m.db;
    float acc = 0.0f;
    for (int j = 0; j < m.db; ++j) acc = fmaf(zr[j], xr[j], acc);
    m.l[idx] = acc;
  }
}

// Likelihood weights likeadj (y - sigmoid(l)) in place of the logits, and
// log pi per row with the Exp log-det folded in (one warp a row).
__device__ __forceinline__ void logreg_logpi(const LogReg& m, int n, const float* beta_sq,
                                             const float* tcol, const float* inv_sig2,
                                             float* logpi, int warp, int warps,
                                             int lane) {
  const float s2 = m.prior_scale * m.prior_scale;
  const float log_s = logf(m.prior_scale);
  const float fdb = static_cast<float>(m.db);
  const float norm_const = 0.5f * static_cast<float>(m.db + 1) * kLog2Pi;
  for (int i = warp; i < n; i += warps) {
    float ll = 0.0f;
    for (int k = lane; k < m.n_data; k += 32) {
      const float l = m.l[i * m.ldl + k];
      const float p = 1.0f / (1.0f + expf(-l));
      const float sp = fmaxf(l, 0.0f) + log1pf(expf(-fabsf(l)));
      ll += m.y[k] * l - sp;
      m.l[i * m.ldl + k] = m.likeadj * (m.y[k] - p);
    }
    ll = warp_sum(ll);
    if (lane == 0) {
      const float t = tcol[i];
      logpi[i] = m.likeadj * ll - 0.5f * beta_sq[i] * inv_sig2[i] - fdb * t -
                 t * t / (2.0f * s2) - log_s - norm_const;
    }
  }
}

// grad log pi: X^T weights - beta e^{-2t} by block_mm (with kAligned the
// weights' rows float4 along the data, X one load a datum; TM rows x TN
// features a thread), and |beta|^2 e^{-2t} - db - t / s^2 for the
// log-sigma lane.
template <int kThreads, bool kAligned, int TM = kGradRows, int TN = kGradCols>
__device__ __forceinline__ void logreg_grad(const LogReg& m, const float* z, int n, int d,
                                            const float* beta_sq, const float* tcol,
                                            const float* inv_sig2, float* g, int tid) {
  block_mm<kThreads, TM, TN, kGradSplit, kAligned, false>(
      n, m.db, m.n_data, m.l, m.ldl, 1, m.X, m.db, 1, tid,
      [=](int i, int j, float v) { g[i * d + j] = v - z[i * d + j] * inv_sig2[i]; });
  const float s2 = m.prior_scale * m.prior_scale;
  const float fdb = static_cast<float>(m.db);
  for (int i = tid; i < n; i += kThreads)
    g[i * d + m.db] = beta_sq[i] * inv_sig2[i] - fdb - tcol[i] / s2;
}

// grad log pi one thread per (row, lane), k in order (the full-rank
// kernel; its logits rows are n_data floats apart).
__device__ __forceinline__ void logreg_grad_each(const LogReg& m, const float* z, int n,
                                                 int d, const float* beta_sq,
                                                 const float* tcol, const float* inv_sig2,
                                                 float* g, int tid, int threads) {
  const float s2 = m.prior_scale * m.prior_scale;
  const float fdb = static_cast<float>(m.db);
  for (int idx = tid; idx < n * d; idx += threads) {
    const int i = idx / d;
    const int j = idx - i * d;
    float gv;
    if (j < m.db) {
      const float* gl = m.l + i * m.n_data;
      float acc = 0.0f;
      for (int k = 0; k < m.n_data; ++k) acc = fmaf(gl[k], m.X[k * m.db + j], acc);
      gv = acc - z[idx] * inv_sig2[i];
    } else {
      gv = beta_sq[i] * inv_sig2[i] - fdb - tcol[i] / s2;
    }
    g[idx] = gv;
  }
}

// ---------------------------------------------------------------------------
// K4's minibatch logreg body (_logreg_mb_math).  The data are the permuted
// design X (n_used, db), n_used = nb * B, and the per-batch label sums yX
// (nb, db), yX[k] = sum_{j in batch k} y_j X_j, so the labels never enter
// the kernel.  Step it uses batch k = it mod nb, rows k*B .. k*B + B - 1:
//
//   ylogit = beta . yX[k];  l = beta X_k^T;  p = sigmoid(l)
//   log pi = likeadj (ylogit - sum softplus(l)) - |beta|^2 e^{-2t} / 2
//            - db t - t^2 / (2 s^2) - log s - (db + 1)/2 log 2 pi
//   dbeta  = likeadj (yX[k] - p X_k) - beta e^{-2t};  dt as in the logreg
//
// with likeadj = n_data / B.  The slab pointer is generic: the rows in
// device memory (in place) or the block's shared copy (staged), through one
// code path, so the three transports compute bit-identical results.
//
// The mean-field and chains kernels run the two (n, B, db) products on
// block_mm (logreg_mb_logits, logreg_mb_grad): the logits read the betas
// from the aligned copy zb (float4 along the features) and the slab's rows
// one feature a load; the gradient reads the rows of p as float4s along
// the batch and the slab one feature a load; each splits k over lanes in a
// fixed order (block_mm), so a launch and the three transports give the
// same bits.  One output a thread, with 11 shared loads per 10
// multiply-adds in the logits and 512-term chains of two loads a
// multiply-add in the gradient, took 43 of a 49.4 us step on an H100
// (B = 512, db = 61; PERF.md section 5).  The full-rank kernel keeps those routines
// (logreg_mb_logits_each, logreg_mb_grad_each): block_mm spilled under its
// 88-register cap.
// ---------------------------------------------------------------------------

struct LogRegMB {
  const float* X;   // (B, db) slab of this step: device memory or shared
  const float* yx;  // (db,) yX[k], shared
  float* l;         // (n, B) shared: logits, then sigmoid(l)
  const float* zb;  // (n, ldz) shared: the samples' beta lanes, rows 16-byte aligned
  int B, db, ldz;
  float likeadj, prior_scale;
};

// The tiles of the two products (block_mm: rows x columns a thread, lanes
// splitting k).  At B = 512: the logits 10 rows x 4 data a thread, k over
// 4 lanes (512 threads); the gradient 10 rows x 2 features, k over 16
// lanes (496 threads at db = 61).  Of eight pairs timed beside each other
// on an H100 at db = 61 and 60 (PERF.md section 6) these ran each product
// fastest; one datum or feature a thread (the flagship's tiles) took
// 11.1 and 12.5 us a step against 7.1 and 8.3.
constexpr int kMbLogitRows = 10, kMbLogitCols = 4, kMbLogitSplit = 4;
constexpr int kMbGradRows = 10, kMbGradCols = 2, kMbGradSplit = 16;

// Issue the copy of `floats` floats (a multiple of 4, both ends 16-byte
// aligned) from device memory to shared memory with cp.async (16 bytes a
// thread an instruction); they land before cp_async_wait_all().
__device__ __forceinline__ void slab_copy_async(float* dst, const float* src, int floats,
                                                int tid, int threads) {
  for (int q = tid; q < floats / 4; q += threads) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + 4 * q));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Pull `floats` floats of device memory into L2, one 128-byte line a thread
// an instruction (no data reaches the block; the next step's copy hits L2).
__device__ __forceinline__ void prefetch_l2(const float* src, int floats, int tid,
                                            int threads) {
  for (int line = tid; line < (floats + 31) / 32; line += threads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + 32 * line));
}

// Per-row sums, one warp a row: beta_sq = |beta|^2, t, inv_sig2 = e^{-2t}
// and ylogit = beta . yX[k] (slab-independent: runs while the slab lands).
__device__ __forceinline__ void logreg_mb_rows(const LogRegMB& m, const float* z, int n,
                                               int d, float* beta_sq, float* tcol,
                                               float* inv_sig2, float* ylogit, int warp,
                                               int warps, int lane) {
  for (int i = warp; i < n; i += warps) {
    float bsq = 0.0f, yl = 0.0f;
    for (int j = lane; j < m.db; j += 32) {
      const float b = z[i * d + j];
      bsq += b * b;
      yl += b * m.yx[j];
    }
    bsq = warp_sum(bsq);
    yl = warp_sum(yl);
    if (lane == 0) {
      const float t = z[i * d + m.db];
      beta_sq[i] = bsq;
      tcol[i] = t;
      inv_sig2[i] = expf(-2.0f * t);
      ylogit[i] = yl;
    }
  }
}

// Logits l = beta X_k^T by block_mm: the betas from zb, the slab's rows
// where its transport put them (both through one code path).
template <int kThreads>
__device__ __forceinline__ void logreg_mb_logits(const LogRegMB& m, int n, int tid) {
  float* l = m.l;
  const int B = m.B;
  block_mm<kThreads, kMbLogitRows, kMbLogitCols, kMbLogitSplit, true, false>(
      n, B, m.db, m.zb, m.ldz, 1, m.X, 1, m.db, tid,
      [=](int i, int k, float v) { l[i * B + k] = v; });
}

constexpr int kMbRows = 16;  // sample rows a thread accumulates at once (_each)

// Logits one thread per datum k of the slab (the full-rank kernel): the
// thread reads its slab row once for up to kMbRows sample rows (the z
// reads are warp-wide broadcasts); sums run over the features in order.
__device__ __forceinline__ void logreg_mb_logits_each(const LogRegMB& m, const float* z,
                                                      int n, int d, int tid, int threads) {
  for (int k = tid; k < m.B; k += threads) {
    const float* xr = m.X + static_cast<size_t>(k) * m.db;
    for (int i0 = 0; i0 < n; i0 += kMbRows) {
      float acc[kMbRows];
#pragma unroll
      for (int r = 0; r < kMbRows; ++r) acc[r] = 0.0f;
      for (int j = 0; j < m.db; ++j) {
        const float x = xr[j];
#pragma unroll
        for (int r = 0; r < kMbRows; ++r)
          if (i0 + r < n) acc[r] = fmaf(z[(i0 + r) * d + j], x, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kMbRows; ++r)
        if (i0 + r < n) m.l[(i0 + r) * m.B + k] = acc[r];
    }
  }
}

// sigmoid(l) in place of the logits and log pi per row with the Exp log-det
// folded in (one warp a row).
__device__ __forceinline__ void logreg_mb_logpi(const LogRegMB& m, int n, const float* beta_sq,
                                                const float* tcol, const float* inv_sig2,
                                                const float* ylogit, float* logpi, int warp,
                                                int warps, int lane) {
  const float s2 = m.prior_scale * m.prior_scale;
  const float log_s = logf(m.prior_scale);
  const float fdb = static_cast<float>(m.db);
  const float norm_const = 0.5f * static_cast<float>(m.db + 1) * kLog2Pi;
  for (int i = warp; i < n; i += warps) {
    float sp_sum = 0.0f;
    for (int k = lane; k < m.B; k += 32) {
      const float l = m.l[i * m.B + k];
      sp_sum += fmaxf(l, 0.0f) + log1pf(expf(-fabsf(l)));
      m.l[i * m.B + k] = 1.0f / (1.0f + expf(-l));
    }
    sp_sum = warp_sum(sp_sum);
    if (lane == 0) {
      const float t = tcol[i];
      logpi[i] = m.likeadj * (ylogit[i] - sp_sum) - 0.5f * beta_sq[i] * inv_sig2[i] -
                 fdb * t - t * t / (2.0f * s2) - log_s - norm_const;
    }
  }
}

// grad log pi: likeadj (yX[k] - p X_k) - beta e^{-2t} by block_mm (the
// rows of p as float4s along the batch), and |beta|^2 e^{-2t} - db - t / s^2
// for the log-sigma lane.
template <int kThreads>
__device__ __forceinline__ void logreg_mb_grad(const LogRegMB& m, const float* z, int n, int d,
                                               const float* beta_sq, const float* tcol,
                                               const float* inv_sig2, float* g, int tid) {
  const float likeadj = m.likeadj;
  const float* yx = m.yx;
  block_mm<kThreads, kMbGradRows, kMbGradCols, kMbGradSplit, true, false>(
      n, m.db, m.B, m.l, m.B, 1, m.X, m.db, 1, tid, [=](int i, int j, float v) {
        g[i * d + j] = likeadj * (yx[j] - v) - z[i * d + j] * inv_sig2[i];
      });
  const float s2 = m.prior_scale * m.prior_scale;
  const float fdb = static_cast<float>(m.db);
  for (int i = tid; i < n; i += kThreads)
    g[i * d + m.db] = beta_sq[i] * inv_sig2[i] - fdb - tcol[i] / s2;
}

// grad log pi one thread per (row, lane), a sum over the batch in order
// (the full-rank kernel).
__device__ __forceinline__ void logreg_mb_grad_each(const LogRegMB& m, const float* z, int n,
                                                    int d, const float* beta_sq,
                                                    const float* tcol, const float* inv_sig2,
                                                    float* g, int tid, int threads) {
  const float s2 = m.prior_scale * m.prior_scale;
  const float fdb = static_cast<float>(m.db);
  for (int idx = tid; idx < n * d; idx += threads) {
    const int i = idx / d;
    const int j = idx - i * d;
    float gv;
    if (j < m.db) {
      const float* pl = m.l + i * m.B;
      float acc = 0.0f;
      for (int k = 0; k < m.B; ++k) acc = fmaf(pl[k], m.X[static_cast<size_t>(k) * m.db + j], acc);
      gv = m.likeadj * (m.yx[j] - acc) - z[idx] * inv_sig2[i];
    } else {
      gv = beta_sq[i] * inv_sig2[i] - fdb - tcol[i] / s2;
    }
    g[idx] = gv;
  }
}

// The top of a minibatch step it (batch k = it mod nb): yX[k] into `yx`,
// and for the staged transports the slab's copy into `stage` (waited for
// with cp_async_wait_all() before its first use); the prefetching one also
// pulls slab (it + 1) mod nb into L2.  Returns the slab pointer the body
// reads: `stage`, or the rows in device memory.
__device__ __forceinline__ const float* minibatch_step_begin(
    int model, const float* __restrict__ X, const float* __restrict__ yX, int B, int db,
    int nb, unsigned long long it, float* stage, float* yx, int tid, int threads) {
  const int k = static_cast<int>(it % static_cast<unsigned long long>(nb));
  const size_t slab = static_cast<size_t>(B) * db;
  const float* src = X + static_cast<size_t>(k) * slab;
  for (int j = tid; j < db; j += threads) yx[j] = yX[static_cast<size_t>(k) * db + j];
  if (!slab_staged(model)) return src;
  slab_copy_async(stage, src, static_cast<int>(slab), tid, threads);
  if (model == kMbPrefetch) {
    const int kn = static_cast<int>((it + 1) % static_cast<unsigned long long>(nb));
    prefetch_l2(X + static_cast<size_t>(kn) * slab, static_cast<int>(slab), tid, threads);
  }
  return stage;
}

// The top of a minibatch step whose staged slab does not fit in shared
// memory (the tiered layouts): yX[k] into `yx`, and the rows of slab k read
// where they lie in the permuted design, as the in-place transport reads
// them; the prefetching transport still pulls slab (it + 1) mod nb into L2.
// Returns the slab pointer the body reads.
__device__ __forceinline__ const float* minibatch_step_in_place(
    int model, const float* __restrict__ X, const float* __restrict__ yX, int B, int db,
    int nb, unsigned long long it, float* yx, int tid, int threads) {
  const int k = static_cast<int>(it % static_cast<unsigned long long>(nb));
  const size_t slab = static_cast<size_t>(B) * db;
  for (int j = tid; j < db; j += threads) yx[j] = yX[static_cast<size_t>(k) * db + j];
  if (model == kMbPrefetch) {
    const int kn = static_cast<int>((it + 1) % static_cast<unsigned long long>(nb));
    prefetch_l2(X + static_cast<size_t>(kn) * slab, static_cast<int>(slab), tid, threads);
  }
  return X + static_cast<size_t>(k) * slab;
}

}  // namespace avi

#ifdef AVI_AD_BODY  // the generated body's file name, e.g. ad_0123456789abcdef.cuh
#define AVI_AD_STR2(x) #x
#define AVI_AD_STR(x) AVI_AD_STR2(x)
#include AVI_AD_STR(AVI_AD_BODY)
#endif
