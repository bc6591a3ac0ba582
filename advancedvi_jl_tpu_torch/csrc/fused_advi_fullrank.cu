// K3 (full-rank branches) with K4's dense-Gaussian, diagonal-Gaussian and
// minibatch logreg bodies (and, built with AVI_AD_BODY, K5's generated body
// of any traceable target, under that macro): the
// whole optimisation loop in one launch, full-rank Gaussian family x {Adam,
// descent, DoWG, DoG, COCOB} x {STL, closed-form zero-gradient, STL
// zero-gradient entropy} x {ClipScale, entropy prox, identity} on the
// diagonal x polynomial averaging, on hierarchical logistic regression (all
// data, or a minibatch slab a step), a dense Gaussian target N(m, P^{-1})
// or a diagonal Gaussian.
//
// Replaces ops/pallas/fused_advi.py::_run_chunk (both pallas_calls, plain and
// traced grid) in the FULLRANK x REPGRAD branches of _kernel
// (fused_advi.py:356-669; VarGrad is mean-field only, as there), with
// _backsub_ct / _backsub_ct_blocked as the whitening, _logreg_step_factory,
// the three minibatch factories (_logreg_mb_step_factory,
// _logreg_mb_hbm_step_factory, _logreg_mb_hbm_db_step_factory; the slab
// transports as in fused_advi_meanfield.cu), _mvnormal_step_factory or
// _gaussian_step_factory as the model, and
// _adam_candidate, _dowg_step, _dog_step and _cocob_update as the rules.
// The plain PyTorch version is fused_fullrank_run_chunk_reference in
// ops/cuda/fused_advi.py.
//
// What bounds it on an H100: latency, as in the mean-field kernel: steps are
// sequential.  A step at d = 62 (logreg, n = 10) is the mean-field step's
// 254k multiply-adds plus the whitening (two 32-column panels) and a
// rule pass over 1,953 lower-triangle entries.  At d = 512 (mvnormal) it is
// 2.6M multiply-adds for the gradient (P is 1 MB), 1.3M for z = m + u C^T,
// the whitening's 16 panels, and a rule pass that reads and writes
// four 131k-entry lower triangles (seven with COCOB): megabytes of L2
// traffic a step through one SM, whose 16 warps cannot hide the L2 latency.
//
// Design: one thread block runs the whole chunk, a loop over steps inside
// the block.  The draws u, the samples z, grad log pi and the whitened
// draws w (n x d each), the location rows and, for logreg, X, y and the
// logits live in dynamic shared memory (the logreg and minibatch logreg
// products one output a thread, k in order: the mean-field kernel's
// block_mm tiles spilled under this kernel's 88-register cap).  The k
// (d, d) scale matrices (4, or 7 with COCOB's G, reward and theta) live in
// shared memory when they fit
// beside those in one block's 227 KB (d = 62: 61.5 KB, or 107.6 KB with
// COCOB), and otherwise in the output buffer in device memory, where they
// stay resident in the 50 MB L2 (d = 512: 4 MB, or 7 MB); then the
// whitening's panel operators (d/32 x 4 KB) go to shared memory when they
// fit too, else to a scratch tensor in device memory (place()); one code
// path serves every placement through generic pointers.  With a staged
// 512-row minibatch slab everything still fits: 226,884 bytes at d = 62 (a
// 124,928-byte slab of 61 features, 20,480 of logits, 4 x 15,376 of
// matrices, 8,192 of operators; 101,956 in place), 222,684 at d = 61;
// COCOB's seven matrices do not, and go to device memory (166,124 bytes
// left in shared).  The branch is a set of
// runtime codes (avi::Branch), uniform over the launch, and one compiled
// kernel serves
// every branch: an instance with the flagship branch's codes constant, as
// the mean-field kernel has, spilled and was slower.  Each step:
//
//   A  draw u (Philox keyed by the global iteration, or injected noise);
//      z = m + u C^T over the lower triangle (one warp per row of C, all
//      sample rows at once, so C is read once and coalesced); |u|^2 per
//      row and log det C = sum log C[j, j];
//   B  the model: logreg (fused_common.cuh), the dense Gaussian, grad =
//      -(z - m) P (one thread per column of P, all sample rows at once) and
//      log pi = (z - m) . grad / 2 + lognorm, or the diagonal Gaussian;
//   C  whitening w = C^{-T} u: the rows of U C^{-1} by K8's blocked mode C
//      (trisolve_rows.cuh): every 32 x 32 diagonal block of C inverted at
//      once, one warp a block (C changes every step), then panel by panel
//      from the last one product a sample row (one warp a row) and the
//      update of the columns left (a thread per column and row group): d/32
//      panels of two barriers, no d-long chain of divisions per row (7.4
//      us of a 33.2 us step at d = 62, 121 of 563 at d = 512: H100 80GB
//      HBM3, 700 W, the AVI_PHASE_CLOCKS build).  The closed-form
//      zero-gradient entropy has no whitening term and skips this phase;
//   D  g_z = -(1/n)(grad + w) (without w for the closed-form zero-gradient
//      entropy); dmu = sum g_z; for each lower entry (a, b) (one warp per
//      row, coalesced) dC = sum_i g_z[i, a] u[i, b], + 1 / C[a, a] on the
//      diagonal for the STL zero-gradient entropy, formed where it is used;
//      then the rule, the operator on the diagonal (ClipScale, or the prox
//      on the post-update diagonal with the step's eta) and the averaging
//      in the same pass: no d^2 temporaries, and the strict upper triangle
//      is never touched (its gradient is zero, so it stays as it came, as in
//      the reference).  DoWG and DoG need |g|^2 and |x - x0|^2 over every
//      entry before any entry moves: a first pass forms dC for the sums
//      only, a fixed-order block reduction gives thread 0 eta and [v, r],
//      and the update pass forms dC again.  Forming dC twice costs n
//      multiply-adds per lower entry (19,530 at d = 62) and keeps the pass
//      free of a d^2 store; storing dC in the unused v_sig would cost as
//      many shared-memory writes and reads, and a zeroing pass;
//   E  thread 0: the ELBO estimate at the pre-update parameters (STL value,
//      or the closed-form entropy for the closed-form zero-gradient one).
//
// Every sum runs in a fixed order, so run_chunk(a + b) equals run_chunk(a)
// then run_chunk(b) bit for bit, and one kernel serves the traced and
// untraced modes (trace[k] is stored directly).
#include "fused_common.cuh"
#include "philox.cuh"
#include "trisolve_rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block
constexpr int kRowChunk = 16;  // sample rows a thread accumulates at once
using avi::kLog2Pi;

// Offsets (in floats) of the shared-memory arrays.
struct Layout {
  int X, y, l, u, z, g, w, vec, dm, row, red, mat, inv, total;
#ifdef AVI_AD_BODY
  int ad, adc;  // K5's scratch and its staged float constants
#endif
};

// n_data is the design's rows; a minibatch model keeps one B-row slab (the
// staged transports) and yX[k] in `y`.
__host__ __device__ inline Layout make_layout(int model, int n_data, int db, int batch,
                                              int n, int d, int k, bool mat_in_smem,
                                              bool inv_in_smem) {
  Layout L;
  int o = 0;
  const bool lr = model == avi::kLogReg;
  const bool mb = avi::is_minibatch(model);
  L.X = o;   o += lr ? n_data * db : (avi::slab_staged(model) ? batch * db : 0);
  L.y = o;   o += lr ? n_data : (mb ? db : 0);  // labels, or yX[k]
  L.l = o;   o += lr ? n * n_data : (mb ? n * batch : 0);  // logits, then weights
  L.u = o;   o += n * d;                 // base draws
  L.z = o;   o += n * d;                 // samples
  L.g = o;   o += n * d;                 // grad log pi, then g_z
  L.w = o;   o += n * d;                 // (z - m) for mvnormal, then C^{-T} u
  L.vec = o; o += k * d;                 // mu m_mu v_mu avg_mu [G R theta of mu]
  L.dm = o;  o += d;                     // dmu of the step
  L.row = o; o += 6 * n + 1;             // beta_sq t inv_sig2 logpi u2 ylogit, logdet
  L.red = o; o += 2 * kWarps + 1;        // block reduction, then eta
#ifdef AVI_AD_BODY
  if (model == avi::kAD) o = avi::round4(o);
  L.ad = o;  o += model == avi::kAD ? avi::ad::kScratch : 0;  // the generated body's
  if (model == avi::kAD) o = avi::round4(o);
  L.adc = o; o += model == avi::kAD ? avi::ad::kStage : 0;    // its staged constants
#endif
  L.mat = o; o += mat_in_smem ? k * d * d : 0;  // sig m_sig v_sig avg_sig [G R theta]
  L.inv = o; o += inv_in_smem ? avi::tri_panels(d) * avi::kTriBlock : 0;  // whitening's M_p
  L.total = o;
  return L;
}

// Where the scale matrices and the whitening's panel operators live: the
// matrices in shared memory when they fit beside the per-step arrays (as
// before the operators existed), then the operators when they fit too;
// each in device memory otherwise.
struct Placement {
  bool mat, inv;
};

inline Placement place(int model, int n_data, int db, int batch, int n, int d, int k) {
  auto fits = [&](bool mat, bool inv) {
    return sizeof(float) * static_cast<size_t>(
                               make_layout(model, n_data, db, batch, n, d, k, mat, inv).total) <=
           kSmemLimit;
  };
  const bool mat = fits(true, false);
  return {mat, fits(mat, true)};
}

// dC of lower entry (a, b): sum_i g_z[i, a] u[i, b] (the same arithmetic in
// both passes of DoWG and DoG).
__device__ __forceinline__ float lower_grad(const float* gs, const float* us, int n, int d,
                                            int a, int b) {
  float dc = 0.0f;
  for (int i = 0; i < n; ++i) dc = fmaf(gs[i * d + a], us[i * d + b], dc);
  return dc;
}

#ifdef AVI_PHASE_CLOCKS
// The instrumented build (chip_smoke.py phase (m)): thread 0 adds the SM
// cycles from one phase's closing barrier to the next one's into
// avi_phase_cycles[i], i = 0 draws, 1 z, |u|^2 and log det, 2 the model,
// 3 the whitening, 4 g_z, the rule pass and the ELBO.  The kernel without
// the macro is untouched.
__device__ unsigned long long avi_phase_cycles[5];
#define AVI_PHASE(i)                                                                 \
  do {                                                                               \
    if (tid == 0) {                                                                  \
      const long long t_now = clock64();                                             \
      atomicAdd(&avi_phase_cycles[i], static_cast<unsigned long long>(t_now - t_prev)); \
      t_prev = t_now;                                                                \
    }                                                                                \
  } while (0)
#else
#define AVI_PHASE(i) \
  do {               \
  } while (0)
#endif

// One block per SM by nature.  Capped at 88 registers a thread: left free
// to take the 128 a 512-thread block allows, ptxas took them all and the
// default branch ran 2-3% slower than at 88, the lowest cap without
// spills (H100 measurements at d = 62 and d = 512).
__global__ void __maxnreg__(88) fused_advi_fullrank_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1,
    int n_data, int db, int batch, float s0, float s1, const float* __restrict__ vec_in,
    const float* __restrict__ mat_in, float* __restrict__ vec_out, float* mat_out,
    float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, float* inv_dev, int n, int d, int k, int steps,
    int log_every, uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h,
    avi::Branch br, Placement at) {
#ifdef AVI_AD_BODY
  model = avi::kAD;  // every other model's code drops out of this library
#endif
  extern __shared__ float smem[];
  const Layout L = make_layout(model, n_data, db, batch, n, d, k, at.mat, at.inv);
  const bool mat_in_smem = at.mat;
  const bool logreg = model == avi::kLogReg;
  const bool minibatch = avi::is_minibatch(model);
  float* us = smem + L.u;
  float* zs = smem + L.z;
  float* gs = smem + L.g;
  float* ws = smem + L.w;
  float* mu = smem + L.vec;
  float* m_mu = mu + d;
  float* v_mu = mu + 2 * d;
  float* a_mu = mu + 3 * d;
  float* ext_mu = mu + 4 * d;  // COCOB: G, reward, theta of mu
  float* dm = smem + L.dm;
  float* beta_sq = smem + L.row;
  float* tcol = beta_sq + n;
  float* inv_sig2 = tcol + n;
  float* logpi = inv_sig2 + n;
  float* u2 = logpi + n;
  float* ylogit = u2 + n;
  float* logdet = ylogit + n;
  float* red = smem + L.red;
  float* eta_s = red + 2 * kWarps;
  const size_t dd = static_cast<size_t>(d) * d;
  float* sig = mat_in_smem ? smem + L.mat : mat_out;  // smem or device memory
  float* m_sig = sig + dd;
  float* v_sig = sig + 2 * dd;
  float* a_sig = sig + 3 * dd;
  float* ext_sig = sig + 4 * dd;  // COCOB: G, reward, theta of the scale
  float* inv = at.inv ? smem + L.inv : inv_dev;   // the panel operators M_p
  // no aligned beta copy here: the logreg products below read z and the logits' rows
  const avi::LogReg lrm{smem + L.X, smem + L.y, smem + L.l, nullptr, n_data, db, n_data, 0,
                        s0, s1};
  avi::LogRegMB mbm{nullptr, smem + L.y, smem + L.l, nullptr, batch, db, 0, s0, s1};
  const int nb = minibatch ? n_data / batch : 1;
  const float* mean = c0;  // mvnormal: mean (d,) and precision (d, d)
  const float* prec = c1;  // gaussian: mean (d,) and inverse variances (d,)
  const float lognorm = s0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (logreg) {
    for (int i = tid; i < n_data * db; i += kThreads) smem[L.X + i] = c0[i];
    for (int i = tid; i < n_data; i += kThreads) smem[L.y + i] = c1[i];
  }
  for (int i = tid; i < k * d; i += kThreads) mu[i] = vec_in[i];
  for (size_t i = tid; i < k * dd; i += kThreads) sig[i] = mat_in[i];
#ifdef AVI_AD_BODY
  if (model == avi::kAD) avi::ad::ad_stage(c0, smem + L.adc, tid);
#endif
  __syncthreads();

  const bool cf_zero = br.entropy == avi::kClosedFormZero;
  const bool stl_zero = br.entropy == avi::kSTLZero;
  const bool dist_rule = br.algo == avi::kDoWG || br.algo == avi::kDoG;
  const bool cocob = br.algo == avi::kCOCOB;
  const float inv_n = 1.0f / static_cast<float>(n);
  const float ln_b1 = logf(h.b1);
  const float ln_b2 = logf(h.b2);
  const float ent_const = 0.5f * static_cast<float>(d) * kLog2Pi;
  const float ent_closed = 0.5f * static_cast<float>(d) * (1.0f + kLog2Pi);
  const int groups = (d + 3) / 4;
  const int nd = n * d;
  float elbo = 0.0f;
#ifdef AVI_PHASE_CLOCKS
  long long t_prev = clock64();
#endif

  for (int s = 0; s < steps; ++s) {
    const unsigned long long it = it0 + static_cast<unsigned long long>(s);
    // the minibatch slab of this step starts on its way (staged transports)
    if (minibatch)
      mbm.X = avi::minibatch_step_begin(model, c0, c1, batch, db, nb, it, smem + L.X,
                                        smem + L.y, tid, kThreads);

    // A: base draws, z = m + u C^T, |u|^2 per row, log det C
    if (noise != nullptr) {
      const float* src = noise + static_cast<size_t>(s) * nd;
      for (int idx = tid; idx < nd; idx += kThreads) us[idx] = src[idx];
    } else {
      for (int pair = tid; pair < n * groups; pair += kThreads) {
        const int i = pair / groups;
        const int g = pair - i * groups;
        float w[4];
        avi::normals4(k0, k1, static_cast<uint32_t>(it), static_cast<uint32_t>(i),
                      static_cast<uint32_t>(g), w);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (4 * g + p < d) us[i * d + 4 * g + p] = w[p];
      }
    }
    __syncthreads();
    AVI_PHASE(0);
    // one warp per row a of C, its lanes along the row (coalesced), all
    // sample rows at once: C is read once a step
    for (int a = warp; a < d; a += kWarps) {
      const float* cr = sig + static_cast<size_t>(a) * d;
      for (int i0 = 0; i0 < n; i0 += kRowChunk) {
        float acc[kRowChunk];
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
        for (int b = lane; b <= a; b += 32) {
          const float cv = cr[b];
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r)
            if (i0 + r < n) acc[r] = fmaf(us[(i0 + r) * d + b], cv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) {
          const float v = avi::warp_sum(acc[r]);
          if (lane == 0 && i0 + r < n) zs[(i0 + r) * d + a] = __fadd_rn(v, mu[a]);
        }
      }
    }
    for (int i = warp; i < n; i += kWarps) {
      float uu = 0.0f;
      for (int j = lane; j < d; j += 32) {
        const float v = us[i * d + j];
        uu += v * v;
      }
      uu = avi::warp_sum(uu);
      if (lane == 0) u2[i] = uu;
    }
    if (warp == kWarps - 1) {  // log det of the pre-update scale
      float ld = 0.0f;
      for (int j = lane; j < d; j += 32) ld += logf(sig[static_cast<size_t>(j) * d + j]);
      ld = avi::warp_sum(ld);
      if (lane == 0) *logdet = ld;
    }
    __syncthreads();
    AVI_PHASE(1);

    // B: log pi and its gradient
    if (logreg) {
      avi::logreg_rows(lrm, zs, n, d, beta_sq, tcol, inv_sig2, warp, kWarps, lane);
      __syncthreads();
      // one output a thread, k in order: block_mm spilled under the 88-register cap
      avi::logreg_logits_each(lrm, zs, n, d, tid, kThreads);
      __syncthreads();
      avi::logreg_logpi(lrm, n, beta_sq, tcol, inv_sig2, logpi, warp, kWarps, lane);
      __syncthreads();
      avi::logreg_grad_each(lrm, zs, n, d, beta_sq, tcol, inv_sig2, gs, tid, kThreads);
    } else if (minibatch) {
      avi::logreg_mb_rows(mbm, zs, n, d, beta_sq, tcol, inv_sig2, ylogit, warp, kWarps, lane);
      if (avi::slab_staged(model)) avi::cp_async_wait_all();  // this thread's copies landed
      __syncthreads();
      // one output a thread, k in order: block_mm spilled under the 88-register cap
      avi::logreg_mb_logits_each(mbm, zs, n, d, tid, kThreads);
      __syncthreads();
      avi::logreg_mb_logpi(mbm, n, beta_sq, tcol, inv_sig2, ylogit, logpi, warp, kWarps, lane);
      __syncthreads();
      avi::logreg_mb_grad_each(mbm, zs, n, d, beta_sq, tcol, inv_sig2, gs, tid, kThreads);
    } else if (model == avi::kGaussian) {
      avi::gaussian_body(mean, prec, lognorm, zs, n, d, logpi, gs, warp, kWarps, lane);
#ifdef AVI_AD_BODY
    } else if (model == avi::kAD) {  // K5: log pi and its gradient
      long long t_logpi = 0;  // the body's mark after log pi (unused here)
      avi::ad::ad_body(c0, reinterpret_cast<const int*>(c1), smem + L.adc, zs, n, d, logpi, gs,
                       smem + L.ad, tid, &t_logpi);
#endif
    } else {
      for (int idx = tid; idx < nd; idx += kThreads) ws[idx] = zs[idx] - mean[idx % d];
      __syncthreads();
      // one thread per column a of P (coalesced), all sample rows at once:
      // P is read once a step
      for (int a = tid; a < d; a += kThreads) {
        for (int i0 = 0; i0 < n; i0 += kRowChunk) {
          float acc[kRowChunk];
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
#pragma unroll 4
          for (int b = 0; b < d; ++b) {
            const float pv = prec[static_cast<size_t>(b) * d + a];
#pragma unroll
            for (int r = 0; r < kRowChunk; ++r)
              if (i0 + r < n) acc[r] = fmaf(ws[(i0 + r) * d + b], pv, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r)
            if (i0 + r < n) gs[(i0 + r) * d + a] = -acc[r];
        }
      }
      __syncthreads();
      for (int i = warp; i < n; i += kWarps) {
        float q = 0.0f;
        for (int j = lane; j < d; j += 32) q += ws[i * d + j] * gs[i * d + j];
        q = avi::warp_sum(q);
        if (lane == 0) logpi[i] = 0.5f * q + lognorm;
      }
    }
    __syncthreads();
    AVI_PHASE(2);

    // C: whitening w = C^{-T} u, in row form W = U C^{-1} (K8's mode C)
    if (!cf_zero) {
      for (int idx = tid; idx < nd; idx += kThreads) ws[idx] = us[idx];
      __syncthreads();
      avi::solve_right_rows(sig, d, ws, n, inv);
    }
    AVI_PHASE(3);

    // D: g_z, dmu, then (DoWG, DoG) the global sums before any entry moves
    for (int idx = tid; idx < nd; idx += kThreads)
      gs[idx] = -inv_n * (cf_zero ? gs[idx] : gs[idx] + ws[idx]);
    __syncthreads();
    float part_g = 0.0f, part_x = 0.0f;
    for (int a = tid; a < d; a += kThreads) {
      float dmu = 0.0f;
      for (int i = 0; i < n; ++i) dmu += gs[i * d + a];
      dm[a] = dmu;
      if (dist_rule) {
        const float xm = mu[a] - m_mu[a];
        part_g += dmu * dmu;
        part_x += xm * xm;
      }
    }
    if (dist_rule) {
      for (int a = warp; a < d; a += kWarps)
        for (int b = lane; b <= a; b += 32) {
          const size_t e = static_cast<size_t>(a) * d + b;
          float dc = lower_grad(gs, us, n, d, a, b);
          if (stl_zero && a == b) dc += 1.0f / sig[e];
          const float xs = sig[e] - m_sig[e];
          part_g += dc * dc;
          part_x += xs * xs;
        }
      const float2 tot = avi::block_sum2(part_g, part_x, red, kWarps);
      if (tid == 0) *eta_s = avi::distance_rule_step(br.algo, tot.x, tot.y, v_mu[0], v_mu[1]);
      __syncthreads();
    }  // the other rules need no barrier: a thread reads back its own dm[a]

    // D: the rule, the operator on the diagonal and the averaging
    const float c = static_cast<float>(it) + 1.0f;
    const float bc1 = 1.0f - expf(c * ln_b1);
    const float bc2 = 1.0f - expf(c * ln_b2);
    const float w = (h.avg_eta + 1.0f) / (c + h.avg_eta);
    const float eta = br.algo == avi::kDescent ? h.lr : (dist_rule ? *eta_s : 0.0f);
    for (int a = tid; a < d; a += kThreads) {
      float G = 0.0f, R = 0.0f, T = 0.0f;
      if (cocob) {
        G = ext_mu[a];
        R = ext_mu[d + a];
        T = ext_mu[2 * d + a];
      }
      avi::rule_step(br, h, eta, bc1, bc2, mu[a], m_mu[a], v_mu[a], G, R, T, dm[a]);
      if (cocob) {
        ext_mu[a] = G;
        ext_mu[d + a] = R;
        ext_mu[2 * d + a] = T;
      }
      if (dist_rule && a >= 2) v_mu[a] = 0.0f;  // v_mu holds [v, r, 0, ...]
      a_mu[a] = (1.0f - w) * a_mu[a] + w * mu[a];
    }
    for (int a = warp; a < d; a += kWarps) {  // the lower triangle, row by row
      for (int b = lane; b <= a; b += 32) {
        const size_t e = static_cast<size_t>(a) * d + b;
        float dc = lower_grad(gs, us, n, d, a, b);
        if (stl_zero && a == b) dc += 1.0f / sig[e];  // the pre-update diagonal
        float x = sig[e], m = m_sig[e], v = v_sig[e];
        float G = 0.0f, R = 0.0f, T = 0.0f;
        if (cocob) {
          G = ext_sig[e];
          R = ext_sig[dd + e];
          T = ext_sig[2 * dd + e];
        }
        avi::rule_step(br, h, eta, bc1, bc2, x, m, v, G, R, T, dc);
        if (cocob) {
          ext_sig[e] = G;
          ext_sig[dd + e] = R;
          ext_sig[2 * dd + e] = T;
        }
        if (a == b) x = avi::scale_operator(br.op, x, eta, h);
        sig[e] = x;
        m_sig[e] = m;
        v_sig[e] = v;
        a_sig[e] = (1.0f - w) * a_sig[e] + w * x;
      }
    }

    // E: the step's ELBO estimate, energy + entropy value
    if (tid == 0) {
      float energy = 0.0f, uu = 0.0f;
      for (int i = 0; i < n; ++i) {
        energy += logpi[i];
        uu += u2[i];
      }
      elbo = inv_n * energy +
             (cf_zero ? *logdet + ent_closed : *logdet + inv_n * (0.5f * uu) + ent_const);
      if (log_every > 0 && (s + 1) % log_every == 0) trace[(s + 1) / log_every - 1] = elbo;
    }
    __syncthreads();
    AVI_PHASE(4);
  }

  for (int i = tid; i < k * d; i += kThreads) vec_out[i] = mu[i];
  if (mat_in_smem)
    for (size_t i = tid; i < k * dd; i += kThreads) mat_out[i] = sig[i];
  if (tid == 0) *elbo_out = elbo;
}

}  // namespace

// The dynamic shared memory a launch uses: with the k scale matrices and
// the whitening's panel operators in shared memory where they fit (place),
// without them otherwise; k is 4, or 7 with COCOB.
extern "C" size_t fused_advi_fullrank_smem_bytes(int model, int n_data, int db, int batch,
                                                 int n, int d, int k) {
  const Placement at = place(model, n_data, db, batch, n, d, k);
  return sizeof(float) * static_cast<size_t>(
                             make_layout(model, n_data, db, batch, n, d, k, at.mat, at.inv).total);
}

#ifdef AVI_PHASE_CLOCKS
// Copies the instrumented build's avi_phase_cycles (5 counters) to host
// memory `out` after the work queued so far, then zeroes them.  Returns the
// first CUDA error (0 on success).
extern "C" int fused_advi_fullrank_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, avi_phase_cycles, sizeof(avi_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(avi_phase_cycles, zero, sizeof(zero)));
}
#endif

// model 0: logreg, c0 = X (n_data, db), c1 = y (n_data,), s0 = likeadj,
// s1 = prior_scale, d = db + 1; model 1: mvnormal, c0 = mean (d,), c1 =
// precision (d, d), s0 = lognorm; model 2: diagonal Gaussian, c0 = mean
// (d,), c1 = inverse variances (d,), s0 = lognorm; models 3-5: minibatch
// logreg (in place, staged, staged + prefetch), c0 = permuted X (n_data,
// db) with n_data a multiple of batch and 16-byte aligned, c1 = yX (n_data
// / batch, db), s0 = likeadj = full n / batch, s1 = prior_scale.  vec_in/out: (k, d)
// float32 rows mu m_mu v_mu avg_mu; mat_in/out: (k, d, d) sig m_sig v_sig
// avg_sig; with COCOB (k = 7) each is followed by its G, reward and theta
// (only lower triangles are updated; the upper ones are copied through).
// elbo_out: one float; trace: (steps / log_every,) or null when
// log_every == 0; noise: (steps, n, d) or null for in-kernel Philox;
// inv_scratch: tri_panels(d) x 32 x 32 floats of device memory for the
// whitening's panel operators, used when they do not fit in shared memory.  algo,
// entropy, grad_est, op: the avi::Branch codes (grad_est must be the
// reparameterization gradient).  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a launch the kernel
// does not take.  Model 6 (a library built with AVI_AD_BODY): K5's
// generated body at its (n, d), c0 = packed float constants, c1 = packed
// int32 constants.
extern "C" int fused_advi_fullrank(
    int model, const float* c0, const float* c1, int n_data, int db, int batch, float s0,
    float s1, const float* vec_in, const float* mat_in, float* vec_out,
    float* mat_out, float* elbo_out, float* trace, const float* noise, float* inv_scratch,
    int n, int d,
    int steps, int log_every, uint32_t seed0, uint32_t seed1, unsigned long long it0,
    float lr, float b1, float b2, float eps, float avg_eta, float clip_eps, int algo,
    int entropy, int grad_est, int op, float cocob_alpha, cudaStream_t stream) {
  const int k = algo == avi::kCOCOB ? 7 : 4;
  const bool dist_rule = algo == avi::kDoWG || algo == avi::kDoG;
  const bool mb = avi::is_minibatch(model);
#ifdef AVI_AD_BODY  // K5's body is generated for one (n, d), and runs alone
  if (model != avi::kAD || n != avi::ad::kN || d != avi::ad::kD)
    return static_cast<int>(cudaErrorInvalidValue);
#else
  if (model == avi::kAD) return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (grad_est != avi::kRepGrad || (dist_rule && d < 2) ||
      (mb && (batch < 1 || batch % 8 != 0 || n_data % batch != 0 || n_data < batch ||
              reinterpret_cast<uintptr_t>(c0) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Placement at = place(model, n_data, db, batch, n, d, k);
  const size_t smem = fused_advi_fullrank_smem_bytes(model, n_data, db, batch, n, d, k);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB only after this call; without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(fused_advi_fullrank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  const avi::Branch br{algo, entropy, grad_est, op, cocob_alpha};
  fused_advi_fullrank_kernel<<<1, kThreads, smem, stream>>>(
      model, c0, c1, n_data, db, batch, s0, s1, vec_in, mat_in, vec_out, mat_out, elbo_out,
      trace, noise, inv_scratch, n, d, k, steps, log_every, seed0, seed1, it0, h, br, at);
  return static_cast<int>(cudaGetLastError());
}
