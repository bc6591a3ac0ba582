// K3 (full-rank branch) with K4's dense-Gaussian body: the whole ADVI loop in
// one launch, full-rank Gaussian family x STL x Adam x ClipScale (diagonal)
// x polynomial averaging, on hierarchical logistic regression or a dense
// Gaussian target N(m, P^{-1}).
//
// Replaces ops/pallas/fused_advi.py::_run_chunk (both pallas_calls, plain and
// traced grid) in the FULLRANK x REPGRAD x STL x ADAM x CLIP branch of
// _kernel (fused_advi.py:441-447, 480-485, 518-534, 544-553, 609-615,
// 631-634), with _backsub_ct / _backsub_ct_blocked as the whitening and
// _logreg_step_factory or _mvnormal_step_factory as the model.  The plain
// PyTorch version is fused_fullrank_run_chunk_reference in
// ops/cuda/fused_advi.py.
//
// What bounds it on an H100: latency, as in the mean-field kernel: steps are
// sequential.  A step at d = 62 (logreg, n = 10) is the mean-field step's
// 254k multiply-adds plus a 62-long back-substitution per sample row and an
// Adam pass over 1,953 lower-triangle entries.  At d = 512 (mvnormal) it is
// 2.6M multiply-adds for the gradient (P is 1 MB), 1.3M for z = m + u C^T,
// a 512-long substitution per row, and an Adam pass that reads and writes
// four 131k-entry lower triangles (sig, its two moments, its average):
// about 5 MB of L2 traffic a step through one SM, whose 16 warps cannot
// hide the L2 latency, plus 16 panels of the substitution chain.  Measured
// on an H100, the wide step is bound by that latency, not by FMAs or bytes
// (about 0.7 ms a step; the d = 62 step about 35 us).
//
// Design: one thread block runs the whole chunk, a loop over steps inside
// the block.  The draws u, the samples z, grad log pi and the whitened
// draws w (n x d each), the location rows and, for logreg, X, y and the
// logits live in dynamic shared memory.  The four (d, d) scale matrices
// live in shared memory when everything fits in one block's 227 KB (d = 62:
// 61.5 KB of them), and otherwise in the output buffer in device memory,
// where they stay resident in the 50 MB L2 (d = 512: 4 MB); one code path
// serves both through a generic pointer.  A cooperative grid over all SMs
// would spread the wide step's Adam pass and products, at the price of four
// grid-wide barriers a step; it is left for a later change, with this
// kernel's times as its baseline.  Each step:
//
//   A  draw u (Philox keyed by the global iteration, or injected noise);
//      z = m + u C^T over the lower triangle (one warp per row of C, all
//      sample rows at once, so C is read once and coalesced); |u|^2 per
//      row and log det C = sum log C[j, j];
//   B  the model: logreg (fused_common.cuh) or the dense Gaussian,
//      grad = -(z - m) P (one thread per column of P, all sample rows at
//      once) and log pi = (z - m) . grad / 2 + lognorm;
//   C  whitening w = C^{-T} u: the rows of U C^{-1}, solved by the
//      triangular solve's panel substitution (trisolve_rows.cuh, K8's mode
//      C), one warp per sample row on each 32-column panel;
//   D  g_z = -(1/n)(grad + w); dmu = sum g_z; for each lower entry (a, b)
//      (one warp per row, coalesced) dC = sum_i g_z[i, a] u[i, b] formed
//      where it is used, Adam, the clip of the diagonal and the averaging
//      in the same pass: no d^2
//      temporaries, and the strict upper triangle is never touched (its
//      gradient is zero, so its moments stay zero, as in the reference);
//   E  thread 0: the STL ELBO estimate at the pre-update parameters.
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
constexpr int kLogReg = 0;  // model codes: 0 logreg, 1 mvnormal
constexpr int kRowChunk = 16;  // sample rows a thread accumulates at once
using avi::kLog2Pi;

// Offsets (in floats) of the shared-memory arrays.
struct Layout {
  int X, y, l, u, z, g, w, vec, row, tri, mat, total;
};

__host__ __device__ inline Layout make_layout(int model, int n_data, int db, int n,
                                              int d, bool mat_in_smem) {
  Layout L;
  int o = 0;
  const bool lr = model == kLogReg;
  L.X = o;   o += lr ? n_data * db : 0;  // design matrix (n_data, db)
  L.y = o;   o += lr ? n_data : 0;       // labels
  L.l = o;   o += lr ? n * n_data : 0;   // logits, then likelihood weights
  L.u = o;   o += n * d;                 // base draws
  L.z = o;   o += n * d;                 // samples
  L.g = o;   o += n * d;                 // grad log pi, then g_z
  L.w = o;   o += n * d;                 // (z - m) for mvnormal, then C^{-T} u
  L.vec = o; o += 4 * d;                 // mu m_mu v_mu avg_mu
  L.row = o; o += 5 * n + 1;             // beta_sq t inv_sig2 logpi u2, logdet
  L.tri = o; o += avi::kTriScratch;      // the whitening's panel scratch
  L.mat = o; o += mat_in_smem ? 4 * d * d : 0;  // sig m_sig v_sig avg_sig
  L.total = o;
  return L;
}

inline bool mat_fits(int model, int n_data, int db, int n, int d) {
  return sizeof(float) * static_cast<size_t>(
                             make_layout(model, n_data, db, n, d, true).total) <=
         kSmemLimit;
}

// one block per SM by nature: let it have up to 128 registers a thread
__global__ void __launch_bounds__(kThreads, 1) fused_advi_fullrank_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1,
    int n_data, int db, float s0, float s1, const float* __restrict__ vec_in,
    const float* __restrict__ mat_in, float* __restrict__ vec_out, float* mat_out,
    float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int steps, int log_every,
    uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h,
    bool mat_in_smem) {
  extern __shared__ float smem[];
  const Layout L = make_layout(model, n_data, db, n, d, mat_in_smem);
  const bool logreg = model == kLogReg;
  float* us = smem + L.u;
  float* zs = smem + L.z;
  float* gs = smem + L.g;
  float* ws = smem + L.w;
  float* mu = smem + L.vec;
  float* m_mu = mu + d;
  float* v_mu = mu + 2 * d;
  float* a_mu = mu + 3 * d;
  float* beta_sq = smem + L.row;
  float* tcol = beta_sq + n;
  float* inv_sig2 = tcol + n;
  float* logpi = inv_sig2 + n;
  float* u2 = logpi + n;
  float* logdet = u2 + n;
  const size_t dd = static_cast<size_t>(d) * d;
  float* sig = mat_in_smem ? smem + L.mat : mat_out;  // smem or device memory
  float* m_sig = sig + dd;
  float* v_sig = sig + 2 * dd;
  float* a_sig = sig + 3 * dd;
  const avi::LogReg lrm{smem + L.X, smem + L.y, smem + L.l, n_data, db, s0, s1};
  const float* mean = c0;  // mvnormal: mean (d,) and precision (d, d)
  const float* prec = c1;
  const float lognorm = s0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (logreg) {
    for (int i = tid; i < n_data * db; i += kThreads) smem[L.X + i] = c0[i];
    for (int i = tid; i < n_data; i += kThreads) smem[L.y + i] = c1[i];
  }
  for (int i = tid; i < 4 * d; i += kThreads) mu[i] = vec_in[i];
  for (size_t i = tid; i < 4 * dd; i += kThreads) sig[i] = mat_in[i];
  __syncthreads();

  const float inv_n = 1.0f / static_cast<float>(n);
  const float ln_b1 = logf(h.b1);
  const float ln_b2 = logf(h.b2);
  const float ent_const = 0.5f * static_cast<float>(d) * kLog2Pi;
  const int groups = (d + 3) / 4;
  const int nd = n * d;
  float elbo = 0.0f;

  for (int s = 0; s < steps; ++s) {
    const unsigned long long it = it0 + static_cast<unsigned long long>(s);

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

    // B: log pi and its gradient
    if (logreg) {
      avi::logreg_rows(lrm, zs, n, d, beta_sq, tcol, inv_sig2, warp, kWarps, lane);
      __syncthreads();
      avi::logreg_logits(lrm, zs, n, d, tid, kThreads);
      __syncthreads();
      avi::logreg_logpi(lrm, n, beta_sq, tcol, inv_sig2, logpi, warp, kWarps, lane);
      __syncthreads();
      avi::logreg_grad(lrm, zs, n, d, beta_sq, tcol, inv_sig2, gs, tid, kThreads);
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

    // C: whitening w = C^{-T} u, in row form W = U C^{-1} (K8's mode C)
    for (int idx = tid; idx < nd; idx += kThreads) ws[idx] = us[idx];
    __syncthreads();
    avi::solve_right_rows<false>(sig, d, ws, n, smem + L.tri, nullptr);

    // D: STL gradient, Adam, ClipScale on the diagonal, averaging
    for (int idx = tid; idx < nd; idx += kThreads) gs[idx] = -inv_n * (gs[idx] + ws[idx]);
    __syncthreads();
    const float c = static_cast<float>(it) + 1.0f;
    const float bc1 = 1.0f - expf(c * ln_b1);
    const float bc2 = 1.0f - expf(c * ln_b2);
    const float w = (h.avg_eta + 1.0f) / (c + h.avg_eta);
    for (int a = tid; a < d; a += kThreads) {
      float dmu = 0.0f;
      for (int i = 0; i < n; ++i) dmu += gs[i * d + a];
      avi::adam_step(mu[a], m_mu[a], v_mu[a], dmu, h, bc1, bc2);
      a_mu[a] = (1.0f - w) * a_mu[a] + w * mu[a];
    }
    for (int a = warp; a < d; a += kWarps) {  // the lower triangle, row by row
      for (int b = lane; b <= a; b += 32) {
        const size_t e = static_cast<size_t>(a) * d + b;
        float dc = 0.0f;
        for (int i = 0; i < n; ++i) dc = fmaf(gs[i * d + a], us[i * d + b], dc);
        float x = sig[e], m = m_sig[e], v = v_sig[e];
        avi::adam_step(x, m, v, dc, h, bc1, bc2);
        if (a == b) x = fmaxf(x, h.clip_eps);
        sig[e] = x;
        m_sig[e] = m;
        v_sig[e] = v;
        a_sig[e] = (1.0f - w) * a_sig[e] + w * x;
      }
    }

    // E: the step's ELBO estimate, energy + STL entropy value
    if (tid == 0) {
      float energy = 0.0f, uu = 0.0f;
      for (int i = 0; i < n; ++i) {
        energy += logpi[i];
        uu += u2[i];
      }
      elbo = inv_n * energy + (*logdet + inv_n * (0.5f * uu) + ent_const);
      if (log_every > 0 && (s + 1) % log_every == 0) trace[(s + 1) / log_every - 1] = elbo;
    }
    __syncthreads();
  }

  for (int i = tid; i < 4 * d; i += kThreads) vec_out[i] = mu[i];
  if (mat_in_smem)
    for (size_t i = tid; i < 4 * dd; i += kThreads) mat_out[i] = sig[i];
  if (tid == 0) *elbo_out = elbo;
}

}  // namespace

// The dynamic shared memory a launch uses: with the four scale matrices in
// shared memory when they fit, without them otherwise.
extern "C" size_t fused_advi_fullrank_smem_bytes(int model, int n_data, int db, int n,
                                                 int d) {
  const bool fits = mat_fits(model, n_data, db, n, d);
  return sizeof(float) *
         static_cast<size_t>(make_layout(model, n_data, db, n, d, fits).total);
}

// model 0: logreg, c0 = X (n_data, db), c1 = y (n_data,), s0 = likeadj,
// s1 = prior_scale, d = db + 1; model 1: mvnormal, c0 = mean (d,), c1 =
// precision (d, d), s0 = lognorm.  vec_in/out: (4, d) float32 rows mu m_mu
// v_mu avg_mu; mat_in/out: (4, d, d) sig m_sig v_sig avg_sig (only lower
// triangles are updated; the upper ones are copied through).  elbo_out: one
// float; trace: (steps / log_every,) or null when log_every == 0; noise:
// (steps, n, d) or null for in-kernel Philox.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_advi_fullrank(
    int model, const float* c0, const float* c1, int n_data, int db, float s0,
    float s1, const float* vec_in, const float* mat_in, float* vec_out,
    float* mat_out, float* elbo_out, float* trace, const float* noise, int n, int d,
    int steps, int log_every, uint32_t seed0, uint32_t seed1, unsigned long long it0,
    float lr, float b1, float b2, float eps, float avg_eta, float clip_eps,
    cudaStream_t stream) {
  const bool fits = mat_fits(model, n_data, db, n, d);
  const size_t smem = fused_advi_fullrank_smem_bytes(model, n_data, db, n, d);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB only after this call; without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(fused_advi_fullrank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  fused_advi_fullrank_kernel<<<1, kThreads, smem, stream>>>(
      model, c0, c1, n_data, db, s0, s1, vec_in, mat_in, vec_out, mat_out, elbo_out,
      trace, noise, n, d, steps, log_every, seed0, seed1, it0, h, fits);
  return static_cast<int>(cudaGetLastError());
}
