// K1+K2: the whole ADVI loop in one launch, mean-field x STL x Adam x
// ClipScale x polynomial averaging on hierarchical logistic regression.
//
// Replaces ops/pallas/fused_advi.py::_run_chunk (both pallas_calls, plain and
// traced grid) in its MEANFIELD x REPGRAD x STL x ADAM x CLIP branch of
// _kernel, with _logreg_step_factory inlined as the model, _adam_candidate as
// the update and the step-indexed draw of location_scale_kernels.py.  The
// plain PyTorch version is fused_run_chunk_reference in ops/cuda/fused_advi.py.
//
// What bounds it on an H100: latency.  Steps are sequential, and one step at
// the flagship width (n = 10 samples, 208 x 61 design, d = 62) is about
// 2 x 10 x 208 x 61 = 254k multiply-adds, a few microseconds of one SM, with
// five block-wide barriers between its phases.  No step touches device memory
// except to read injected noise or write a trace entry.
//
// Design: one thread block runs the whole chunk with a loop over steps inside
// the block; this takes the place of the TPU's fori_loop and of the traced
// mode's sequential grid, which existed only to keep Mosaic from compiling a
// dynamic store per step.  Here the ELBO of every log_every-th step is stored
// straight into trace[k], so one kernel serves both modes.  The design matrix
// (50,752 bytes at the flagship shape, over the 48 KB static limit), the
// labels, the draws, the logits and the eight (d,) state rows live in dynamic
// shared memory for the whole chunk.  Each step:
//
//   A  draw u (Philox keyed by the global iteration, or a row of the injected
//      noise) and z = mu + sig * u; one warp per row sums |beta|^2 and |u|^2;
//   B  logits l = beta X^T (one thread per (row, datum)), then one warp per
//      row forms likeadj (y - sigmoid(l)), the softplus log-likelihood and
//      log pi with the Exp log-det folded in (fused_advi.py:43-51);
//   C  grad log pi (one thread per (row, lane)): X^T weights - beta e^{-2t},
//      and |beta|^2 e^{-2t} - db - t / s^2 for the log-sigma lane;
//   D  one thread per lane: g_z = -(1/n)(grad + u / sig), dmu = sum g_z,
//      dsig = sum g_z u, Adam with bc = 1 - exp(c ln b), c = it + 1,
//      ClipScale max(sig, eps), averaging with w = (eta + 1) / (c + eta);
//   E  thread 0: the STL ELBO estimate at the pre-update parameters.
//
// Every sum runs in a fixed order (sequential loops and warp butterflies, no
// atomics), so a launch is deterministic: run_chunk(a + b) equals run_chunk(a)
// then run_chunk(b) bit for bit.  The block uses one of the 132 SMs by nature;
// spreading a step over several SMs is later work.
#include "fused_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
using avi::kLog2Pi;

// Offsets (in floats) of the shared-memory arrays.
struct Layout {
  int X, y, u, z, g, l, st, row, total;
};

__host__ __device__ inline Layout make_layout(int n_data, int db, int n, int d) {
  Layout L;
  int o = 0;
  L.X = o;   o += n_data * db;  // design matrix, row-major (n_data, db)
  L.y = o;   o += n_data;       // labels
  L.u = o;   o += n * d;        // base draws
  L.z = o;   o += n * d;        // samples
  L.g = o;   o += n * d;        // grad log pi
  L.l = o;   o += n * n_data;   // logits, then likelihood weights
  L.st = o;  o += 8 * d;        // mu sig m_mu v_mu m_sig v_sig avg_mu avg_sig
  L.row = o; o += 5 * n + 1;    // beta_sq t inv_sig2 logpi u2 (per row), logdet
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads) fused_advi_meanfield_kernel(
    const float* __restrict__ X, const float* __restrict__ y, int n_data,
    int db, const float* __restrict__ state_in, float* __restrict__ state_out,
    float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int steps, int log_every,
    uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h,
    float likeadj, float prior_scale) {
  extern __shared__ float smem[];
  const Layout L = make_layout(n_data, db, n, d);
  float* Xs = smem + L.X;
  float* ys = smem + L.y;
  float* us = smem + L.u;
  float* zs = smem + L.z;
  float* gs = smem + L.g;
  float* st = smem + L.st;
  float* mu = st;
  float* sig = st + d;
  float* m_mu = st + 2 * d;
  float* v_mu = st + 3 * d;
  float* m_sig = st + 4 * d;
  float* v_sig = st + 5 * d;
  float* a_mu = st + 6 * d;
  float* a_sig = st + 7 * d;
  float* beta_sq = smem + L.row;
  float* tcol = beta_sq + n;
  float* inv_sig2 = tcol + n;
  float* logpi = inv_sig2 + n;
  float* u2 = logpi + n;
  float* logdet = u2 + n;
  const avi::LogReg model{Xs, ys, smem + L.l, n_data, db, likeadj, prior_scale};

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < n_data * db; i += kThreads) Xs[i] = X[i];
  for (int i = tid; i < n_data; i += kThreads) ys[i] = y[i];
  for (int i = tid; i < 8 * d; i += kThreads) st[i] = state_in[i];
  __syncthreads();

  const float inv_n = 1.0f / static_cast<float>(n);
  const float ln_b1 = logf(h.b1);
  const float ln_b2 = logf(h.b2);
  const float ent_const = 0.5f * static_cast<float>(d) * kLog2Pi;
  const int groups = (d + 3) / 4;
  float elbo = 0.0f;

  for (int s = 0; s < steps; ++s) {
    const unsigned long long it = it0 + static_cast<unsigned long long>(s);

    // A: base draws and z = mu + sig * u (two roundings, as the plain version)
    if (noise != nullptr) {
      const float* src = noise + static_cast<size_t>(s) * n * d;
      for (int idx = tid; idx < n * d; idx += kThreads) {
        const int j = idx % d;
        const float uv = src[idx];
        us[idx] = uv;
        zs[idx] = __fadd_rn(mu[j], __fmul_rn(sig[j], uv));
      }
    } else {
      for (int pair = tid; pair < n * groups; pair += kThreads) {
        const int i = pair / groups;
        const int g = pair - i * groups;
        float w[4];
        avi::normals4(k0, k1, static_cast<uint32_t>(it),
                      static_cast<uint32_t>(i), static_cast<uint32_t>(g), w);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int j = 4 * g + p;
          if (j < d) {
            us[i * d + j] = w[p];
            zs[i * d + j] = __fadd_rn(mu[j], __fmul_rn(sig[j], w[p]));
          }
        }
      }
    }
    __syncthreads();
    avi::logreg_rows(model, zs, n, d, beta_sq, tcol, inv_sig2, warp, kWarps, lane);
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
      for (int j = lane; j < d; j += 32) ld += logf(sig[j]);
      ld = avi::warp_sum(ld);
      if (lane == 0) *logdet = ld;
    }
    __syncthreads();

    // B: logits, then likelihood weights and log pi per row
    avi::logreg_logits(model, zs, n, d, tid, kThreads);
    __syncthreads();
    avi::logreg_logpi(model, n, beta_sq, tcol, inv_sig2, logpi, warp, kWarps, lane);
    __syncthreads();

    // C: grad log pi
    avi::logreg_grad(model, zs, n, d, beta_sq, tcol, inv_sig2, gs, tid, kThreads);
    __syncthreads();

    // D: STL gradient, Adam, ClipScale, polynomial averaging
    const float c = static_cast<float>(it) + 1.0f;
    const float bc1 = 1.0f - expf(c * ln_b1);
    const float bc2 = 1.0f - expf(c * ln_b2);
    const float w = (h.avg_eta + 1.0f) / (c + h.avg_eta);
    for (int j = tid; j < d; j += kThreads) {
      const float sj = sig[j];
      float dmu = 0.0f, dsig = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float uij = us[i * d + j];
        const float gz = -inv_n * (gs[i * d + j] + uij / sj);
        dmu += gz;
        dsig += gz * uij;
      }
      avi::adam_step(mu[j], m_mu[j], v_mu[j], dmu, h, bc1, bc2);
      avi::adam_step(sig[j], m_sig[j], v_sig[j], dsig, h, bc1, bc2);
      sig[j] = fmaxf(sig[j], h.clip_eps);
      a_mu[j] = (1.0f - w) * a_mu[j] + w * mu[j];
      a_sig[j] = (1.0f - w) * a_sig[j] + w * sig[j];
    }

    // E: the step's ELBO estimate, energy + STL entropy value
    if (tid == 0) {
      float energy = 0.0f, uu = 0.0f;
      for (int i = 0; i < n; ++i) {
        energy += logpi[i];
        uu += u2[i];
      }
      elbo = inv_n * energy + (*logdet + inv_n * (0.5f * uu) + ent_const);
      if (log_every > 0 && (s + 1) % log_every == 0)
        trace[(s + 1) / log_every - 1] = elbo;
    }
    __syncthreads();
  }

  for (int i = tid; i < 8 * d; i += kThreads) state_out[i] = st[i];
  if (tid == 0) *elbo_out = elbo;
}

}  // namespace

extern "C" size_t fused_advi_meanfield_smem_bytes(int n_data, int db, int n,
                                                  int d) {
  return sizeof(float) * static_cast<size_t>(make_layout(n_data, db, n, d).total);
}

// X: (n_data, db) and y: (n_data,) float32; state_in, state_out: (8, d)
// float32 rows mu sig m_mu v_mu m_sig v_sig avg_mu avg_sig, d = db + 1;
// elbo_out: one float; trace: (steps / log_every,) float or null when
// log_every == 0; noise: (steps, n, d) float32 or null for in-kernel Philox.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_advi_meanfield(
    const float* X, const float* y, int n_data, int db, const float* state_in,
    float* state_out, float* elbo_out, float* trace, const float* noise, int n,
    int d, int steps, int log_every, uint32_t seed0, uint32_t seed1,
    unsigned long long it0, float lr, float b1, float b2, float eps,
    float avg_eta, float clip_eps, float likeadj, float prior_scale,
    cudaStream_t stream) {
  const size_t smem = fused_advi_meanfield_smem_bytes(n_data, db, n, d);
  // above 48 KB only after this call; without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      fused_advi_meanfield_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  fused_advi_meanfield_kernel<<<1, kThreads, smem, stream>>>(
      X, y, n_data, db, state_in, state_out, elbo_out, trace, noise, n, d,
      steps, log_every, seed0, seed1, it0, h, likeadj, prior_scale);
  return static_cast<int>(cudaGetLastError());
}
