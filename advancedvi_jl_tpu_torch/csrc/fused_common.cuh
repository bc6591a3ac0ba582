// Pieces shared by the fused whole-loop kernels (fused_advi_meanfield.cu,
// fused_advi_fullrank.cu): the hyperparameters, a warp sum, the Adam update
// and the hierarchical logistic regression body.
//
// The logreg body replaces ops/pallas/fused_advi.py::_logreg_step_factory.
// It works on one block's shared-memory arrays: samples z (n, d) with
// d = db + 1 (beta in lanes 0..db-1, t = log sigma in lane db), the design
// X (n_data, db) and labels y, and fills per-row beta_sq, t, e^{-2t}, log pi
// and grad log pi (n, d).  Each phase is a loop over the block's threads;
// the caller puts a __syncthreads() between phases.  Every sum runs in a
// fixed order (sequential loops and warp butterflies), so a launch is
// deterministic.
#pragma once

#include <cuda_runtime.h>

namespace avi {

constexpr float kLog2Pi = 1.8378770664093453f;  // log(2 pi) in float32

struct Hyper {
  float lr, b1, b2, eps, avg_eta, clip_eps;
};

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same, order-fixed sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// optax scale_by_adam followed by scale(-lr), as _adam_candidate; 1 - b is
// formed in float32 from the float32 b, as the JAX fused kernel does.
__device__ __forceinline__ void adam_step(float& x, float& m, float& v, float g,
                                          const Hyper& h, float bc1, float bc2) {
  m = h.b1 * m + (1.0f - h.b1) * g;
  v = h.b2 * v + (1.0f - h.b2) * g * g;
  x = x + -h.lr * (m / bc1) / (sqrtf(v / bc2) + h.eps);
}

struct LogReg {
  const float* X;  // (n_data, db) shared
  const float* y;  // (n_data,) shared
  float* l;        // (n, n_data) shared: logits, then likelihood weights
  int n_data, db;
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

// Logits l = beta X^T, one thread per (row, datum).
__device__ __forceinline__ void logreg_logits(const LogReg& m, const float* z, int n,
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
      const float l = m.l[i * m.n_data + k];
      const float p = 1.0f / (1.0f + expf(-l));
      const float sp = fmaxf(l, 0.0f) + log1pf(expf(-fabsf(l)));
      ll += m.y[k] * l - sp;
      m.l[i * m.n_data + k] = m.likeadj * (m.y[k] - p);
    }
    ll = warp_sum(ll);
    if (lane == 0) {
      const float t = tcol[i];
      logpi[i] = m.likeadj * ll - 0.5f * beta_sq[i] * inv_sig2[i] - fdb * t -
                 t * t / (2.0f * s2) - log_s - norm_const;
    }
  }
}

// grad log pi (one thread per (row, lane)): X^T weights - beta e^{-2t}, and
// |beta|^2 e^{-2t} - db - t / s^2 for the log-sigma lane.
__device__ __forceinline__ void logreg_grad(const LogReg& m, const float* z, int n,
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

}  // namespace avi
