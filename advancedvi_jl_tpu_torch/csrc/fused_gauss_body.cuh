// K4's diagonal-Gaussian step on the H100: the kGauss group of the
// mean-field and chains kernels (fused_advi_meanfield_gauss_kernel,
// fused_chains_gauss_kernel, fused_chains_g_kernel<1, kGauss>), which run
// every launch of the diagonal Gaussian (model kGaussian).
//
// Replaces ops/pallas/fused_advi.py::_gaussian_step_factory (:1204) with the
// rest of the step (the draw, the STL or zero-gradient entropy or VarGrad,
// the rules, the operator, the averaging, the ELBO) in the mean-field and
// chains kernels; the full-rank kernels keep fused_common.cuh's
// gaussian_body.  The plain versions are fused_run_chunk_reference and
// fused_chains_run_chunk_reference (ops/cuda/fused_advi.py, fused_chains.py).
//
// What bounds it on an H100: the draws.  Column j's draws, z, gradient,
// dmu_j and dsig_j depend only on column j's mu, sigma, mean and inverse
// variance, so one pass a step does everything in registers: each thread
// owns whole 4-column groups (the unit of philox.cuh's normals4) and, for
// each sample row in order, draws its four normals (or reads the injected
// noise), forms z, diff, g = -diff iv and the STL term and adds them into
// dmu and dsig with the roundings of the body it replaced (u, z and g went
// through memory there, so every product that an add could take into an
// fma is spelled __fmul_rn).  No (n, d) array exists, so every width JAX
// takes (d <= 2,048, n <= 128) runs from shared memory with no workspace.
// A step is 388 thread instructions a lane group of four normals
// (chip_smoke.py generator_instructions): at d = 2,048, n = 10 1.99 M
// instructions, 7.8 us of one SM's issue, which bounds a one-block chunk.
//
// Only three things cross columns, each summed in a fixed order that no
// thread count, chain count or block count changes (gauss::Split, in
// fused_meanfield_body.cuh beside the group's Layout): log pi_i
// and |u_i|^2 (the ELBO and VarGrad's coefficients), log det sigma, and
// DoWG's and DoG's two global sums.  A row's sums: each group's four
// columns in order, a butterfly over the `width` lanes of its column slice
// (slice_sum), then the slices in order; log det likewise; DoWG's and DoG's
// sums: each column's terms, a butterfly over 32 columns, the 32-column
// warps in order (the single-chain kernel's order up to d = 512).  The row
// sums run only where they are read: on the chunk's last step, the traced
// steps and under VarGrad.  VarGrad redraws u in a second pass from the same
// (key, iteration, row, group) counters, or reads the noise again.
//
// The rows of a step split into R blocks where one row block leaves
// threads idle (R a rule of (n, d), split_for, never of the chains a block):
// each block's dmu and dsig go to shared memory and are added in block
// order.  With R = 1 (d > 1,024) and no cross-column sum before the rule
// (Adam, descent, COCOB under the reparameterization gradient) the thread
// that drew a column also applies its rule, and a step takes no barrier but
// where its ELBO is read; every sum of a column then runs in the order of
// the body it replaced (its rows in order from 0.0f), so its state is that
// body's, bit for bit.  G chains a block: the threads take the G chains'
// slots in turn; each chain keeps its state rows, its row blocks' partial
// gradients and its slices' partial sums, chain-major (gauss::Layout).
#pragma once

#include "fused_meanfield_body.cuh"

namespace avi {
namespace gauss {

using mf::kElbo;

// The sum over the `width` lanes of a column slice (a power of two up to
// 32, the slice's lanes aligned in the warp), a butterfly: every lane of the
// slice ends with the same, order-fixed sum.  Every lane of the warp calls it.
__device__ __forceinline__ float slice_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The rule, the operator and the averaging on column j of one chain's state
// rows `sc`, as run_chunk's phase D (the prox as K6's G-chain kernel spells
// out the fma of the single-chain kernel's compilation).
__device__ __forceinline__ void rule_column(const Branch& bc, const Hyper& hc, float eta,
                                            float bc1, float bc2, float w, float* sc, int d,
                                            int j, float dmu, float dsig) {
  const bool dist_rule = bc.algo == kDoWG || bc.algo == kDoG;
  const bool cocob = bc.algo == kCOCOB;
  float* mu = sc;
  float* sig = sc + d;
  float* m_mu = sc + 2 * d;
  float* v_mu = sc + 3 * d;
  float* m_sig = sc + 4 * d;
  float* v_sig = sc + 5 * d;
  float* a_mu = sc + 6 * d;
  float* a_sig = sc + 7 * d;
  float* ext = sc + 8 * d;  // COCOB: G, reward, theta of mu, then of sig
  float cg = 0.0f, R = 0.0f, T = 0.0f;
  if (cocob) {
    cg = ext[j];
    R = ext[d + j];
    T = ext[2 * d + j];
  }
  rule_step(bc, hc, eta, bc1, bc2, mu[j], m_mu[j], v_mu[j], cg, R, T, dmu);
  if (cocob) {
    ext[j] = cg;
    ext[d + j] = R;
    ext[2 * d + j] = T;
    cg = ext[3 * d + j];
    R = ext[4 * d + j];
    T = ext[5 * d + j];
  }
  float x = sig[j];
  rule_step(bc, hc, eta, bc1, bc2, x, m_sig[j], v_sig[j], cg, R, T, dsig);
  if (cocob) {
    ext[3 * d + j] = cg;
    ext[4 * d + j] = R;
    ext[5 * d + j] = T;
  }
  x = bc.op == kProx ? 0.5f * x + 0.5f * sqrtf(fmaf(x, x, 4.0f * eta))
                     : scale_operator(bc.op, x, eta, hc);
  sig[j] = x;
  if (dist_rule && j >= 2) v_mu[j] = 0.0f;  // v_mu holds [v, r, 0, ...]
  a_mu[j] = (1.0f - w) * a_mu[j] + w * mu[j];
  a_sig[j] = (1.0f - w) * a_sig[j] + w * x;
}

// What a pass over the slots computes: the reparameterization gradient (and
// the row sums where they are read), the row sums alone (VarGrad's first
// pass), or VarGrad's gradient from its coefficients (its second).
enum Pass { kRepGradPass = 0, kRowSumsPass = 1, kVarGradPass = 2 };

// A chunk of `steps` steps of the chains chain0 .. chain0 + gc - 1 of a
// launch of n_chains chains, G a block (chain0 = blockIdx.x G); the
// single-chain kernel is n_chains = G = 1 with its seed words k0, k1 (seeds
// null).  state (n_chains, n_rows, d), elbo (n_chains,), trace (n_chains,
// steps / log_every), noise (n_chains, steps, n, d) or null, as K6's.
// mean, iv: the (d,) mean and inverse variances; lognorm the log density's
// constant.  Every thread of the block calls it.
__device__ __forceinline__ void run_chunk(
    const float* __restrict__ mean, const float* __restrict__ iv, float lognorm,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    float* __restrict__ elbo_out, float* __restrict__ trace, const float* __restrict__ noise,
    int n_chains, int G, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* __restrict__ seeds, uint32_t k0, uint32_t k1, unsigned long long it0,
    const float* __restrict__ lrs, const int* __restrict__ rules, Hyper h, Branch br) {
  extern __shared__ float smem[];
  const Layout L = layout_for(n, d, n_rows, G);
  const Split S = L.S;
  const int chain0 = blockIdx.x * G;
  const int gc = min(G, n_chains - chain0);  // chains of this block
  const int srow = n_rows * d;               // one chain's state
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ce = tid - kElbo;  // the chain whose ELBO this thread forms, if 0 <= ce < gc
  float* st = smem + L.st;
  float* part = smem + L.part;
  float* lpp = smem + L.lpp;
  float* uup = smem + L.uup;
  float* ldp = smem + L.ldp;
  float* coef = smem + L.coef;
  float* distp = smem + L.distp;
  float* eta_s = smem + L.eta;
  float* lr_s = smem + L.lr;
  int* algo_s = reinterpret_cast<int*>(smem + L.algo);
  uint32_t* seed_s = reinterpret_cast<uint32_t*>(smem + L.seed);

  const float* st_in = state_in + static_cast<size_t>(chain0) * srow;
  for (int i = tid; i < gc * srow; i += kThreads) st[i] = st_in[i];
  for (int c = tid; c < gc; c += kThreads) {
    lr_s[c] = lrs != nullptr ? lrs[chain0 + c] : h.lr;
    algo_s[c] = rules != nullptr ? rules[chain0 + c] : br.algo;
    seed_s[2 * c] = seeds != nullptr ? seeds[2 * (chain0 + c)] : k0;
    seed_s[2 * c + 1] = seeds != nullptr ? seeds[2 * (chain0 + c) + 1] : k1;
  }
  __syncthreads();

  const bool vargrad = br.grad_est == kScoreGrad;
  const bool cf_zero = br.entropy == kClosedFormZero;
  const bool stl_zero = br.entropy == kSTLZero;
  bool any_dist = false;  // a DoWG or DoG chain in the block: their sums' barriers
  for (int c = 0; c < gc; ++c) any_dist |= algo_s[c] == kDoWG || algo_s[c] == kDoG;
  // one pass a step: the drawing thread applies its columns' rule
  const bool fused = S.R == 1 && !vargrad && !any_dist;
  const float inv_n = 1.0f / static_cast<float>(n);
  const float ln_b1 = logf(h.b1);
  const float ln_b2 = logf(h.b2);
  const float ent_const = 0.5f * static_cast<float>(d) * kLog2Pi;
  const float ent_closed = 0.5f * static_cast<float>(d) * (1.0f + kLog2Pi);
  const int P = S.R * S.lanes;  // a chain's slots
  const int slots = gc * P;
  const int dpad = 32 * L.wpc;
  float elbo = 0.0f;
#ifdef AVI_PHASE_CLOCKS
  long long t_prev = clock64();
#endif

  for (int s = 0; s < steps; ++s) {
    const unsigned long long it = it0 + static_cast<unsigned long long>(s);
    // the row sums are read on the last step, the traced ones and under VarGrad
    const bool need = vargrad || s == steps - 1 || (log_every > 0 && (s + 1) % log_every == 0);
    const float cs = static_cast<float>(it) + 1.0f;
    const float bc1 = 1.0f - expf(cs * ln_b1);
    const float bc2 = 1.0f - expf(cs * ln_b2);
    const float w = (h.avg_eta + 1.0f) / (cs + h.avg_eta);

    // Every slot (chain c, row block r, column slice k, lane l: group
    // g = k width + l) walks its block's rows in order.
    auto pass = [&](int mode) {
      const bool sums = need && mode != kVarGradPass;
      for (int base = 0; base < slots; base += kThreads) {
        const int q = base + tid;
        const bool on = q < slots;
        const int c = on ? q / P : 0;
        const int rem = q - c * P;
        const int r = rem / S.lanes;
        const int k = (rem - r * S.lanes) / S.width;
        const int l = rem - r * S.lanes - k * S.width;
        const int g = k * S.width + l;
        const bool gon = on && g < S.groups;
        float* sc = st + c * srow;
        float m4[4], s4[4], mean4[4], iv4[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int j = 4 * g + p;
          const bool ok = gon && j < d;
          m4[p] = ok ? sc[j] : 0.0f;
          s4[p] = ok ? sc[d + j] : 1.0f;
          mean4[p] = ok ? mean[j] : 0.0f;
          iv4[p] = ok ? iv[j] : 0.0f;
        }
        const uint32_t key0 = seed_s[2 * c], key1 = seed_s[2 * c + 1];
        const float* nz = noise == nullptr
                              ? nullptr
                              : noise + (static_cast<size_t>(chain0 + c) * steps + s) * n * d;
        const float* cf = coef + c * n;
        float dmu[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dsig[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int t = 0; t < S.rows; ++t) {  // uniform over the warp: the slices' butterflies
          const int i = r * S.rows + t;
          float lp = 0.0f, uu = 0.0f;
          if (gon && i < n) {
            float u4[4];
            if (nz != nullptr) {
#pragma unroll
              for (int p = 0; p < 4; ++p) u4[p] = 4 * g + p < d ? nz[i * d + 4 * g + p] : 0.0f;
            } else {
              normals4(key0, key1, static_cast<uint32_t>(it), static_cast<uint32_t>(i),
                       static_cast<uint32_t>(g), u4);
            }
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              if (4 * g + p < d) {
                const float u = u4[p];
                const float z = __fadd_rn(m4[p], __fmul_rn(s4[p], u));
                const float diff = __fsub_rn(z, mean4[p]);
                if (mode == kRepGradPass) {
                  const float gl = __fmul_rn(-diff, iv4[p]);
                  const float gz = -inv_n * (cf_zero ? gl : gl + u / s4[p]);
                  dmu[p] += gz;
                  dsig[p] += gz * u;
                } else if (mode == kVarGradPass) {
                  dmu[p] += cf[i] * (u / s4[p]);
                  dsig[p] += cf[i] * ((u * u - 1.0f) / s4[p]);
                }
                if (sums) {
                  lp = __fadd_rn(lp, __fmul_rn(__fmul_rn(diff, diff), iv4[p]));
                  uu = __fadd_rn(uu, __fmul_rn(u, u));
                }
              }
            }
          }
          if (sums) {
            lp = slice_sum(lp, S.width);
            uu = slice_sum(uu, S.width);
            if (l == 0 && on && i < n) {
              lpp[(c * n + i) * S.slices + k] = lp;
              uup[(c * n + i) * S.slices + k] = uu;
            }
          }
        }
        if (sums) {  // log det of the pre-update scale, row block 0's slots
          float ld = 0.0f;
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (gon && 4 * g + p < d) ld = __fadd_rn(ld, logf(s4[p]));
          ld = slice_sum(ld, S.width);
          if (l == 0 && on && r == 0) ldp[c * S.slices + k] = ld;
        }
        if (mode == kRowSumsPass || !gon) continue;
        if (fused) {  // R = 1: this thread's columns whole; no DoWG or DoG in the block
          Branch bc = br;
          bc.algo = algo_s[c];
          Hyper hc = h;
          hc.lr = lr_s[c];
          const float eta = bc.algo == kDescent ? hc.lr : 0.0f;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int j = 4 * g + p;
            if (j < d) {
              float ds = dsig[p];
              if (stl_zero) ds += 1.0f / s4[p];
              rule_column(bc, hc, eta, bc1, bc2, w, sc, d, j, dmu[p], ds);
            }
          }
        } else {  // row block r's sums of its columns
          float* pc = part + c * 2 * S.R * d + 2 * r * d;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int j = 4 * g + p;
            if (j < d) {
              pc[j] = dmu[p];
              pc[d + j] = dsig[p];
            }
          }
        }
      }
    };

    pass(vargrad ? kRowSumsPass : kRepGradPass);
    AVI_MF_PHASE(0);
    if (fused && !need) {
      AVI_MF_PHASE(5);
      continue;  // no cross-column sum read this step: no barrier
    }
    __syncthreads();
    AVI_MF_PHASE(1);

    // a chain's log pi and |u|^2 rows, and its ELBO (VarGrad: its
    // coefficients).  The sums over the rows run in double: VarGrad's
    // f_i = log q_i - log pi_i are log densities of the size of d whose
    // mean fbar the coefficients f_i - fbar subtract, and at n = 128 a float
    // running sum of them loses what those differences keep.
    if (ce >= 0 && ce < gc && need) {
      const int ns = S.slices;
      float ld = 0.0f;
      for (int k = 0; k < ns; ++k) ld += ldp[ce * ns + k];
      double energy = 0.0, uu = 0.0, fsum = 0.0, esum = 0.0;
      float* cf = coef + ce * n;
      for (int i = 0; i < n; ++i) {
        float q = 0.0f, u2 = 0.0f;
        for (int k = 0; k < ns; ++k) {
          q += lpp[(ce * n + i) * ns + k];
          u2 += uup[(ce * n + i) * ns + k];
        }
        const float logpi = -0.5f * q + lognorm;
        if (vargrad) {
          const float logq = -(0.5f * u2 + ld + ent_const);
          const float f = logq - logpi;
          cf[i] = f;
          fsum += f;
          esum += logpi - logq;
        } else {
          energy += logpi;
          uu += u2;
        }
      }
      if (vargrad) {
        const float fbar = static_cast<float>(fsum / n);
        for (int i = 0; i < n; ++i) cf[i] = (cf[i] - fbar) * inv_n;
        elbo = static_cast<float>(esum / n);
      } else {
        const float mean_u2 = static_cast<float>(uu / n);
        elbo = static_cast<float>(energy / n) +
               (cf_zero ? ld + ent_closed : ld + 0.5f * mean_u2 + ent_const);
      }
      if (log_every > 0 && (s + 1) % log_every == 0)
        trace[static_cast<size_t>(chain0 + ce) * (steps / log_every) + (s + 1) / log_every - 1] =
            elbo;
    }
    if (vargrad) {
      __syncthreads();
      pass(kVarGradPass);
      __syncthreads();
      AVI_MF_PHASE(4);
    }

    if (!fused) {
      // each column's dmu and dsig, its row blocks' in order; DoWG's and
      // DoG's sums over 32-column warps; then (without them) the rule
      for (int base = 0; base < gc * dpad; base += kThreads) {
        const int idx = base + tid;
        const int c = idx / dpad;  // one chain a warp
        const int j = idx - c * dpad;
        float part_g = 0.0f, part_x = 0.0f;
        if (c < gc && j < d) {
          float* pc = part + c * 2 * S.R * d;
          float* sc = st + c * srow;
          float dmu = pc[j], dsig = pc[d + j];
          for (int r = 1; r < S.R; ++r) {
            dmu += pc[2 * r * d + j];
            dsig += pc[2 * r * d + d + j];
          }
          const float sj = sc[d + j];
          if (stl_zero && !vargrad) dsig += 1.0f / sj;
          Branch bc = br;
          bc.algo = algo_s[c];
          if (bc.algo == kDoWG || bc.algo == kDoG) {
            const float xm = sc[j] - sc[2 * d + j];
            const float xs = sj - sc[4 * d + j];
            part_g += dmu * dmu + dsig * dsig;
            part_x += xm * xm + xs * xs;
          }
          if (any_dist) {  // held for the rule after the sums
            pc[j] = dmu;
            pc[d + j] = dsig;
          } else {
            Hyper hc = h;
            hc.lr = lr_s[c];
            const float eta = bc.algo == kDescent ? hc.lr : 0.0f;
            rule_column(bc, hc, eta, bc1, bc2, w, sc, d, j, dmu, dsig);
          }
        }
        if (any_dist) {  // uniform over the block: every lane reaches the butterflies
          part_g = warp_sum(part_g);
          part_x = warp_sum(part_x);
          if (lane == 0 && c < gc) {
            distp[c * L.wpc + j / 32] = part_g;
            distp[(G + c) * L.wpc + j / 32] = part_x;
          }
        }
      }
      if (any_dist) {
        __syncthreads();
        if (ce >= 0 && ce < gc && (algo_s[ce] == kDoWG || algo_s[ce] == kDoG)) {
          float tg = 0.0f, tx = 0.0f;
          for (int k = 0; k < L.wpc; ++k) {
            tg += distp[ce * L.wpc + k];
            tx += distp[(G + ce) * L.wpc + k];
          }
          float* v_mu = st + ce * srow + 3 * d;
          eta_s[ce] = distance_rule_step(algo_s[ce], tg, tx, v_mu[0], v_mu[1]);
        }
        __syncthreads();
        for (int base = 0; base < gc * dpad; base += kThreads) {
          const int idx = base + tid;
          const int c = idx / dpad;
          const int j = idx - c * dpad;
          if (c < gc && j < d) {
            const float* pc = part + c * 2 * S.R * d;
            Branch bc = br;
            bc.algo = algo_s[c];
            Hyper hc = h;
            hc.lr = lr_s[c];
            const bool dist_rule = bc.algo == kDoWG || bc.algo == kDoG;
            const float eta = bc.algo == kDescent ? hc.lr : (dist_rule ? eta_s[c] : 0.0f);
            rule_column(bc, hc, eta, bc1, bc2, w, st + c * srow, d, j, pc[j], pc[d + j]);
          }
        }
      }
    }
    AVI_MF_PHASE(5);
    __syncthreads();
    AVI_MF_PHASE(6);
  }

  float* st_out = state_out + static_cast<size_t>(chain0) * srow;
  for (int i = tid; i < gc * srow; i += kThreads) st_out[i] = st[i];
  if (ce >= 0 && ce < gc) elbo_out[chain0 + ce] = elbo;
}

}  // namespace gauss
}  // namespace avi
