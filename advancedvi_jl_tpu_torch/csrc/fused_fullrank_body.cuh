// The single-block full-rank kernel's body (csrc/fused_advi_fullrank.cu
// describes its phases): included inside fused_advi_fullrank_kernel with
// AVI_FR_TIERED 0 (every per-step array in shared memory, the scale
// matrices and the panel operators where place() put them), and inside
// fused_advi_fullrank_tier_kernel with AVI_FR_TIERED 1 (tier_layout's tier
// `tier`, its workspace `work`).  Every line the tiered kernel differs by is
// under #if AVI_FR_TIERED with the untiered kernel's own under #else, so that
// kernel compiles from the very tokens it had before the tiers (ptxas moves
// the whole step with any edit: PERF.md section 6).  No include guard: this
// file is a function body.
#ifdef AVI_AD_BODY
  model = avi::kAD;  // every other model's code drops out of this library
#endif
  extern __shared__ float smem[];
#if AVI_FR_TIERED
  // the model's data in device memory (every tier), the logits (K5: its
  // scratch) in the workspace from tier 2, u, z, g and w from tier 3
  const Layout L = tier_layout_at(model, n_data, db, batch, n, d, k, tier).L;
  const bool mat_in_smem = false;
  float* const lbase = tier >= 2 ? work : smem;
  float* const dbase = tier >= 3 ? work : smem;
#else
  const Layout L = make_layout(model, n_data, db, batch, n, d, k, at.mat, at.inv);
  const bool mat_in_smem = at.mat;
#endif
  const bool logreg = model == avi::kLogReg;
  const bool minibatch = avi::is_minibatch(model);
#if AVI_FR_TIERED
  float* us = dbase + L.u;
  float* zs = dbase + L.z;
  float* gs = dbase + L.g;
  float* ws = dbase + L.w;
#else
  float* us = smem + L.u;
  float* zs = smem + L.z;
  float* gs = smem + L.g;
  float* ws = smem + L.w;
#endif
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
#if AVI_FR_TIERED
  float* inv = inv_dev;  // the panel operators M_p
  const avi::LogReg lrm{c0, c1, lbase + L.l, nullptr, n_data, db, n_data, 0, s0, s1};
  avi::LogRegMB mbm{nullptr, smem + L.y, lbase + L.l, nullptr, batch, db, 0, s0, s1};
#else
  float* inv = at.inv ? smem + L.inv : inv_dev;   // the panel operators M_p
  // no aligned beta copy here: the logreg products below read z and the logits' rows
  const avi::LogReg lrm{smem + L.X, smem + L.y, smem + L.l, nullptr, n_data, db, n_data, 0,
                        s0, s1};
  avi::LogRegMB mbm{nullptr, smem + L.y, smem + L.l, nullptr, batch, db, 0, s0, s1};
#endif
  const int nb = minibatch ? n_data / batch : 1;
  const float* mean = c0;  // mvnormal: mean (d,) and precision (d, d)
  const float* prec = c1;  // gaussian: mean (d,) and inverse variances (d,)
  const float lognorm = s0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#if AVI_FR_TIERED
#else
  if (logreg) {
    for (int i = tid; i < n_data * db; i += kThreads) smem[L.X + i] = c0[i];
    for (int i = tid; i < n_data; i += kThreads) smem[L.y + i] = c1[i];
  }
#endif
  for (int i = tid; i < k * d; i += kThreads) mu[i] = vec_in[i];
  for (size_t i = tid; i < k * dd; i += kThreads) sig[i] = mat_in[i];
#if defined(AVI_AD_BODY) && !AVI_FR_TIERED  // nothing staged on the tiered layout
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
#if AVI_FR_TIERED
    if (minibatch)  // the slab read where it lies
      mbm.X = avi::minibatch_step_in_place(model, c0, c1, batch, db, nb, it, smem + L.y, tid,
                                           kThreads);
#else
    if (minibatch)
      mbm.X = avi::minibatch_step_begin(model, c0, c1, batch, db, nb, it, smem + L.X,
                                        smem + L.y, tid, kThreads);
#endif

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
#if AVI_FR_TIERED
      avi::ad::ad_body(c0, reinterpret_cast<const int*>(c1), smem, zs, n, d, logpi, gs,
                       lbase + L.ad, tid, &t_logpi);
#else
      avi::ad::ad_body(c0, reinterpret_cast<const int*>(c1), smem + L.adc, zs, n, d, logpi, gs,
                       smem + L.ad, tid, &t_logpi);
#endif
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
