// K6: C independent mean-field chains, each the whole optimisation loop of
// csrc/fused_advi_meanfield.cu, in one launch.
//
// Replaces ops/pallas/fused_chains.py::_run_chains_chunk (both pallas_calls,
// plain :525 and traced grid :561) with its body _chains_kernel (:109-464):
// per chain, the draw, the model's log density and gradient (logreg, the
// dense and the diagonal Gaussian, the three minibatch transports), the STL / zero-gradient
// entropies or VarGrad, Adam / descent / DoWG / DoG / COCOB, ClipScale / prox
// / none, polynomial averaging and the per-chain ELBO and trace, with a
// per-chain learning rate (lr sweeps) and a per-chain rule code (mixed
// sweeps, RULE_CODES).  The plain PyTorch version is
// fused_chains_run_chunk_reference in ops/cuda/fused_chains.py.
//
// What bounds it on an H100: latency, as the single-chain kernel.  One
// chain's step at the flagship width is about 254k multiply-adds from shared
// memory with five block-wide barriers between its phases, a few
// microseconds of one SM in which most of the block's 16 warps wait (the
// draws take 5 warps, the rule pass 2, the ELBO one thread); chains share
// nothing but the model's data.  The shared body takes 128 registers a
// thread at 512 threads, so a block fills an SM's register file and one
// block runs on an SM at a time.
//
// Design: G chains a block, grid = ceil(C / G).  The wrapper picks G on the
// host (chains_per_block in ops/cuda/fused_chains.py): 1 while C <= the
// card's SMs, else ceil(C / SMs) capped by the largest G whose layout fits
// one block's shared memory (at most kMaxChains), and above that many
// chains the fewest G that keeps the fewest waves of blocks.
//
//  - G = 1 is the single-chain body itself (csrc/fused_meanfield_body.cuh,
//    the very code of fused_advi_meanfield.cu; fused_chains_kernel below),
//    keyed by its chain's seed words, with its chain's lr and, in a mixed
//    sweep, its chain's rule (SELECTED, where the TPU kernel blends every
//    rule's candidate with 0/1 weights: the two agree wherever every
//    candidate is finite).  Its instances compile as they did before the
//    G-chain instances existed (ptxas moves the whole step's register
//    allocation with any edit of that path).
//  - G > 1 (fused_chains_g_kernel): the block holds the model's data once
//    (X and y; a minibatch model its staged slab and yX[k], the slab index
//    following the global iteration, so the block's chains read one slab),
//    then each per-chain array for its G chains, chain-major (ChainsLayout).
//    One set of barriers serves the G chains: the draws run over G n d / 4
//    lane groups, the row sums one warp a row over G n rows, the logits and
//    the likelihood gradient are each one block_mm with the G chains' rows
//    stacked (M = G n against the shared X), log pi one warp a row.  Phase D
//    maps thread t to chain t / dpad, lane t % dpad (dpad = d rounded up to
//    whole warps, so no warp mixes chains or rules); DoWG and DoG sum each
//    chain's warps in warp order; one thread a chain forms its ELBO (the
//    last warp's lanes) and its trace.  Per chain stay the lr, the rule
//    code, COCOB's six ext rows, the noise rows and the trace row.
//
// Chain c of a G-chain launch equals the single-chain kernel keyed by chain
// c's words, bit for bit: every sum of a chain runs in the single-chain
// order (block_mm fixes each output's order by (K, lanes), not by the
// tiling; the warp sums take the same lanes; a chain's DoWG warp totals are
// the single-chain block total's nonzero terms in its order; the prox spells
// out the fma the single-chain kernel's compilation chose).  G > 1 needs
// d <= kThreads (one lane a thread in phase D, the single-chain mapping)
// and runs the hand bodies only: a library built with K5's generated body
// (AVI_AD_BODY) has its scratch and barriers placed for one chain and
// keeps G = 1.  So does a design too large for the aligned layout (the
// kDensePlain group): its G = 2 layout never fits one block; and so does a
// launch of the kWide or kMbWide group that needs the device workspace
// (fused_chains_wide_kernel and fused_chains_mb_wide_kernel, each chain its
// own slice of it; K5's body on kWide too).  The dense
// Gaussian, in its own kMvn group, runs G > 1 chains a block where their
// layout fits, its P staged once for the block where it fits beside them
// and else streamed through the product's ring (chains_mvn_stream); its
// product keeps each output's k order whatever the rows, so the promise
// holds (csrc/mvnormal_product.cuh).  The diagonal Gaussian runs its own
// kGauss body (csrc/fused_gauss_body.cuh; fused_chains_gauss_kernel one chain
// a block, fused_chains_g_kernel<1, kGauss> G chains at any d): one
// column-fused pass a step with no (n, d) arrays, every sum of a chain in an
// order of (n, d) alone, so the promise holds there too.
//
// Layouts: state (C, n_rows, d), chain c's rows as the single-chain kernel's;
// elbo (C,); trace (C, steps / log_every), chain-major, so each chain's ELBO
// thread writes its own row (the wrapper hands out the (steps / log_every,
// C) view); noise (C, steps, n, d); seeds (C, 2); lrs (C,) or null; rules
// (C,) or null.
#include "fused_gauss_body.cuh"

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

// One chain a block of a group on the device workspace, kWide or kMbWide
// (fused_meanfield_body.cuh wide_layout, mb_layout): the single-chain
// kernel's body keyed by chain c, with chain c's slice of the device
// workspace, ws + c ws_floats.  Each group its own kernel below, so the
// instances above keep their signatures and their code.
template <int kGroup>
__device__ __forceinline__ void run_chain_on_workspace(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* __restrict__ seeds, unsigned long long it0, const float* __restrict__ lrs,
    const int* __restrict__ rules, avi::Hyper h, avi::Branch br, float* __restrict__ ws,
    long long ws_floats) {
  const int c = blockIdx.x;
  const size_t rows = static_cast<size_t>(n_rows) * d;
  if (lrs != nullptr) h.lr = lrs[c];
  if (rules != nullptr) br.algo = rules[c];
  float* tr = nullptr;
  if (trace != nullptr) tr = trace + static_cast<size_t>(c) * (steps / log_every);
  const float* nz = nullptr;
  if (noise != nullptr) nz = noise + static_cast<size_t>(c) * steps * n * d;
  avi::mf::run_chunk<true, kGroup>(
      model, c0, c1, n_data, db, batch, s0, s1, state_in + c * rows, state_out + c * rows,
      elbo_out + c, tr, nz, n, d, n_rows, steps, log_every, seeds[2 * c], seeds[2 * c + 1], it0,
      h, br, ws == nullptr ? nullptr : ws + c * ws_floats);
}

__global__ void __launch_bounds__(kThreads, 1) fused_chains_wide_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* __restrict__ seeds, unsigned long long it0, const float* __restrict__ lrs,
    const int* __restrict__ rules, avi::Hyper h, avi::Branch br, float* __restrict__ ws,
    long long ws_floats) {
  run_chain_on_workspace<avi::mf::kWide>(
      model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise, n,
      d, n_rows, steps, log_every, seeds, it0, lrs, rules, h, br, ws, ws_floats);
}

#ifndef AVI_AD_BODY
__global__ void __launch_bounds__(kThreads, 1) fused_chains_mvn_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* __restrict__ seeds, unsigned long long it0, const float* __restrict__ lrs,
    const int* __restrict__ rules, avi::Hyper h, avi::Branch br, float* __restrict__ ws,
    long long ws_floats) {
  run_chain_on_workspace<avi::mf::kMvn>(
      model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise, n,
      d, n_rows, steps, log_every, seeds, it0, lrs, rules, h, br, ws, ws_floats);
}

__global__ void __launch_bounds__(kThreads, 1) fused_chains_mb_wide_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* __restrict__ seeds, unsigned long long it0, const float* __restrict__ lrs,
    const int* __restrict__ rules, avi::Hyper h, avi::Branch br, float* __restrict__ ws,
    long long ws_floats) {
  run_chain_on_workspace<avi::mf::kMbWide>(
      model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise, n,
      d, n_rows, steps, log_every, seeds, it0, lrs, rules, h, br, ws, ws_floats);
}

// The kGauss group (csrc/fused_gauss_body.cuh), one chain a block: the
// single-chain kernel's body keyed by chain c's words, with its lr and rule.
__global__ void __launch_bounds__(kThreads, 1) fused_chains_gauss_kernel(
    const float* __restrict__ c0, const float* __restrict__ c1, float s0,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    float* __restrict__ elbo_out, float* __restrict__ trace, const float* __restrict__ noise,
    int n_chains, int n, int d, int n_rows, int steps, int log_every,
    const uint32_t* __restrict__ seeds, unsigned long long it0, const float* __restrict__ lrs,
    const int* __restrict__ rules, avi::Hyper h, avi::Branch br) {
  avi::gauss::run_chunk(c0, c1, s0, state_in, state_out, elbo_out, trace, noise, n_chains, 1, n,
                        d, n_rows, steps, log_every, seeds, 0u, 0u, it0, lrs, rules, h, br);
}
#endif

// ---------------------------------------------------------------------------
// G chains a block
// ---------------------------------------------------------------------------

using avi::mf::kElbo;
using avi::mf::kWarps;
// Chains a block at most: their ELBO threads are lanes of the last warp.
constexpr int kMaxChains = 32;
// The dense logreg products' tiles in blocks of several chains, rows x
// columns a thread (fused_common.cuh); the lanes that split k stay the
// single-chain kernel's, which fix each sum's order.  Two data (features) a
// thread reuse each beta (weight) load twice: of six pairs timed on an H100
// (PERF.md section 6, the tile sweep T1) 10 x 2 ran C = 256 fastest and
// C = 1,024 within 4% of the fastest; the single-chain 10 x 1 ran 1,024
// chains 21% slower.
constexpr int kGLogitRows = 10, kGLogitCols = 2;
constexpr int kGGradRows = 10, kGGradCols = 2;

// Offsets (in floats) of a G-chain block's shared-memory arrays: the model's
// data once, then each per-chain array for the G chains, chain c's part at
// c times its size (rows c n .. c n + n - 1 of the stacked (G n, .) arrays).
struct ChainsLayout {
  int X, y, l, zb, u, z, g, st, grad, row, red, lr, algo, seed, total;
  int ldl, ldz;  // row strides of l and zb, as the single-chain layout's
  int wpc;       // warps of a chain's lanes in phase D: d rounded up to whole warps
};

// The single-chain layout_for's arrays with G chains (the minibatch
// logreg copies its betas to zb, as the single-chain kMinibatch instance).
// The per-chain row sums are seven (G n) arrays and G log dets; red holds
// each chain's warp totals of |g|^2 and |x - x0|^2 (DoWG, DoG), then its eta;
// lr, algo and seed the chains' learning rates, rule codes and seed words.
__host__ __device__ inline ChainsLayout chains_layout(int model, int n_data, int db, int batch,
                                                      int n, int d, int n_rows, bool aligned,
                                                      int G) {
  ChainsLayout L;
  int o = 0;
  const bool logreg = model == avi::kLogReg;
  const bool mb = avi::is_minibatch(model);
  const bool al = logreg && aligned;
  const bool copy = al || mb;  // the betas go to zb
  const int gn = G * n;
  L.ldl = al ? avi::round4(n_data) : (logreg ? n_data : batch);
  L.ldz = copy ? avi::round4(db) : 0;
  L.wpc = (d + 31) / 32;
  L.X = o;    o += logreg ? n_data * db : (avi::slab_staged(model) ? batch * db : 0);
  L.y = o;    o += logreg ? n_data : (mb ? db : 0);
  if (copy) o = avi::round4(o);
  L.l = o;    o += logreg || mb ? gn * L.ldl : 0;
  L.zb = o;   o += gn * L.ldz;
  L.u = o;    o += gn * d;
  L.z = o;    o += gn * d;
  L.g = o;    o += gn * d;
  L.st = o;   o += G * n_rows * d;
  L.grad = o; o += G * 2 * d;
  L.row = o;  o += 7 * gn + G;
  L.red = o;  o += 2 * G * L.wpc + G;
  L.lr = o;   o += G;
  L.algo = o; o += G;
  L.seed = o; o += 2 * G;
  L.total = o;
  return L;
}

// Where a block of G chains of the dense Gaussian keeps its product's
// arrays (csrc/mvnormal_product.cuh) for its M = G n rows: after the
// layout's arrays, P staged once for the block where it fits beside them,
// else the ring that streams it from device memory.
__host__ __device__ inline avi::mvn::Stream chains_mvn_stream(const ChainsLayout& L, int M,
                                                              int d) {
  const int limit = static_cast<int>(kSmemLimit / sizeof(float));
  const avi::mvn::Stream S = avi::mvn::stream_at<kThreads>(L.total, M, d, true, limit);
  return S.end <= limit ? S : avi::mvn::stream_at<kThreads>(L.total, M, d, false, limit);
}

// G chains of the single-chain body (run_chunk) in one block; see the design
// note at the head of this file.  chain0: the block's first chain; G: chains
// a block (the layout's); the last block may hold fewer (gc).
template <bool kGeneral, int kGroup>
__global__ void __launch_bounds__(kThreads, 1) fused_chains_g_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n_chains, int G, int n, int d, int n_rows, int steps,
    int log_every, const uint32_t* __restrict__ seeds, unsigned long long it0,
    const float* __restrict__ lrs, const int* __restrict__ rules, avi::Hyper h,
    avi::Branch br) {
  using avi::mf::kMinibatch;
  if (!kGeneral) br = avi::kDefaultBranch;  // every switch below is then constant
  if (kGroup == avi::mf::kMvn) model = avi::kMvNormal;
  extern __shared__ float smem[];
  // G > 1 runs the aligned dense and the minibatch groups only: a design
  // whose aligned layout does not fit one chain's block (kDensePlain) leaves
  // no room for a second chain's logits, so the host never picks G > 1 there
  constexpr bool kAligned = true;
  const ChainsLayout L = chains_layout(model, n_data, db, batch, n, d, n_rows, kAligned, G);
  // kMvn runs the dense Gaussian here, the product's plan for the G n rows
  const avi::mvn::Stream S =
      kGroup == avi::mf::kMvn ? chains_mvn_stream(L, G * n, d) : avi::mvn::Stream();
  const bool logreg = kGroup != kMinibatch && model == avi::kLogReg;
  const bool minibatch = kGroup == kMinibatch && avi::is_minibatch(model);
  const int chain0 = blockIdx.x * G;
  const int gc = min(G, n_chains - chain0);  // chains of this block
  const int gn = gc * n;                     // their sample rows
  const int nd = n * d;
  const int srow = n_rows * d;  // one chain's state
  const int dpad = 32 * L.wpc;
  float* us = smem + L.u;
  float* zs = smem + L.z;
  float* gs = smem + L.g;
  float* st = smem + L.st;
  float* grad = smem + L.grad;
  float* beta_sq = smem + L.row;
  float* tcol = beta_sq + gn;
  float* inv_sig2 = tcol + gn;
  float* logpi = inv_sig2 + gn;
  float* u2 = logpi + gn;
  float* coef = u2 + gn;
  float* ylogit = coef + gn;
  float* logdet = ylogit + gn;
  float* red_g = smem + L.red;
  float* red_x = red_g + G * L.wpc;
  float* eta_s = red_x + G * L.wpc;
  float* lr_s = smem + L.lr;
  int* algo_s = reinterpret_cast<int*>(smem + L.algo);
  uint32_t* seed_s = reinterpret_cast<uint32_t*>(smem + L.seed);
  const avi::LogReg lrm{smem + L.X, smem + L.y, smem + L.l, smem + L.zb, n_data, db,
                        L.ldl, L.ldz, s0, s1};
  float* zb = smem + L.zb;
  const int ldz = L.ldz;
  avi::LogRegMB mbm{nullptr, smem + L.y, smem + L.l, zb, batch, db, ldz, s0, s1};
  const int nb = minibatch ? n_data / batch : 1;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ce = tid - kElbo;  // the chain whose ELBO this thread forms, if 0 <= ce < gc
  if (logreg) {
    for (int i = tid; i < n_data * db; i += kThreads) smem[L.X + i] = c0[i];
    for (int i = tid; i < n_data; i += kThreads) smem[L.y + i] = c1[i];
  }
  const float* st_in = state_in + static_cast<size_t>(chain0) * srow;
  for (int i = tid; i < gc * srow; i += kThreads) st[i] = st_in[i];
  for (int c = tid; c < gc; c += kThreads) {
    lr_s[c] = lrs != nullptr ? lrs[chain0 + c] : h.lr;
    algo_s[c] = rules != nullptr ? rules[chain0 + c] : br.algo;
    seed_s[2 * c] = seeds[2 * (chain0 + c)];
    seed_s[2 * c + 1] = seeds[2 * (chain0 + c) + 1];
  }
  uint32_t fill = 0;  // kMvn: the ring's blocks of P read so far
  if (kGroup == avi::mf::kMvn) avi::mvn::stage_or_start<kThreads>(S, smem, c1, d, tid);
  __syncthreads();

  const bool vargrad = br.grad_est == avi::kScoreGrad;
  const bool cf_zero = br.entropy == avi::kClosedFormZero;
  const bool stl_zero = br.entropy == avi::kSTLZero;
  bool any_dist = false;  // a DoWG or DoG chain in the block: its sums' barriers
  if (kGeneral)
    for (int c = 0; c < gc; ++c) any_dist |= algo_s[c] == avi::kDoWG || algo_s[c] == avi::kDoG;
  const float inv_n = 1.0f / static_cast<float>(n);
  const float ln_b1 = logf(h.b1);
  const float ln_b2 = logf(h.b2);
  const float ent_const = 0.5f * static_cast<float>(d) * avi::kLog2Pi;
  const float ent_closed = 0.5f * static_cast<float>(d) * (1.0f + avi::kLog2Pi);
  const int groups = (d + 3) / 4;
  const int ng = n * groups;
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

    // A: base draws and z = mu + sig * u of every chain's rows
    if (noise != nullptr) {
      for (int idx = tid; idx < gc * nd; idx += kThreads) {
        const int c = idx / nd;
        const int r = idx - c * nd;
        const int j = r % d;
        const float* sc = st + c * srow;
        const float uv = noise[(static_cast<size_t>(chain0 + c) * steps + s) * nd + r];
        us[idx] = uv;
        const float zv = __fadd_rn(sc[j], __fmul_rn(sc[d + j], uv));
        zs[idx] = zv;
        if (kAligned && (logreg || minibatch) && j < db) zb[(idx / d) * ldz + j] = zv;
      }
    } else {
      for (int pair = tid; pair < gc * ng; pair += kThreads) {
        const int c = pair / ng;
        const int p = pair - c * ng;
        const int i = p / groups;
        const int g = p - i * groups;
        const float* sc = st + c * srow;
        const int row = c * n + i;
        float w[4];
        avi::normals4(seed_s[2 * c], seed_s[2 * c + 1], static_cast<uint32_t>(it),
                      static_cast<uint32_t>(i), static_cast<uint32_t>(g), w);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * g + q;
          if (j < d) {
            us[row * d + j] = w[q];
            const float zv = __fadd_rn(sc[j], __fmul_rn(sc[d + j], w[q]));
            zs[row * d + j] = zv;
            if (kAligned && (logreg || minibatch) && j < db) zb[row * ldz + j] = zv;
          }
        }
      }
    }
    __syncthreads();
    AVI_MF_PHASE(0);
    if (logreg) avi::logreg_rows(lrm, zs, gn, d, beta_sq, tcol, inv_sig2, warp, kWarps, lane);
    if (minibatch)
      avi::logreg_mb_rows(mbm, zs, gn, d, beta_sq, tcol, inv_sig2, ylogit, warp, kWarps, lane);
    for (int i = warp; i < gn; i += kWarps) {
      float uu = 0.0f;
      for (int j = lane; j < d; j += 32) {
        const float v = us[i * d + j];
        uu += v * v;
      }
      uu = avi::warp_sum(uu);
      if (lane == 0) u2[i] = uu;
    }
    // log det of each chain's pre-update scale, one warp a chain from the last
    for (int c = kWarps - 1 - warp; c < gc; c += kWarps) {
      const float* sig = st + c * srow + d;
      float ld = 0.0f;
      for (int j = lane; j < d; j += 32) ld += logf(sig[j]);
      ld = avi::warp_sum(ld);
      if (lane == 0) logdet[c] = ld;
    }
    if (avi::slab_staged(model)) avi::cp_async_wait_all();  // this thread's copies landed
    __syncthreads();
    AVI_MF_PHASE(1);

    // B: log pi (and the Gaussian's gradient) of the G n stacked rows
    if (logreg) {
      avi::logreg_logits<kThreads, kAligned, kGLogitRows, kGLogitCols>(lrm, zs, gn, d, tid);
      __syncthreads();
      AVI_MF_PHASE(2);
      avi::logreg_logpi(lrm, gn, beta_sq, tcol, inv_sig2, logpi, warp, kWarps, lane);
    } else if (minibatch) {
      avi::logreg_mb_logits<kThreads>(mbm, gn, tid);
      __syncthreads();
      AVI_MF_PHASE(2);
      avi::logreg_mb_logpi(mbm, gn, beta_sq, tcol, inv_sig2, ylogit, logpi, warp, kWarps, lane);
    } else if (kGroup == avi::mf::kMvn) {  // the dense Gaussian, VarGrad ignores gs
      avi::mvnormal_stream_body<kThreads>(c0, c1, S, smem, fill, s0, zs, gn, d, logpi, gs, tid,
                                          warp, kWarps, lane);
    } else if (kGroup != kMinibatch) {
      avi::gaussian_body(c0, c1, s0, zs, gn, d, logpi, vargrad ? nullptr : gs, warp, kWarps,
                         lane);
    }
    __syncthreads();
    AVI_MF_PHASE(3);

    // C: logreg's grad log pi, or VarGrad's coefficients and ELBO (a thread a chain)
    if (vargrad) {
      if (ce >= 0 && ce < gc) {
        const float* lp = logpi + ce * n;
        const float* uu = u2 + ce * n;
        float* cf = coef + ce * n;
        const float ldet = logdet[ce];
        float fsum = 0.0f, esum = 0.0f;
        for (int i = 0; i < n; ++i) {
          const float logq = -(0.5f * uu[i] + ldet + ent_const);
          const float f = logq - lp[i];
          cf[i] = f;
          fsum += f;
          esum += lp[i] - logq;
        }
        const float fbar = inv_n * fsum;
        for (int i = 0; i < n; ++i) cf[i] = (cf[i] - fbar) * inv_n;
        elbo = inv_n * esum;
      }
      __syncthreads();
      AVI_MF_PHASE(4);
    } else if (logreg) {
      avi::logreg_grad<kThreads, kAligned, kGGradRows, kGGradCols>(lrm, zs, gn, d, beta_sq,
                                                                   tcol, inv_sig2, gs, tid);
      __syncthreads();
      AVI_MF_PHASE(4);
    } else if (minibatch) {
      avi::logreg_mb_grad<kThreads>(mbm, zs, gn, d, beta_sq, tcol, inv_sig2, gs, tid);
      __syncthreads();
      AVI_MF_PHASE(4);
    }

    // D: the gradient of the step, thread t on chain t / dpad, lane t % dpad;
    // then (DoWG, DoG) each chain's sums, its warps' totals in warp order
    for (int base = 0; base < gc * dpad; base += kThreads) {
      const int idx = base + tid;
      const int c = idx / dpad;  // one chain a warp
      const int j = idx - c * dpad;
      float part_g = 0.0f, part_x = 0.0f;
      if (c < gc && j < d) {
        float* sc = st + c * srow;
        const float* ur = us + c * nd;
        const float* gr = gs + c * nd;
        const float* cf = coef + c * n;
        const float sj = sc[d + j];
        float dmu = 0.0f, dsig = 0.0f;
        if (vargrad) {
          for (int i = 0; i < n; ++i) {
            const float uij = ur[i * d + j];
            dmu += cf[i] * (uij / sj);
            dsig += cf[i] * ((uij * uij - 1.0f) / sj);
          }
        } else {
          for (int i = 0; i < n; ++i) {
            const float uij = ur[i * d + j];
            const float gz =
                -inv_n * (cf_zero ? gr[i * d + j] : gr[i * d + j] + uij / sj);
            dmu += gz;
            dsig += gz * uij;
          }
          if (stl_zero) dsig += 1.0f / sj;
        }
        grad[c * 2 * d + j] = dmu;
        grad[c * 2 * d + d + j] = dsig;
        const int algo = kGeneral ? algo_s[c] : br.algo;
        if (algo == avi::kDoWG || algo == avi::kDoG) {
          const float xm = sc[j] - sc[2 * d + j];
          const float xs = sj - sc[4 * d + j];
          part_g += dmu * dmu + dsig * dsig;
          part_x += xm * xm + xs * xs;
        }
      }
      if (any_dist) {  // uniform over the block: every lane reaches the butterflies
        part_g = avi::warp_sum(part_g);
        part_x = avi::warp_sum(part_x);
        if (lane == 0 && c < gc) {
          red_g[c * L.wpc + j / 32] = part_g;
          red_x[c * L.wpc + j / 32] = part_x;
        }
      }
    }
    if (any_dist) {  // the other rules need no barrier: a thread reads back its own lanes
      __syncthreads();
      if (tid < gc && (algo_s[tid] == avi::kDoWG || algo_s[tid] == avi::kDoG)) {
        float tg = 0.0f, tx = 0.0f;
        for (int w = 0; w < L.wpc; ++w) {
          tg += red_g[tid * L.wpc + w];
          tx += red_x[tid * L.wpc + w];
        }
        float* v_mu = st + tid * srow + 3 * d;
        eta_s[tid] = avi::distance_rule_step(algo_s[tid], tg, tx, v_mu[0], v_mu[1]);
      }
      __syncthreads();
    }

    // D: the rule, the operator and the averaging, one thread per lane of a chain
    const float cs = static_cast<float>(it) + 1.0f;
    const float bc1 = 1.0f - expf(cs * ln_b1);
    const float bc2 = 1.0f - expf(cs * ln_b2);
    const float w = (h.avg_eta + 1.0f) / (cs + h.avg_eta);
    for (int base = 0; base < gc * dpad; base += kThreads) {
      const int idx = base + tid;
      const int c = idx / dpad;
      const int j = idx - c * dpad;
      if (c < gc && j < d) {
        avi::Hyper hc = h;
        hc.lr = lr_s[c];
        avi::Branch bc = br;
        if (kGeneral) bc.algo = algo_s[c];
        const bool dist_rule = bc.algo == avi::kDoWG || bc.algo == avi::kDoG;
        const bool cocob = bc.algo == avi::kCOCOB;
        const float eta = bc.algo == avi::kDescent ? hc.lr : (dist_rule ? eta_s[c] : 0.0f);
        float* sc = st + c * srow;
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
        avi::rule_step(bc, hc, eta, bc1, bc2, mu[j], m_mu[j], v_mu[j], cg, R, T,
                       grad[c * 2 * d + j]);
        if (cocob) {
          ext[j] = cg;
          ext[d + j] = R;
          ext[2 * d + j] = T;
          cg = ext[3 * d + j];
          R = ext[4 * d + j];
          T = ext[5 * d + j];
        }
        float x = sig[j];
        avi::rule_step(bc, hc, eta, bc1, bc2, x, m_sig[j], v_sig[j], cg, R, T,
                       grad[c * 2 * d + d + j]);
        if (cocob) {
          ext[3 * d + j] = cg;
          ext[4 * d + j] = R;
          ext[5 * d + j] = T;
        }
        // the prox as the single-chain kernel compiles it: its s s + 4 eta is
        // one fma there, and left to itself ptxas fuses 4 eta here instead
        x = bc.op == avi::kProx ? 0.5f * x + 0.5f * sqrtf(fmaf(x, x, 4.0f * eta))
                                : avi::scale_operator(bc.op, x, eta, hc);
        sig[j] = x;
        if (dist_rule && j >= 2) v_mu[j] = 0.0f;  // v_mu holds [v, r, 0, ...]
        a_mu[j] = (1.0f - w) * a_mu[j] + w * mu[j];
        a_sig[j] = (1.0f - w) * a_sig[j] + w * x;
      }
    }

    // E: each chain's ELBO estimate, energy + entropy value (a thread a chain)
    if (ce >= 0 && ce < gc) {
      if (!vargrad) {
        const float* lp = logpi + ce * n;
        const float* uq = u2 + ce * n;
        float energy = 0.0f, uu = 0.0f;
        for (int i = 0; i < n; ++i) {
          energy += lp[i];
          uu += uq[i];
        }
        elbo = inv_n * energy + (cf_zero ? logdet[ce] + ent_closed
                                         : logdet[ce] + inv_n * (0.5f * uu) + ent_const);
      }
      if (log_every > 0 && (s + 1) % log_every == 0)
        trace[static_cast<size_t>(chain0 + ce) * (steps / log_every) + (s + 1) / log_every -
              1] = elbo;
    }
    AVI_MF_PHASE(5);
    __syncthreads();
    AVI_MF_PHASE(6);
  }

  float* st_out = state_out + static_cast<size_t>(chain0) * srow;
  for (int i = tid; i < gc * srow; i += kThreads) st_out[i] = st[i];
  if (ce >= 0 && ce < gc) elbo_out[chain0 + ce] = elbo;
  if (kGroup == avi::mf::kMvn) avi::mvn::drain(S, smem, fill, tid);
}

#ifndef AVI_AD_BODY
// G chains of the kGauss group a block (csrc/fused_gauss_body.cuh): each
// chain's sums in the single-chain order, whatever G, so chain c equals the
// single-chain kernel keyed by its words, bit for bit.  Its own body, not
// the one above: no u, z or g arrays, no model's data to share.
template <>
__global__ void __launch_bounds__(kThreads, 1) fused_chains_g_kernel<true, avi::mf::kGauss>(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n_chains, int G, int n, int d, int n_rows, int steps,
    int log_every, const uint32_t* __restrict__ seeds, unsigned long long it0,
    const float* __restrict__ lrs, const int* __restrict__ rules, avi::Hyper h,
    avi::Branch br) {
  avi::gauss::run_chunk(c0, c1, s0, state_in, state_out, elbo_out, trace, noise, n_chains, G, n,
                        d, n_rows, steps, log_every, seeds, 0u, 0u, it0, lrs, rules, h, br);
}
#endif

template <int kGroup>
auto g_kernel_for(bool flagship_branch) {
  return flagship_branch ? fused_chains_g_kernel<false, kGroup>
                         : fused_chains_g_kernel<true, kGroup>;
}

}  // namespace

// The dynamic shared memory of a block of G chains (chains_per_block): at
// G = 1 the single-chain kernel's layout with every array in shared memory
// (fused_advi_meanfield_smem_bytes), else ChainsLayout's (the dense
// Gaussian's with its product's arrays after it, chains_mvn_stream); the
// diagonal Gaussian's at any G its kGauss layout (gauss::layout_for).
extern "C" size_t fused_chains_smem_bytes(int model, int n_data, int db, int batch, int n,
                                          int d, int n_rows, int chains_per_block) {
  if (model == avi::kGaussian) return avi::gauss::smem_bytes(n, d, n_rows, chains_per_block);
  if (chains_per_block == 1)
    return sizeof(float) *
           static_cast<size_t>(make_layout(model, n_data, db, batch, n, d, n_rows).total);
  const int group = avi::mf::model_group(model, n_data, db, batch, n, d, n_rows);
  const bool aligned = group != avi::mf::kDensePlain && group != avi::mf::kWide;
  const ChainsLayout L =
      chains_layout(model, n_data, db, batch, n, d, n_rows, aligned, chains_per_block);
  return sizeof(float) * static_cast<size_t>(model == avi::kMvNormal
                                                 ? chains_mvn_stream(L, chains_per_block * n, d).end
                                                 : L.total);
}

// What a launch at G chains a block takes: at G = 1 the single-chain
// kernel's launch_layout (out[0] group, out[1] bytes of shared memory, out[2]
// floats of device workspace a chain, out[3] the kWide or kMvn tier), else its
// group, fused_chains_smem_bytes, no workspace and tier -1 (kMvn's G-chain
// blocks stream P from device memory where it does not fit).
extern "C" void fused_chains_layout(int model, int n_data, int db, int batch, int n, int d,
                                    int n_rows, int chains_per_block, long long* out) {
  avi::mf::launch_layout(model, n_data, db, batch, n, d, n_rows, out);
  if (chains_per_block > 1) {
    out[1] = static_cast<long long>(
        fused_chains_smem_bytes(model, n_data, db, batch, n, d, n_rows, chains_per_block));
    out[2] = 0;
    out[3] = -1;
  }
}

#ifdef AVI_PHASE_CLOCKS
// Copies the instrumented build's avi_mf_phase_cycles (block 0's thread 0;
// fused_meanfield_body.cuh) to host memory `out` after the work queued so
// far, then zeroes them.  Returns the first CUDA error (0 on success).
extern "C" int fused_chains_phase_cycles(unsigned long long* out) {
  using avi::mf::avi_mf_phase_cycles;
  cudaError_t err = cudaMemcpyFromSymbol(out, avi_mf_phase_cycles, sizeof(avi_mf_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[avi::mf::kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(avi_mf_phase_cycles, zero, sizeof(zero)));
}
#endif

// The models, their constants and the state rows of each chain are those of
// fused_advi_meanfield (see there).  ceil(n_chains / chains_per_block)
// blocks of chains_per_block chains (1 <= G <= kMaxChains; G > 1 needs
// d <= 512, but on the diagonal Gaussian's kGauss group, and a library
// without a generated body); n_rows is 8, or 14
// when any chain runs COCOB (the other chains carry the six ext rows
// through).  algo: the launch's rule code, ignored when rules is not null
// (a mixed sweep; the caller checks d >= 2 for its DoWG and DoG chains).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a launch the kernel does not take.
extern "C" int fused_chains(
    int model, const float* c0, const float* c1, int n_data, int db, int batch, float s0,
    float s1, const float* state_in, float* state_out, float* elbo_out, float* trace,
    const float* noise, int n_chains, int chains_per_block, int n, int d, int n_rows,
    int steps, int log_every, const uint32_t* seeds, unsigned long long it0, const float* lrs,
    const int* rules, float lr, float b1, float b2, float eps, float avg_eta, float clip_eps,
    int algo, int entropy, int grad_est, int op, float cocob_alpha, float* ws,
    cudaStream_t stream) {
  const bool dist_rule = rules == nullptr && (algo == avi::kDoWG || algo == avi::kDoG);
  const bool mb = avi::is_minibatch(model);
  const int G = chains_per_block;
  bool known = model == avi::kLogReg || model == avi::kMvNormal || model == avi::kGaussian || mb;
#ifdef AVI_AD_BODY  // K5's body is generated for one (n, d), runs alone; its constants are shared
  known = model == avi::kAD && n == avi::ad::kN && d == avi::ad::kD && G == 1;
#endif
  if (!known || (dist_rule && d < 2) ||
      n_chains < 1 || G < 1 || G > kMaxChains ||
      (G > 1 && d > kThreads && model != avi::kGaussian) ||
      (n_rows != 8 && n_rows != 14) ||
      (rules == nullptr && algo == avi::kCOCOB && n_rows != 14) ||
      (grad_est == avi::kScoreGrad && n < 2) || (log_every > 0 && steps % log_every != 0) ||
      (mb && (batch < 1 || batch % 8 != 0 || n_data % batch != 0 || n_data < batch ||
              reinterpret_cast<uintptr_t>(c0) % 16 != 0)) ||
      (model == avi::kMvNormal && (d > kThreads * 4 || reinterpret_cast<uintptr_t>(c1) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  long long lay[4];
  fused_chains_layout(model, n_data, db, batch, n, d, n_rows, G, lay);
  const size_t smem = static_cast<size_t>(lay[1]);
  if (smem > kSmemLimit || (lay[2] > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool def = rules == nullptr && avi::is_default(algo, entropy, grad_est, op);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  const avi::Branch br{algo, entropy, grad_est, op, cocob_alpha};
  const int group = static_cast<int>(lay[0]);
#ifdef AVI_AD_BODY  // the dense and kWide instances only: the body runs alone
  if (group != avi::mf::kDense && (group != avi::mf::kWide || avi::ad::kStage > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto wide = fused_chains_wide_kernel;
#else
  if (group == avi::mf::kGauss) {  // G chains a block of its own layout, any d
    if (G == 1) {
      cudaError_t err = cudaFuncSetAttribute(
          fused_chains_gauss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      fused_chains_gauss_kernel<<<n_chains, kThreads, smem, stream>>>(
          c0, c1, s0, state_in, state_out, elbo_out, trace, noise, n_chains, n, d, n_rows, steps,
          log_every, seeds, it0, lrs, rules, h, br);
    } else {
      const auto gk = fused_chains_g_kernel<true, avi::mf::kGauss>;
      cudaError_t err = cudaFuncSetAttribute(gk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      gk<<<(n_chains + G - 1) / G, kThreads, smem, stream>>>(
          model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise,
          n_chains, G, n, d, n_rows, steps, log_every, seeds, it0, lrs, rules, h, br);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const auto wide = group == avi::mf::kWide  ? fused_chains_wide_kernel
                    : group == avi::mf::kMvn ? fused_chains_mvn_kernel
                                             : fused_chains_mb_wide_kernel;
#endif
  if (G == 1 && (group == avi::mf::kWide || group == avi::mf::kMbWide || group == avi::mf::kMvn)) {
    cudaError_t err = cudaFuncSetAttribute(wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    wide<<<n_chains, kThreads, smem, stream>>>(model, c0, c1, n_data, db, batch, s0, s1,
                                               state_in, state_out, elbo_out, trace, noise, n,
                                               d, n_rows, steps, log_every, seeds, it0, lrs,
                                               rules, h, br, ws, lay[2]);
    return static_cast<int>(cudaGetLastError());
  }
#ifdef AVI_AD_BODY
  const auto kernel = kernel_for<avi::mf::kDense>(def);
#else
  using avi::mf::kDensePlain;
  using avi::mf::kMinibatch;
  using avi::mf::kWide;
  if (G > 1) {
    // kMvn's G-chain blocks run the dense Gaussian, with no workspace
    if (group == kDensePlain || group == avi::mf::kMbWide || group == kWide)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto gk = group == kMinibatch      ? g_kernel_for<kMinibatch>(def)
                    : group == avi::mf::kMvn ? fused_chains_g_kernel<true, avi::mf::kMvn>
                                             : g_kernel_for<avi::mf::kDense>(def);
    cudaError_t err = cudaFuncSetAttribute(gk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gk<<<(n_chains + G - 1) / G, kThreads, smem, stream>>>(
        model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise,
        n_chains, G, n, d, n_rows, steps, log_every, seeds, it0, lrs, rules, h, br);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = group == kMinibatch    ? kernel_for<kMinibatch>(def)
                      : group == kDensePlain ? kernel_for<kDensePlain>(def)
                                             : kernel_for<avi::mf::kDense>(def);
#endif
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_chains, kThreads, smem, stream>>>(
      model, c0, c1, n_data, db, batch, s0, s1, state_in, state_out, elbo_out, trace, noise, n,
      d, n_rows, steps, log_every, seeds, it0, lrs, rules, h, br);
  return static_cast<int>(cudaGetLastError());
}
