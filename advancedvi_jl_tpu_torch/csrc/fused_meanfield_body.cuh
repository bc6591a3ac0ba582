// The mean-field whole-loop body: one thread block runs a whole chunk of
// steps on one chain's state (csrc/fused_advi_meanfield.cu describes the
// phases A-E of a step and the design).  Two kernels instantiate it:
// fused_advi_meanfield.cu (one block, one chain) and fused_chains.cu (K6,
// one block per chain while the chains do not outnumber the SMs), so both
// run the same code, and chain c of the chains kernel equals the
// single-chain kernel keyed by chain c's seed words, bit for bit (K6's
// instances with several chains a block run the same phases and sums on
// stacked rows, fused_chains.cu, and keep that promise).  Each kernel
// hands the body its block's pointers and constants; the body is a
// forced-inline device function, so the single-chain kernel compiles to
// what it was before the body moved here.
// A launch of the kWide or kMbWide group (wide_layout, mb_layout below)
// keeps only the state rows, the row sums and the block reduction in shared
// memory where the rest does not fit, and reads the others through `ws`, its
// block's device workspace.  The diagonal Gaussian runs none of this: its
// kGauss group is csrc/fused_gauss_body.cuh, one column-fused pass a step.
// Built with AVI_AD_BODY, the model phase also takes K5's generated body
// (model kAD, c0 and c1 its packed float and int constants in device memory,
// its scratch after the layout's other arrays, then its float constants
// staged in shared memory where the host found that they fit, ad_program;
// on the kWide group the constants stay in device memory and the scratch
// takes the logits' tier); every line of it is under that macro, so the
// other libraries compile as without it.
//
// Built with AVI_PHASE_CLOCKS (fused_run_chunk_cuda(..., instrumented=True),
// read by meanfield_phase_cycles in ops/cuda/fused_advi.py, and K6's
// chains_phase_cycles in ops/cuda/fused_chains.py), thread 0 of block 0 adds
// the SM cycles of each phase of a step into avi_mf_phase_cycles: 0 the
// draws and z; 1 the row sums (|u|^2, logreg's |beta|^2, log det); 2 the
// logits (K5: its body up to the barrier after log pi); 3 log pi (K5: the
// rest of its body, the gradient); 4 the gradient (VarGrad: its
// coefficients); 5 the
// step's gradient, the rule, the operator and the averaging (thread 0's
// share); 6 the wait at the step's last barrier, where the ELBO thread
// finishes.  The build without the macro is untouched.
#pragma once

#include "fused_common.cuh"
#include "philox.cuh"

namespace avi {
namespace mf {


constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// The thread of the ELBO (and of VarGrad's coefficients): in the last warp,
// so that it runs beside phase D's lanes (threads 0..d-1) instead of after.
constexpr int kElbo = kThreads - 32;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block
using avi::kLog2Pi;

#ifdef AVI_PHASE_CLOCKS
constexpr int kPhases = 7;
__device__ unsigned long long avi_mf_phase_cycles[kPhases];
// thread 0 of block 0: the cycles since the last mark into phase i
#define AVI_MF_PHASE(i)                                                                \
  do {                                                                                 \
    if (tid == 0 && blockIdx.x == 0) {                                                 \
      const long long t_now = clock64();                                               \
      atomicAdd(&avi::mf::avi_mf_phase_cycles[i],                                      \
                static_cast<unsigned long long>(t_now - t_prev));                      \
      t_prev = t_now;                                                                  \
    }                                                                                  \
  } while (0)
#else
#define AVI_MF_PHASE(i) \
  do {                  \
  } while (0)
#endif

// Offsets (in floats) of the shared-memory arrays.
struct Layout {
  int X, y, l, zb, u, z, g, st, grad, row, red, total;
  int ldl, ldz;  // row strides of l and zb (logreg)
#ifdef AVI_AD_BODY
  int ad, adc;  // K5's scratch and its staged float constants
#endif
};

// n_data is the design's rows; a minibatch model keeps one B-row slab (the
// staged transports) and yX[k] in `y`.  With `aligned`, logreg pads the
// logits' rows to whole float4s and copies the betas to zb (rows of
// round4(db) floats) for block_mm's float4 loads; with kMbCopy the
// minibatch logreg copies them too (its logits' rows are B floats, B a
// multiple of 8).  The kernels' dense instances take kMbCopy false, which
// leaves their layout code as it was before the minibatch copy existed
// (any change there moved ptxas's register allocation of the whole step:
// the flagship chunk ran 2.8% slower on an H100).
template <bool kMbCopy = true>
__host__ __device__ inline Layout layout_for(int model, int n_data, int db, int batch, int n,
                                             int d, int n_rows, bool aligned) {
  Layout L;
  int o = 0;
  const bool lr = model == avi::kLogReg;
  const bool mb = avi::is_minibatch(model);
  const bool al = lr && aligned;
  const bool copy = al || (kMbCopy && mb);  // the betas go to zb
  L.ldl = al ? avi::round4(n_data) : (lr ? n_data : batch);
  L.ldz = copy ? avi::round4(db) : 0;
  L.X = o;    o += lr ? n_data * db : (avi::slab_staged(model) ? batch * db : 0);
  L.y = o;    o += lr ? n_data : (mb ? db : 0);  // labels, or yX[k]
  if (copy) o = avi::round4(o);           // l and zb: rows read as float4s
  L.l = o;    o += lr || mb ? n * L.ldl : 0;  // logits, then weights
  L.zb = o;   o += n * L.ldz;             // logreg: the samples' beta lanes
  L.u = o;    o += n * d;                 // base draws
  L.z = o;    o += n * d;                 // samples
  L.g = o;    o += n * d;                 // grad log pi
  L.st = o;   o += n_rows * d;            // mu sig m_mu v_mu m_sig v_sig avg_mu avg_sig [ext]
  L.grad = o; o += 2 * d;                 // dmu, dsig of the step
  L.row = o;  o += 7 * n + 1;             // beta_sq t inv_sig2 logpi u2 c ylogit, logdet
  L.red = o;  o += 2 * kWarps + 1;        // block reduction, then eta
#ifdef AVI_AD_BODY
  if (model == avi::kAD) o = avi::round4(o);
  L.ad = o;   o += model == avi::kAD ? avi::ad::kScratch : 0;  // the generated body's
  if (model == avi::kAD) o = avi::round4(o);
  L.adc = o;  o += model == avi::kAD ? avi::ad::kStage : 0;    // its staged constants
#endif
  L.total = o;
  return L;
}

// The model groups a kernel is instantiated for (kGroup): the dense data
// models (logreg with the aligned layout; the diagonal Gaussian's body stays
// compiled in, though kGauss now takes that model, so that their code is as
// before), logreg with the plain layout (no zb, no padding: a design whose
// aligned layout would not fit one block, as every design that fitted
// before block_mm still fits), the minibatch logreg's three transports, or
// kWide: logreg and K5's body where the plain layout does not fit one
// block, on wide_layout; or kMbWide: the minibatch logreg whose layout does
// not fit one block, on mb_layout.  Each instance compiles its group's
// bodies alone, so ptxas allocates its registers for them alone; a library
// built with a generated body runs that body alone (its C entry takes no
// other model).  kMvn: the dense Gaussian (mvnormal) alone, on mvn_layout;
// its own instances, so that kWide's keep their code.  kGauss: the
// diagonal Gaussian alone (csrc/fused_gauss_body.cuh: no u, z or g arrays,
// so it needs no tiers and no workspace at any width).
enum ModelGroup {
  kDense = 0, kMinibatch = 1, kDensePlain = 2, kWide = 3, kMbWide = 4, kMvn = 5, kGauss = 6
};

// The layout of a kWide launch.  The state rows, the step's gradient, the
// row sums and the block reduction stay in shared memory (layout_for's);
// what does not fit beside them leaves shared memory in this order, the
// tier: 1 the model's data, read where it lies in device memory (logreg's X
// and y; kMvn's mvn_layout reads mvnormal's P there); 2 also the logits,
// into the launch's device workspace; 3 also u, z and g.  Logreg takes the
// plain layout's strides (ldl = n_data, no zb), so every sum runs in the
// kDensePlain order.  K5's body (AVI_AD_BODY) reads its float constants in
// device memory at every tier (tier 1: the unstaged program, ad_program),
// and its scratch takes the logits' place: in the workspace from tier 2, at
// a 16-byte offset (its products' float4 loads), the workspace a whole
// number of float4s (each chain's slice stays aligned).  L.l, L.u, L.z and
// L.g (and L.ad) are offsets into shared memory or, from their tier on, into
// the block's workspace of `ws` floats.
struct WideLayout {
  Layout L;
  int tier, smem, ws;  // smem, ws: floats of shared memory and of workspace
};

__host__ __device__ inline WideLayout wide_layout_at(int model, int n_data, int n, int d,
                                                     int n_rows, int tier) {
  WideLayout W;
  Layout& L = W.L;
  int o = 0, w = 0;
  const bool lr = model == avi::kLogReg;
  L.X = L.y = L.zb = L.ldz = 0;
  L.ldl = lr ? n_data : 0;
  int& ol = tier >= 2 ? w : o;
  L.l = ol;   ol += lr ? n * n_data : 0;
#ifdef AVI_AD_BODY
  if (model == avi::kAD) {  // K5's scratch in the logits' tier
    ol = avi::round4(ol);
    L.ad = ol;  ol += avi::ad::kScratch;
    ol = avi::round4(ol);
    L.adc = 0;  // nothing staged: kStage is 0 on this group
  }
#endif
  int& od = tier >= 3 ? w : o;
  L.u = od;   od += n * d;
  L.z = od;   od += n * d;
  L.g = od;   od += n * d;
  L.st = o;   o += n_rows * d;
  L.grad = o; o += 2 * d;
  L.row = o;  o += 7 * n + 1;
  L.red = o;  o += 2 * kWarps + 1;
  L.total = o;
  W.tier = tier;
  W.smem = o;
  W.ws = w;
#ifdef AVI_AD_BODY
  if (model == avi::kAD) W.ws = avi::round4(w);
#endif
  return W;
}

// The least tier whose shared part fits one block (tier 3 if none does: the
// host refuses that launch).
__host__ __device__ inline WideLayout wide_layout(int model, int n_data, int n, int d,
                                                  int n_rows) {
  WideLayout W;
  for (int tier = 1; tier <= 3; ++tier) {
    W = wide_layout_at(model, n_data, n, d, n_rows, tier);
    if (sizeof(float) * static_cast<size_t>(W.smem) <= kSmemLimit) break;
  }
  return W;
}

// The layout of a kMvn launch: wide_layout_at's arrays for the model (the
// state rows, the step's gradient, the row sums and the block reduction in
// shared memory; u, z and g there too, or from tier 3 in the device
// workspace), then the product's place (mvnormal_product.cuh stream_at):
// at tier 0 P staged in shared memory, from tier 1 the ring that streams
// it from device memory; each with the panel of diff's rows.  Tier 2 moves
// nothing of this model, so the tiers are 0, 1 and 3; tiers 0 and 1 take
// the product's whole plan (a ring cut to fit there would cost a barrier
// every few rows of P), tier 3 cuts it to fit (3 if nothing fits: the host
// refuses that launch).
struct MvnLayout {
  WideLayout W;
  avi::mvn::Stream S;
};

__host__ __device__ inline MvnLayout mvn_layout(int n, int d, int n_rows) {
  MvnLayout V;
  for (int tier = 0; tier <= 3; tier += tier == 1 ? 2 : 1) {
    V.W = wide_layout_at(avi::kMvNormal, 0, n, d, n_rows, tier == 0 ? 1 : tier);
    V.W.tier = tier;
    V.S = avi::mvn::stream_at<kThreads>(V.W.smem, n, d, tier == 0,
                                         static_cast<int>(kSmemLimit / sizeof(float)), tier == 3);
    V.W.smem = V.S.end;
    V.W.L.total = V.S.end;
    if (sizeof(float) * static_cast<size_t>(V.S.end) <= kSmemLimit) break;
  }
  return V;
}

// The layout of a kMbWide launch: the minibatch logreg (layout_for's
// arrays, the aligned beta copy zb included) where its layout does not fit
// one block.  The state rows, the step's gradient, yX[k], the row sums and
// the block reduction stay in shared memory; the rest leaves it in this
// order, the tier: 1 the (n, B) logits, into the launch's device workspace;
// 2 also the staged transports' slab, which the step then reads where it
// lies in the permuted design, as the in-place transport does (the
// prefetching one still pulls the next slab into L2); 3 also zb, u, z and
// g, into the workspace.  Every product keeps its k order and its tiles
// (block_mm's float4 loads of zb and of the logits' rows: every workspace
// offset is a whole number of float4s, and so is the workspace, so each
// chain's slice stays aligned).
__host__ __device__ inline WideLayout mb_layout_at(int model, int n_data, int db, int batch,
                                                   int n, int d, int n_rows, int tier) {
  WideLayout W;
  Layout& L = W.L;
  int o = 0, w = 0;
  (void)n_data;
  L.ldl = batch;
  L.ldz = avi::round4(db);
  L.X = o;    o += tier < 2 && avi::slab_staged(model) ? batch * db : 0;
  L.y = o;    o += db;  // yX[k]
  o = avi::round4(o);
  int& ol = tier >= 1 ? w : o;
  L.l = ol;   ol += n * batch;  // B a multiple of 8: the rows stay aligned
  int& od = tier >= 3 ? w : o;
  L.zb = od;  od += n * L.ldz;
  L.u = od;   od += n * d;
  L.z = od;   od += n * d;
  L.g = od;   od += n * d;
  L.st = o;   o += n_rows * d;
  L.grad = o; o += 2 * d;
  L.row = o;  o += 7 * n + 1;
  L.red = o;  o += 2 * kWarps + 1;
  L.total = o;
  W.tier = tier;
  W.smem = o;
  W.ws = avi::round4(w);
  return W;
}

// The least tier whose shared part fits one block (tier 3 if none does: the
// host refuses that launch).
__host__ __device__ inline WideLayout mb_layout(int model, int n_data, int db, int batch, int n,
                                                int d, int n_rows) {
  WideLayout W;
  for (int tier = 1; tier <= 3; ++tier) {
    W = mb_layout_at(model, n_data, db, batch, n, d, n_rows, tier);
    if (sizeof(float) * static_cast<size_t>(W.smem) <= kSmemLimit) break;
  }
  return W;
}

__host__ __device__ inline int model_group(int model, int n_data, int db, int batch, int n,
                                           int d, int n_rows) {
  if (avi::is_minibatch(model)) {
    const Layout L = layout_for(model, n_data, db, batch, n, d, n_rows, true);
    return sizeof(float) * static_cast<size_t>(L.total) <= kSmemLimit ? kMinibatch : kMbWide;
  }
  if (model == avi::kMvNormal) return kMvn;
  if (model == avi::kGaussian) return kGauss;
  const Layout L = layout_for(model, n_data, db, batch, n, d, n_rows, true);
  if (sizeof(float) * static_cast<size_t>(L.total) <= kSmemLimit) return kDense;
  const Layout P = layout_for(model, n_data, db, batch, n, d, n_rows, false);
  return sizeof(float) * static_cast<size_t>(P.total) <= kSmemLimit ? kDensePlain : kWide;
}

// The layout of a launch with every array in shared memory: the aligned one
// where it fits one block, else the plain one (its size beyond the limit
// sends the launch to kWide; a minibatch model's, to kMbWide).
__host__ __device__ inline Layout make_layout(int model, int n_data, int db, int batch,
                                              int n, int d, int n_rows) {
  const int group = model_group(model, n_data, db, batch, n, d, n_rows);
  const bool aligned = group != kDensePlain && group != kWide;
  return layout_for(model, n_data, db, batch, n, d, n_rows, aligned);
}

}  // namespace mf

// The layout of the kGauss group's launches (its body is
// csrc/fused_gauss_body.cuh), here so that launch_layout can answer for it.
namespace gauss {

using mf::kThreads;

// One chain's step split over threads, a rule of (n, d): `groups` 4-column
// groups, `width` lanes a column slice (the power of two at or above
// groups, at most 32), `slices` column slices of a row, and R row blocks
// of `rows` rows (row block r: rows r rows .. r rows + rows - 1) so that the
// R slices x width threads of a chain's row blocks fill at most one block.
struct Split {
  int groups, width, slices, lanes, R, rows;
};

__host__ __device__ inline Split split_for(int n, int d) {
  Split S;
  S.groups = (d + 3) / 4;
  S.width = 1;
  while (S.width < S.groups && S.width < 32) S.width *= 2;
  S.slices = (S.groups + S.width - 1) / S.width;
  S.lanes = S.slices * S.width;
  int blocks = kThreads / S.lanes;
  if (blocks > n) blocks = n;
  if (blocks < 1) blocks = 1;
  S.rows = (n + blocks - 1) / blocks;
  S.R = (n + S.rows - 1) / S.rows;  // every block holds a row
  return S;
}

// Offsets (in floats) of a block of G chains' shared-memory arrays, each
// chain's part at c times its size: the state rows (8, or 14 with COCOB);
// the row blocks' dmu and dsig (2 R rows of d); each row's slices' log pi
// and |u|^2 partials (lpp, uup: n x slices each); the slices' log det
// partials; VarGrad's coefficients; DoWG's and DoG's 32-column partials
// (wpc of |g|^2, then wpc of |x - x0|^2 a chain), their eta; the chains'
// learning rates, rule codes and seed words.
struct Layout {
  Split S;
  int wpc;
  int st, part, lpp, uup, ldp, coef, distp, eta, lr, algo, seed, total;
};

__host__ __device__ inline Layout layout_for(int n, int d, int n_rows, int G) {
  Layout L;
  L.S = split_for(n, d);
  L.wpc = (d + 31) / 32;
  int o = 0;
  L.st = o;    o += G * n_rows * d;
  L.part = o;  o += G * 2 * L.S.R * d;
  L.lpp = o;   o += G * n * L.S.slices;
  L.uup = o;   o += G * n * L.S.slices;
  L.ldp = o;   o += G * L.S.slices;
  L.coef = o;  o += G * n;
  L.distp = o; o += G * 2 * L.wpc;
  L.eta = o;   o += G;
  L.lr = o;    o += G;
  L.algo = o;  o += G;
  L.seed = o;  o += 2 * G;
  L.total = o;
  return L;
}

__host__ __device__ inline size_t smem_bytes(int n, int d, int n_rows, int G) {
  return sizeof(float) * static_cast<size_t>(layout_for(n, d, n_rows, G).total);
}

}  // namespace gauss

namespace mf {

// What a launch takes (the C entries' layout queries): out[0] its group,
// out[1] the bytes of dynamic shared memory, out[2] the floats of device
// workspace one block needs (0 but for kWide and kMvn at tier 2 or 3 and
// kMbWide), out[3] the kWide, kMbWide or kMvn tier (-1 in the other groups).
// kGauss: gauss::layout_for's bytes at one chain, no workspace, tier -1.
__host__ __device__ inline void launch_layout(int model, int n_data, int db, int batch, int n,
                                              int d, int n_rows, long long* out) {
  const int group = model_group(model, n_data, db, batch, n, d, n_rows);
  out[0] = group;
  if (group == kWide || group == kMbWide || group == kMvn) {
    const WideLayout W = group == kWide  ? wide_layout(model, n_data, n, d, n_rows)
                         : group == kMvn ? mvn_layout(n, d, n_rows).W
                                         : mb_layout(model, n_data, db, batch, n, d, n_rows);
    out[1] = static_cast<long long>(sizeof(float)) * W.smem;
    out[2] = W.ws;
    out[3] = W.tier;
  } else if (group == kGauss) {
    out[1] = static_cast<long long>(gauss::smem_bytes(n, d, n_rows, 1));
    out[2] = 0;
    out[3] = -1;
  } else {
    out[1] = static_cast<long long>(sizeof(float)) *
             make_layout(model, n_data, db, batch, n, d, n_rows).total;
    out[2] = 0;
    out[3] = -1;
  }
}

template <bool kGeneral, int kGroup>
__device__ __forceinline__ void run_chunk(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data,
    int db, int batch, float s0, float s1, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, int n, int d, int n_rows, int steps, int log_every,
    uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h, avi::Branch br,
    float* __restrict__ ws = nullptr) {
  if (!kGeneral) br = avi::kDefaultBranch;  // every switch below is then constant
#ifdef AVI_AD_BODY
  model = avi::kAD;  // every other model's code drops out of this library
#endif
  if (kGroup == kMvn) model = avi::kMvNormal;  // likewise in the dense Gaussian's instances
  extern __shared__ float smem[];
  // the host picked the group by its fit; kWide and kMvn take the plain strides
  constexpr bool kMv = kGroup == kMvn;
  constexpr bool kAligned = kGroup != kDensePlain && kGroup != kWide && !kMv;
  constexpr bool kMb = kGroup == kMinibatch || kGroup == kMbWide;
  const MvnLayout V = kMv ? mvn_layout(n, d, n_rows) : MvnLayout();
  const WideLayout W = kGroup == kWide     ? wide_layout(model, n_data, n, d, n_rows)
                       : kGroup == kMbWide ? mb_layout(model, n_data, db, batch, n, d, n_rows)
                       : kMv               ? V.W
                                           : WideLayout();
  const Layout L = kGroup == kWide || kGroup == kMbWide || kMv
                       ? W.L
                       : layout_for<kGroup == kMinibatch>(model, n_data, db, batch, n, d, n_rows,
                                                          kAligned);
  const bool logreg = !kMb && model == avi::kLogReg;
  const bool minibatch = kMb && avi::is_minibatch(model);
  // kWide: the model's data in device memory from tier 1, the logits (K5:
  // its scratch) in the workspace from tier 2, u, z and g from tier 3;
  // kMbWide: the logits from tier 1, the slab read in place from tier 2,
  // zb, u, z and g from tier 3
  const bool data_dev = (kGroup == kWide || kMv) && W.tier >= 1;
  const bool slab_dev = kGroup == kMbWide && W.tier >= 2;
  float* const lbase =
      (kGroup == kWide && W.tier >= 2) || (kGroup == kMbWide && W.tier >= 1) ? ws : smem;
  float* const dbase = (kGroup == kWide || kGroup == kMbWide || kMv) && W.tier >= 3 ? ws : smem;
  float* us = dbase + L.u;
  float* zs = dbase + L.z;
  float* gs = dbase + L.g;
  float* st = smem + L.st;
  float* mu = st;
  float* sig = st + d;
  float* m_mu = st + 2 * d;
  float* v_mu = st + 3 * d;
  float* m_sig = st + 4 * d;
  float* v_sig = st + 5 * d;
  float* a_mu = st + 6 * d;
  float* a_sig = st + 7 * d;
  float* ext = st + 8 * d;  // COCOB: G, reward, theta of mu, then of sig
  float* dm = smem + L.grad;
  float* ds = dm + d;
  float* beta_sq = smem + L.row;
  float* tcol = beta_sq + n;
  float* inv_sig2 = tcol + n;
  float* logpi = inv_sig2 + n;
  float* u2 = logpi + n;
  float* coef = u2 + n;
  float* ylogit = coef + n;
  float* logdet = ylogit + n;
  float* red = smem + L.red;
  float* eta_s = red + 2 * kWarps;
  const avi::LogReg lrm{data_dev ? c0 : smem + L.X, data_dev ? c1 : smem + L.y, lbase + L.l,
                        smem + L.zb, n_data, db, L.ldl, L.ldz, s0, s1};
  float* zb = (kGroup == kMbWide ? dbase : smem) + L.zb;
  const int ldz = L.ldz;
  avi::LogRegMB mbm{nullptr, smem + L.y, (kGroup == kMbWide ? lbase : smem) + L.l, zb, batch,
                    db, ldz, s0, s1};
  const int nb = minibatch ? n_data / batch : 1;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (logreg && !data_dev) {
    for (int i = tid; i < n_data * db; i += kThreads) smem[L.X + i] = c0[i];
    for (int i = tid; i < n_data; i += kThreads) smem[L.y + i] = c1[i];
  }
  uint32_t fill = 0;  // kMvn: the ring's blocks of P read so far
  if (kMv) avi::mvn::stage_or_start<kThreads>(V.S, smem, c1, d, tid);
  for (int i = tid; i < n_rows * d; i += kThreads) st[i] = state_in[i];
#ifdef AVI_AD_BODY
  if (model == avi::kAD && kGroup != kWide) avi::ad::ad_stage(c0, smem + L.adc, tid);
#endif
  __syncthreads();

  const bool vargrad = br.grad_est == avi::kScoreGrad;
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
  float elbo = 0.0f;
#ifdef AVI_PHASE_CLOCKS
  long long t_prev = clock64();
#endif

  for (int s = 0; s < steps; ++s) {
    const unsigned long long it = it0 + static_cast<unsigned long long>(s);
    // the minibatch slab of this step starts on its way (staged transports)
    if (minibatch)
      mbm.X = slab_dev ? avi::minibatch_step_in_place(model, c0, c1, batch, db, nb, it,
                                                      smem + L.y, tid, kThreads)
                       : avi::minibatch_step_begin(model, c0, c1, batch, db, nb, it,
                                                   smem + L.X, smem + L.y, tid, kThreads);

    // A: base draws and z = mu + sig * u (two roundings, as the plain version)
    if (noise != nullptr) {
      const float* src = noise + static_cast<size_t>(s) * n * d;
      for (int idx = tid; idx < n * d; idx += kThreads) {
        const int j = idx % d;
        const float uv = src[idx];
        us[idx] = uv;
        const float zv = __fadd_rn(mu[j], __fmul_rn(sig[j], uv));
        zs[idx] = zv;
        if (kAligned && (logreg || minibatch) && j < db) zb[(idx / d) * ldz + j] = zv;
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
            const float zv = __fadd_rn(mu[j], __fmul_rn(sig[j], w[p]));
            zs[i * d + j] = zv;
            if (kAligned && (logreg || minibatch) && j < db) zb[i * ldz + j] = zv;
          }
        }
      }
    }
    __syncthreads();
    AVI_MF_PHASE(0);
    if (logreg) avi::logreg_rows(lrm, zs, n, d, beta_sq, tcol, inv_sig2, warp, kWarps, lane);
    if (minibatch)
      avi::logreg_mb_rows(mbm, zs, n, d, beta_sq, tcol, inv_sig2, ylogit, warp, kWarps, lane);
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
    if (avi::slab_staged(model)) avi::cp_async_wait_all();  // this thread's copies landed
    __syncthreads();
    AVI_MF_PHASE(1);

    // B: log pi (and the Gaussian's gradient)
    if (logreg) {
      avi::logreg_logits<kThreads, kAligned>(lrm, zs, n, d, tid);
      __syncthreads();
      AVI_MF_PHASE(2);
      avi::logreg_logpi(lrm, n, beta_sq, tcol, inv_sig2, logpi, warp, kWarps, lane);
    } else if (minibatch) {
      avi::logreg_mb_logits<kThreads>(mbm, n, tid);
      __syncthreads();
      AVI_MF_PHASE(2);
      avi::logreg_mb_logpi(mbm, n, beta_sq, tcol, inv_sig2, ylogit, logpi, warp, kWarps, lane);
#ifdef AVI_AD_BODY
    } else if (model == avi::kAD) {  // K5: log pi and its gradient (VarGrad ignores gs)
      long long t_logpi = 0;
      avi::ad::ad_body(c0, reinterpret_cast<const int*>(c1), smem + L.adc, zs, n, d, logpi, gs,
                       (kGroup == kWide ? lbase : smem) + L.ad, tid, &t_logpi);
#ifdef AVI_PHASE_CLOCKS
      if (tid == 0) {  // the body's mark after log pi: phase 2 up to it, 3 the rest
        atomicAdd(&avi_mf_phase_cycles[2], static_cast<unsigned long long>(t_logpi - t_prev));
        t_prev = t_logpi;
      }
#endif
#endif
    } else if (kMv) {  // VarGrad ignores gs
      avi::mvnormal_stream_body<kThreads>(c0, c1, V.S, smem, fill, s0, zs, n, d, logpi, gs, tid,
                                          warp, kWarps, lane);
    } else if (!kMb && kGroup != kWide) {  // kWide takes no Gaussian: kGauss has it
      avi::gaussian_body(c0, c1, s0, zs, n, d, logpi, vargrad ? nullptr : gs, warp, kWarps,
                         lane);
    }
    __syncthreads();
    AVI_MF_PHASE(3);

    // C: logreg's grad log pi, or VarGrad's coefficients and ELBO
    if (vargrad) {
      if (tid == kElbo) {
        float fsum = 0.0f, esum = 0.0f;
        for (int i = 0; i < n; ++i) {
          const float logq = -(0.5f * u2[i] + *logdet + ent_const);
          const float f = logq - logpi[i];
          coef[i] = f;
          fsum += f;
          esum += logpi[i] - logq;
        }
        const float fbar = inv_n * fsum;
        for (int i = 0; i < n; ++i) coef[i] = (coef[i] - fbar) * inv_n;
        elbo = inv_n * esum;
      }
      __syncthreads();
      AVI_MF_PHASE(4);
    } else if (logreg) {
      avi::logreg_grad<kThreads, kAligned>(lrm, zs, n, d, beta_sq, tcol, inv_sig2, gs, tid);
      __syncthreads();
      AVI_MF_PHASE(4);
    } else if (minibatch) {
      avi::logreg_mb_grad<kThreads>(mbm, zs, n, d, beta_sq, tcol, inv_sig2, gs, tid);
      __syncthreads();
      AVI_MF_PHASE(4);
    }

    // D: the gradient of the step, then (DoWG, DoG) its global sums
    float part_g = 0.0f, part_x = 0.0f;
    for (int j = tid; j < d; j += kThreads) {
      const float sj = sig[j];
      float dmu = 0.0f, dsig = 0.0f;
      if (vargrad) {
        for (int i = 0; i < n; ++i) {
          const float uij = us[i * d + j];
          dmu += coef[i] * (uij / sj);
          dsig += coef[i] * ((uij * uij - 1.0f) / sj);
        }
      } else {
        for (int i = 0; i < n; ++i) {
          const float uij = us[i * d + j];
          const float gz =
              -inv_n * (cf_zero ? gs[i * d + j] : gs[i * d + j] + uij / sj);
          dmu += gz;
          dsig += gz * uij;
        }
        if (stl_zero) dsig += 1.0f / sj;
      }
      dm[j] = dmu;
      ds[j] = dsig;
      if (dist_rule) {
        const float xm = mu[j] - m_mu[j];
        const float xs = sj - m_sig[j];
        part_g += dmu * dmu + dsig * dsig;
        part_x += xm * xm + xs * xs;
      }
    }
    if (dist_rule) {  // the other rules need no barrier: a thread reads back its own lanes
      const float2 tot = avi::block_sum2(part_g, part_x, red, kWarps);
      if (tid == 0) *eta_s = avi::distance_rule_step(br.algo, tot.x, tot.y, v_mu[0], v_mu[1]);
      __syncthreads();
    }

    // D: the rule, the operator and the averaging, one thread per lane
    const float c = static_cast<float>(it) + 1.0f;
    const float bc1 = 1.0f - expf(c * ln_b1);
    const float bc2 = 1.0f - expf(c * ln_b2);
    const float w = (h.avg_eta + 1.0f) / (c + h.avg_eta);
    const float eta = br.algo == avi::kDescent ? h.lr : (dist_rule ? *eta_s : 0.0f);
    for (int j = tid; j < d; j += kThreads) {
      float G = 0.0f, R = 0.0f, T = 0.0f;
      if (cocob) {
        G = ext[j];
        R = ext[d + j];
        T = ext[2 * d + j];
      }
      avi::rule_step(br, h, eta, bc1, bc2, mu[j], m_mu[j], v_mu[j], G, R, T, dm[j]);
      if (cocob) {
        ext[j] = G;
        ext[d + j] = R;
        ext[2 * d + j] = T;
        G = ext[3 * d + j];
        R = ext[4 * d + j];
        T = ext[5 * d + j];
      }
      float x = sig[j];
      avi::rule_step(br, h, eta, bc1, bc2, x, m_sig[j], v_sig[j], G, R, T, ds[j]);
      if (cocob) {
        ext[3 * d + j] = G;
        ext[4 * d + j] = R;
        ext[5 * d + j] = T;
      }
      x = avi::scale_operator(br.op, x, eta, h);
      sig[j] = x;
      if (dist_rule && j >= 2) v_mu[j] = 0.0f;  // v_mu holds [v, r, 0, ...]
      a_mu[j] = (1.0f - w) * a_mu[j] + w * mu[j];
      a_sig[j] = (1.0f - w) * a_sig[j] + w * x;
    }

    // E: the step's ELBO estimate, energy + entropy value
    if (tid == kElbo) {
      if (!vargrad) {
        float energy = 0.0f, uu = 0.0f;
        for (int i = 0; i < n; ++i) {
          energy += logpi[i];
          uu += u2[i];
        }
        elbo = inv_n * energy +
               (cf_zero ? *logdet + ent_closed : *logdet + inv_n * (0.5f * uu) + ent_const);
      }
      if (log_every > 0 && (s + 1) % log_every == 0)
        trace[(s + 1) / log_every - 1] = elbo;
    }
    AVI_MF_PHASE(5);
    __syncthreads();
    AVI_MF_PHASE(6);
  }

  for (int i = tid; i < n_rows * d; i += kThreads) state_out[i] = st[i];
  if (tid == kElbo) *elbo_out = elbo;
  if (kMv) avi::mvn::drain(V.S, smem, fill, tid);
}

}  // namespace mf
}  // namespace avi
