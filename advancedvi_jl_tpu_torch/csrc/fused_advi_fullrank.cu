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
// traffic a step, which one SM's 16 warps cannot hide the latency of.
// So two kernels: fused_advi_fullrank_kernel, one block, and
// fused_advi_fullrank_cluster_kernel, one chunk on a thread-block cluster
// of up to 16 blocks (one a whitening panel, ops/cuda/fused_advi.py
// cluster_blocks), split by output so that its bits are the single-block
// kernel's at every cluster size (its design below, before the kernel).
// The cluster takes the full-data models with Adam, descent and COCOB;
// DoWG and DoG, the minibatch models and K5 run on one block.
//
// Design of the single-block kernel: one thread block runs the whole
// chunk, a loop over steps inside the block.  The draws u, the samples z, grad log pi and the whitened
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
// left in shared).  A launch whose per-step arrays do not fit even with
// both in device memory runs fused_advi_fullrank_tier_kernel, the same
// body on a tiered layout (tier_layout): the model's data, then the logits
// (K5: its scratch), then u, z, g and w leave shared memory in that order
// for device memory, the last two into a workspace the wrapper allocates;
// no sum changes its order.  The branch is a set of
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
#include <cooperative_groups.h>

#include "fused_common.cuh"
#include "philox.cuh"
#include "trisolve_rows.cuh"

namespace cg = cooperative_groups;

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

// The layout of a launch whose per-step arrays do not fit one block even
// with the scale matrices and the panel operators in device memory (place()
// put both there): the location rows, dmu, the row sums and the block
// reduction stay in shared memory; the rest leaves it in this order, the
// tier: 1 the model's data, read where it lies in device memory (logreg's X
// and y; the staged transports' slab, read in the permuted design as the
// in-place transport reads it, the prefetching one still pulling the next
// slab into L2; K5's float constants, its unstaged program); 2 also the
// logits (K5: its scratch, at a 16-byte offset), into the launch's device
// workspace; 3 also u, z, g and w.  L's offsets are into shared memory or,
// from their tier on, into the workspace of `ws` floats (a whole number of
// float4s).
struct TierLayout {
  Layout L;
  int tier, smem, ws;  // smem, ws: floats of shared memory and of workspace
};

__host__ __device__ inline TierLayout tier_layout_at(int model, int n_data, int db, int batch,
                                                     int n, int d, int k, int tier) {
  TierLayout T;
  Layout& L = T.L;
  int o = 0, w = 0;
  const bool lr = model == avi::kLogReg;
  const bool mb = avi::is_minibatch(model);
  const bool data = tier < 1;  // the model's data in shared memory
  L.X = o;   o += data ? (lr ? n_data * db : (avi::slab_staged(model) ? batch * db : 0)) : 0;
  L.y = o;   o += lr ? (data ? n_data : 0) : (mb ? db : 0);  // labels, or yX[k]
  int& ol = tier >= 2 ? w : o;
  L.l = ol;  ol += lr ? n * n_data : (mb ? n * batch : 0);
#ifdef AVI_AD_BODY
  if (model == avi::kAD) {  // K5's scratch in the logits' tier; nothing staged
    ol = avi::round4(ol);
    L.ad = ol; ol += avi::ad::kScratch;
    ol = avi::round4(ol);
    L.adc = 0;
  }
#endif
  int& od = tier >= 3 ? w : o;
  L.u = od;  od += n * d;
  L.z = od;  od += n * d;
  L.g = od;  od += n * d;
  L.w = od;  od += n * d;
  L.vec = o; o += k * d;
  L.dm = o;  o += d;
  L.row = o; o += 6 * n + 1;
  L.red = o; o += 2 * kWarps + 1;
  L.mat = L.inv = o;
  L.total = o;
  T.tier = tier;
  T.smem = o;
  T.ws = avi::round4(w);
  return T;
}

// The least tier whose shared part fits one block (tier 3 if none does: the
// host refuses that launch).
__host__ __device__ inline TierLayout tier_layout(int model, int n_data, int db, int batch,
                                                  int n, int d, int k) {
  TierLayout T;
  for (int tier = 1; tier <= 3; ++tier) {
    T = tier_layout_at(model, n_data, db, batch, n, d, k, tier);
    if (sizeof(float) * static_cast<size_t>(T.smem) <= kSmemLimit) break;
  }
  return T;
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
#define AVI_FR_TIERED 0
#include "fused_fullrank_body.cuh"
#undef AVI_FR_TIERED
}

// The tiered layout (tier_layout, tiers 1-3): the same body with the scale
// matrices and the panel operators in device memory and the per-step arrays
// from `tier` on in the workspace `work`.  Its own kernel, so the one above
// keeps its code; under 88 registers this one spilled, so ptxas takes the
// 128 one block an SM allows.
__global__ void __launch_bounds__(kThreads, 1) fused_advi_fullrank_tier_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1,
    int n_data, int db, int batch, float s0, float s1, const float* __restrict__ vec_in,
    const float* __restrict__ mat_in, float* __restrict__ vec_out, float* mat_out,
    float* __restrict__ elbo_out, float* __restrict__ trace,
    const float* __restrict__ noise, float* inv_dev, int n, int d, int k, int steps,
    int log_every, uint32_t k0, uint32_t k1, unsigned long long it0, avi::Hyper h,
    avi::Branch br, float* __restrict__ work, int tier) {
#define AVI_FR_TIERED 1
#include "fused_fullrank_body.cuh"
#undef AVI_FR_TIERED
}

#ifndef AVI_AD_BODY  // K5's libraries run the single-block kernel only
// ---------------------------------------------------------------------------
// The cluster kernel: one chunk on a thread-block cluster of cs blocks.
//
// The work splits by OUTPUT, so no sum changes its order and the result is
// the single-block kernel's, bit for bit, at every cluster size.  Block r
// owns the 32-row panels p of C with panel_owner(p, cs) == r (folded: p
// and np - 1 - p together, which balances the triangle's rows), and with
// them index a of every d-long axis for a in those panels: row a of C and
// of the other scale matrices, z[:, a], g[:, a], w[:, a] and mu[a].  The
// owner forms z[:, a] (phase A), g[:, a] (mvnormal: column a of P; logreg:
// feature a), solves its panels of the whitening and runs the rule on its
// rows (phase D).  Every block draws all of u (the draws are keyed by (it,
// i, group), so every copy is the same).  The logreg's logits split by
// data rows.  What a block needs of another's outputs it reads from that
// block's shared memory (DSMEM, map_shared_rank) after a cluster barrier:
//
//   S1      the samples' columns (z is gathered by every block) and the
//           scale's diagonal (rank 0's log det);
//   S2      logreg: the logits' data rows (every block then forms log pi
//           and the weights of all rows, as one block did); mvnormal:
//           rank 0 gathers g for log pi;
//   np      the whitening's backward panel walk: panel p's owner solves
//           W_p and stores it into every other block's wp (a DSMEM push,
//           so that no block fetches after the barrier); then every block
//           subtracts W_p C[p, c] from its unsolved columns c, with C's
//           entries from its strip (the rows below its panels at their
//           columns, staged once a step where it fits); the last barrier
//           ends the walk.
//
// The sums across the whole axis (log pi of the mvnormal, |u|^2, log det,
// the ELBO) run on rank 0 alone, in the single-block order.  The panels'
// diagonal-block operators are formed in phase A by warps of their own
// (the draws and z wait on a named barrier of the other warps).  Hazards:
// a buffer another block reads is next written only after a cluster
// barrier that the reader reaches after its reads: z and the diagonal
// copies alternate between two buffers by step parity (read at step s,
// written again at s + 2, with S1 of s + 1 between); the logits' rows are
// written after S1; g_z goes to w's own columns (phase D), so that g's
// columns stay as rank 0 read them; wp's panel p is pushed after S1 and
// read before the walk's next barrier; C's rows are rewritten only after
// the walk's last barrier.  The scale matrices' owned rows live in shared
// memory when they fit (d = 62: 32 rows x 4 matrices), else in the output
// buffer in device memory (L2); other blocks read C's rows through a
// generic pointer to either.  Bounds and times: PERF.md, kernel table.
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 16;  // 8 portable, 16 with the non-portable attribute
// Latency choices, timed against each other on an H100; none moves a bit: the mvnormal product splits a column over at most kPGroups
// groups of kPRows sample rows and issues kPLoads loads of P before their
// fmas; phase A issues kZLoads loads of a row of C a lane at once.
constexpr int kPRows = 3;
constexpr int kPGroups = 4;
constexpr int kPLoads = 32;
constexpr int kZLoads = 8;
constexpr int kGather = 8;       // DSMEM gathers: remote loads a thread issues at once

// Panel p's block: the folded assignment, p = m (2 cs) + q goes to q for
// q < cs, else to 2 cs - 1 - q.
__host__ __device__ inline int panel_owner(int p, int cs) {
  const int q = p % (2 * cs);
  return q < cs ? q : 2 * cs - 1 - q;
}

// Row a's place among its owner's rows (its panels in order, 32 rows each;
// only the last panel of C is short, and it is its owner's last).
__host__ __device__ inline int row_slot(int a, int cs) {
  const int p = a / avi::kTriPanel;
  const int q = p % (2 * cs);
  return (2 * (p / (2 * cs)) + (q >= cs ? 1 : 0)) * avi::kTriPanel + a % avi::kTriPanel;
}

// The most rows and panels one block of the cluster owns.
__host__ __device__ inline int2 most_owned(int d, int cs) {
  int rows = 0, panels = 0;
  for (int r = 0; r < cs; ++r) {
    int nr = 0, npn = 0;
    for (int p = 0; p < avi::tri_panels(d); ++p)
      if (panel_owner(p, cs) == r) {
        const int pw = d - p * avi::kTriPanel;
        nr += pw < avi::kTriPanel ? pw : avi::kTriPanel;
        ++npn;
      }
    rows = nr > rows ? nr : rows;
    panels = npn > panels ? npn : panels;
  }
  return make_int2(rows, panels);
}

// Offsets (in floats) of one cluster block's shared-memory arrays: the
// same in every block, so that a remote array is at the local offset.
struct ClusterLayout {
  int X, y, lx, l, u, z, g, w, wp, vec, dm, row, rows, sb, strip, mat, inv, total;
  int ks, rmax, pmax;  // data rows of a block's logits, most owned rows and panels
};

// The floats of block r's strip of C: for each panel q it owns, the rows
// below the panel (32 (q + 1) .. d - 1) at its 32 columns.
__host__ __device__ inline int strip_floats(int d, int cs, int r) {
  int f = 0;
  for (int p = 0; p < avi::tri_panels(d); ++p) {
    const int below = d - (p + 1) * avi::kTriPanel;
    if (panel_owner(p, cs) == r && below > 0) f += avi::kTriPanel * below;
  }
  return f;
}

// Where a cluster block keeps its rows of the scale matrices, its panels'
// operators and its strip of C: shared memory when they fit (in that
// order), else the first two in device memory and the strip not at all
// (the updates then read C's rows where they lie).
struct ClusterPlacement {
  bool mat, inv, strip;
};

__host__ __device__ inline ClusterLayout make_cluster_layout(int model, int n_data, int db,
                                                             int n, int d, int k, int cs,
                                                             ClusterPlacement at) {
  ClusterLayout L;
  const bool lr = model == avi::kLogReg;
  const int2 most = most_owned(d, cs);
  L.ks = lr ? (n_data + cs - 1) / cs : 0;
  L.rmax = most.x;
  L.pmax = most.y;
  int o = 0;
  L.X = o;    o += lr ? n_data * db : 0;  // the whole design in every block
  L.y = o;    o += lr ? n_data : 0;
  L.lx = o;   o += n * L.ks;              // this block's data rows of the logits
  L.l = o;    o += lr ? n * n_data : 0;   // all logits, then weights
  L.u = o;    o += n * d;
  L.z = o;    o += 2 * (n + 1) * d;       // samples and C's owned diagonal, by step parity
  L.g = o;    o += n * d;
  L.w = o;    o += n * d;                 // (z - m), then C^{-T} u, then g_z (own columns)
  L.wp = o;   o += n * d;                 // the solved panels W_p the other blocks push
  L.vec = o;  o += k * d;
  L.dm = o;   o += d;
  L.row = o;  o += 6 * n + 1;
  L.rows = o; o += d;                     // the owned rows' indices (int)
  L.sb = o;   o += L.pmax;                // each owned panel's offset in the strip (int)
  int strip = 0;
  for (int r = 0; r < cs; ++r) {
    const int f = strip_floats(d, cs, r);
    strip = f > strip ? f : strip;
  }
  L.strip = o; o += at.strip ? strip : 0;  // C[rows below, the owned panels' columns]
  L.mat = o;  o += at.mat ? k * L.rmax * d : 0;
  L.inv = o;  o += at.inv ? L.pmax * avi::kTriBlock : 0;
  L.total = o;
  return L;
}

inline ClusterPlacement place_cluster(int model, int n_data, int db, int n, int d, int k,
                                      int cs) {
  auto fits = [&](ClusterPlacement at) {
    return sizeof(float) * static_cast<size_t>(
                               make_cluster_layout(model, n_data, db, n, d, k, cs, at).total) <=
           kSmemLimit;
  };
  ClusterPlacement at{true, false, false};
  at.mat = fits(at);
  at.inv = true;
  at.inv = fits(at);
  at.strip = true;
  at.strip = fits(at);
  return at;
}

// The launches the cluster kernel serves: the full-data models and the
// rules without a global sum.
__host__ __device__ inline bool cluster_served(int model, int algo) {
  return (model == avi::kLogReg || model == avi::kMvNormal || model == avi::kGaussian) &&
         (algo == avi::kAdam || algo == avi::kDescent || algo == avi::kCOCOB);
}

// Adam (avi::adam_step) and the averaging with each sum of two products
// spelled as the single-block kernel's build rounds it (one fma and one
// rounded product; found by holding each form against that kernel's
// results on an H100): left to the compiler, which product it fuses moved
// with unrelated edits of this kernel, as it did in K6's G-chain kernel.
__device__ __forceinline__ void adam_fixed(float& x, float& m, float& v, float g,
                                           const avi::Hyper& h, float bc1, float bc2) {
  m = fmaf(1.0f - h.b1, g, __fmul_rn(h.b1, m));
  v = fmaf(__fmul_rn(1.0f - h.b2, g), g, __fmul_rn(h.b2, v));
  x = x + -h.lr * (m / bc1) / (sqrtf(v / bc2) + h.eps);
}

__device__ __forceinline__ void rule_fixed(const avi::Branch& br, const avi::Hyper& h, float eta,
                                           float bc1, float bc2, float& x, float& m, float& v,
                                           float& G, float& R, float& th, float g) {
  if (br.algo == avi::kAdam)
    adam_fixed(x, m, v, g, h, bc1, bc2);
  else
    avi::rule_step(br, h, eta, bc1, bc2, x, m, v, G, R, th, g);
}

// (1 - w) a + w x, the polynomial averaging: the single-block kernel fuses
// (1 - w) a for the location and w x for the scale
__device__ __forceinline__ float avg_location(float w, float a, float x) {
  return fmaf(1.0f - w, a, __fmul_rn(w, x));
}
__device__ __forceinline__ float avg_scale(float w, float a, float x) {
  return fmaf(w, x, __fmul_rn(1.0f - w, a));
}

// A barrier of the block's last `threads` threads (whole warps), named `id`
// (0 is __syncthreads').
__device__ __forceinline__ void sync_warps(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Every column of buf (rows x d, row-major) that another block owns, read
// from that block's copy: kGather remote loads a thread in flight.
__device__ __forceinline__ void gather_columns(const cg::cluster_group& cluster, float* buf,
                                               int rows_n, int d, int cs, int rank, int tid) {
  const int total = rows_n * d;
  for (int base = tid; base < total; base += kThreads * kGather) {
    float v[kGather];
    int src[kGather];
#pragma unroll
    for (int q = 0; q < kGather; ++q) {
      const int idx = base + q * kThreads;
      src[q] = idx < total ? panel_owner((idx % d) / avi::kTriPanel, cs) : rank;
      v[q] = src[q] != rank ? *cluster.map_shared_rank(buf + idx, src[q]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kGather; ++q)
      if (src[q] != rank) buf[base + q * kThreads] = v[q];
  }
}

#ifdef AVI_PHASE_CLOCKS
// Rank 0's first thread past the operators' warps, as avi_phase_cycles:
// [0, 5) the phases, 5 the cycles spent inside cluster barriers (a part of
// the others).
__device__ unsigned long long avi_cluster_cycles[10];
// 6-9 parts of phases: 6 W = U and the strip of C, 7 the solves and pushes,
// 9 the updates (the whitening), 8 the mvnormal product
#define AVI_CSUB(i, t0)                                                                \
  do {                                                                                \
    if (rank == 0 && tid == 32 * aw)                                                  \
      atomicAdd(&avi_cluster_cycles[i], static_cast<unsigned long long>(clock64() - t0)); \
  } while (0)
#define AVI_CNOW() clock64()
#define AVI_CPHASE(i)                                                                 \
  do {                                                                                \
    if (rank == 0 && tid == 32 * aw) {                                                \
      const long long t_now = clock64();                                              \
      atomicAdd(&avi_cluster_cycles[i], static_cast<unsigned long long>(t_now - t_prev)); \
      t_prev = t_now;                                                                 \
    }                                                                                 \
  } while (0)
#define CLUSTER_SYNC()                                                                \
  do {                                                                                \
    const long long t_in = clock64();                                                 \
    cluster.sync();                                                                   \
    if (rank == 0 && tid == 32 * aw)                                                  \
      atomicAdd(&avi_cluster_cycles[5], static_cast<unsigned long long>(clock64() - t_in)); \
  } while (0)
#else
#define AVI_CPHASE(i) \
  do {                \
  } while (0)
#define CLUSTER_SYNC() cluster.sync()
#define AVI_CSUB(i, t0) \
  do {                  \
  } while (0)
#define AVI_CNOW() 0LL
#endif

// One cluster of cs blocks per launch; the arguments are the single-block
// kernel's (no minibatch slab) and the cluster size.  128 registers a
// thread, all a 512-thread block may take: lower caps spilled more and
// ran slower at d = 512 on an H100.
__global__ void __maxnreg__(128) fused_advi_fullrank_cluster_kernel(
    int model, const float* __restrict__ c0, const float* __restrict__ c1, int n_data, int db,
    float s0, float s1, const float* __restrict__ vec_in, const float* __restrict__ mat_in,
    float* __restrict__ vec_out, float* mat_out, float* __restrict__ elbo_out,
    float* __restrict__ trace, const float* __restrict__ noise, float* inv_dev, int n, int d,
    int k, int steps, int log_every, uint32_t k0, uint32_t k1, unsigned long long it0,
    avi::Hyper h, avi::Branch br, ClusterPlacement at, int cs) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float smem[];
  const ClusterLayout L = make_cluster_layout(model, n_data, db, n, d, k, cs, at);
  const bool logreg = model == avi::kLogReg;
  const bool mvnormal = model == avi::kMvNormal;
  const int np = avi::tri_panels(d);
  float* us = smem + L.u;
  float* gs = smem + L.g;
  float* ws = smem + L.w;
  float* wp = smem + L.wp;
  float* mu = smem + L.vec;
  float* m_mu = mu + d;
  float* v_mu = mu + 2 * d;
  float* a_mu = mu + 3 * d;
  float* ext_mu = mu + 4 * d;
  float* dm = smem + L.dm;
  float* beta_sq = smem + L.row;
  float* tcol = beta_sq + n;
  float* inv_sig2 = tcol + n;
  float* logpi = inv_sig2 + n;
  float* u2 = logpi + n;
  float* logdet = u2 + 2 * n;
  int* rows = reinterpret_cast<int*>(smem + L.rows);
  int* sbase = reinterpret_cast<int*>(smem + L.sb);
  float* strip = smem + L.strip;
  float* lx = smem + L.lx;
  float* inv = at.inv ? smem + L.inv : inv_dev + static_cast<size_t>(rank) * L.pmax * avi::kTriBlock;
  const size_t dd = static_cast<size_t>(d) * d;
  const avi::LogReg lrm{smem + L.X, smem + L.y, smem + L.l, nullptr, n_data, db, n_data, 0,
                        s0, s1};
  const float* mean = c0;
  const float* prec = c1;
  const float lognorm = s0;
  const int k_lo = rank * L.ks;                        // this block's data rows
  const int kn = max(0, min(n_data, k_lo + L.ks) - k_lo);

  // row a of scale matrix m (0 sig, 1 m_sig, 2 v_sig, 3 avg_sig, 4-6 COCOB's),
  // for a row this block owns
  auto mrow = [&](int m, int a) -> float* {
    return at.mat ? smem + L.mat + (static_cast<size_t>(m) * L.rmax + row_slot(a, cs)) * d
                  : mat_out + m * dd + static_cast<size_t>(a) * d;
  };
  // rows c0 .. of C's panel p, whichever block owns it, indexed [k * d + c]
  auto panel_rows = [&](int p) -> const float* {
    const int a = p * avi::kTriPanel;
    if (!at.mat) return mat_out + static_cast<size_t>(a) * d;
    float* local = smem + L.mat + static_cast<size_t>(row_slot(a, cs)) * d;
    const int o = panel_owner(p, cs);
    return o == rank ? local : cluster.map_shared_rank(local, o);
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int na = 0;  // rows owned, ascending: row_slot(rows[t]) == t
  for (int p = 0, f = 0; p < np; ++p)
    if (panel_owner(p, cs) == rank) {
      const int pw = min(avi::kTriPanel, d - p * avi::kTriPanel);
      if (tid < pw) rows[na + tid] = p * avi::kTriPanel + tid;
      if (tid == 0) sbase[na / avi::kTriPanel] = f;
      f += avi::kTriPanel * max(0, d - (p + 1) * avi::kTriPanel);
      na += pw;
    }
  if (logreg) {
    for (int i = tid; i < n_data * db; i += kThreads) smem[L.X + i] = c0[i];
    for (int i = tid; i < n_data; i += kThreads) smem[L.y + i] = c1[i];
  }
  for (int i = tid; i < k * d; i += kThreads) mu[i] = vec_in[i];
  __syncthreads();  // rows[] is written
  const int nq = na / avi::kTriPanel + (na % avi::kTriPanel ? 1 : 0);  // owned panels
  // warps that form the panels' operators in phase A (none when the
  // entropy needs no whitening; all but one at most)
  const int aw = br.entropy == avi::kClosedFormZero ? 0 : min(nq, kWarps - 1);
  for (int idx = tid; idx < k * na * d; idx += kThreads) {  // owned rows, upper parts too
    const int m = idx / (na * d);
    const int rest = idx - m * na * d;
    const int t = rest / d;
    const int b = rest - t * d;
    mrow(m, rows[t])[b] = mat_in[m * dd + static_cast<size_t>(rows[t]) * d + b];
  }
  __syncthreads();

  const bool cf_zero = br.entropy == avi::kClosedFormZero;
  const bool stl_zero = br.entropy == avi::kSTLZero;
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
    float* zs = smem + L.z + (s & 1) * (nd + d);
    float* dgs = zs + nd;  // row n: the pre-update diagonal, rank 0's log det

    // A: base draws (all of u, in every block), z's owned columns; the
    // whitening's diagonal-block operators meanwhile on warps [0, aw)
    if (warp < aw)
      for (int q = warp; q < nq; q += aw) {
        const int c0p = rows[q * avi::kTriPanel];  // this block's q-th panel
        // C indexed [row * d + col] over the panel's rows: the owned rows' base
        // moved back by c0p rows
        avi::diag_block_inverse<false>(mrow(0, c0p) - static_cast<size_t>(c0p) * d, d,
                                       c0p / avi::kTriPanel, inv + q * avi::kTriBlock, lane);
      }
    const int wt = tid - aw * 32;  // the other warps' threads
    const int wn = kThreads - aw * 32;
    if (noise != nullptr) {
      const float* src = noise + static_cast<size_t>(s) * nd;
      for (int idx = wt; idx >= 0 && idx < nd; idx += wn) us[idx] = src[idx];
    } else {
      for (int pair = wt; pair >= 0 && pair < n * groups; pair += wn) {
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
    if (warp >= aw) sync_warps(1, wn);  // u is drawn (the operators' warps go on)
    AVI_CPHASE(0);
    for (int t = warp - aw; t >= 0 && t < na; t += kWarps - aw) {  // owned rows of z
      const int a = rows[t];
      const float* cr = mrow(0, a);
      for (int i0 = 0; i0 < n; i0 += kRowChunk) {
        float acc[kRowChunk];
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
        for (int b0 = lane; b0 <= a; b0 += 32 * kZLoads) {  // b in the lane's order
          float cv[kZLoads];
#pragma unroll
          for (int j = 0; j < kZLoads; ++j) cv[j] = b0 + 32 * j <= a ? cr[b0 + 32 * j] : 0.0f;
#pragma unroll
          for (int j = 0; j < kZLoads; ++j) {
            const int b = b0 + 32 * j;
            if (b > a) break;
#pragma unroll
            for (int r = 0; r < kRowChunk; ++r)
              if (i0 + r < n) acc[r] = fmaf(us[(i0 + r) * d + b], cv[j], acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) {
          if (i0 + r >= n) break;  // uniform over the warp
          const float v = avi::warp_sum(acc[r]);
          if (lane == 0) zs[(i0 + r) * d + a] = __fadd_rn(v, mu[a]);
        }
      }
    }
    for (int t = tid; t < na; t += kThreads) dgs[rows[t]] = mrow(0, rows[t])[rows[t]];
    if (rank == 0)  // |u|^2 on the warps that waited for the draws
      for (int i = warp - aw; i >= 0 && i < n; i += kWarps - aw) {
        float uu = 0.0f;
        for (int j = lane; j < d; j += 32) {
          const float v = us[i * d + j];
          uu += v * v;
        }
        uu = avi::warp_sum(uu);
        if (lane == 0) u2[i] = uu;
      }
    CLUSTER_SYNC();  // S1: z's columns and the diagonal are written
    gather_columns(cluster, zs, rank == 0 ? n + 1 : n, d, cs, rank, tid);
    if (rank == 0) {  // log det of the pre-update scale
      __syncthreads();
      if (warp == kWarps - 1) {
        float ld = 0.0f;
        for (int j = lane; j < d; j += 32) ld += logf(dgs[j]);
        ld = avi::warp_sum(ld);
        if (lane == 0) *logdet = ld;
      }
    }
    __syncthreads();
    AVI_CPHASE(1);

    // B: log pi and the owned columns of its gradient
    if (logreg) {
      avi::logreg_rows(lrm, zs, n, d, beta_sq, tcol, inv_sig2, warp, kWarps, lane);
      // this block's data rows of the logits, one output a thread, k in order
      for (int idx = tid; idx < n * kn; idx += kThreads) {
        const int i = idx / kn;
        const int q = idx - i * kn;
        const float* zr = zs + i * d;
        const float* xr = lrm.X + (k_lo + q) * db;
        float acc = 0.0f;
        for (int j = 0; j < db; ++j) acc = fmaf(zr[j], xr[j], acc);
        lx[i * L.ks + q] = acc;
      }
      CLUSTER_SYNC();  // S2: every block's logits are written
      for (int base = tid; base < n * n_data; base += kThreads * kGather) {
        float v[kGather];
#pragma unroll
        for (int q = 0; q < kGather; ++q) {
          const int idx = base + q * kThreads;
          v[q] = 0.0f;
          if (idx < n * n_data) {
            const int i = idx / n_data;
            const int o = (idx - i * n_data) / L.ks;
            const float* src = lx + i * L.ks + (idx - i * n_data - o * L.ks);
            v[q] = o == rank ? *src : *cluster.map_shared_rank(src, o);
          }
        }
#pragma unroll
        for (int q = 0; q < kGather; ++q)
          if (base + q * kThreads < n * n_data) lrm.l[base + q * kThreads] = v[q];
      }
      __syncthreads();
      avi::logreg_logpi(lrm, n, beta_sq, tcol, inv_sig2, logpi, warp, kWarps, lane);
      __syncthreads();
      // logreg_grad_each's outputs of the owned columns
      const float s2 = lrm.prior_scale * lrm.prior_scale;
      const float fdb = static_cast<float>(db);
      for (int idx = tid; idx < n * na; idx += kThreads) {
        const int i = idx / na;
        const int j = rows[idx - i * na];
        const int e = i * d + j;
        float gv;
        if (j < db) {
          const float* gl = lrm.l + i * n_data;
          float acc = 0.0f;
          for (int kk = 0; kk < n_data; ++kk) acc = fmaf(gl[kk], lrm.X[kk * db + j], acc);
          gv = acc - zs[e] * inv_sig2[i];
        } else {
          gv = beta_sq[i] * inv_sig2[i] - fdb - tcol[i] / s2;
        }
        gs[e] = gv;
      }
    } else if (!mvnormal) {
      avi::gaussian_body(mean, prec, lognorm, zs, n, d, logpi, gs, warp, kWarps, lane);
    } else {
      const long long t_m = AVI_CNOW();
      for (int idx = tid; idx < nd; idx += kThreads) ws[idx] = zs[idx] - mean[idx % d];
      __syncthreads();
      // the owned columns a of g = -(z - m) P: a thread per (column, row
      // group), each sum over b in order as the single-block kernel's; the
      // column's reads of P are kPLoads loads issued before their fmas
      const int rg = max(1, min(min(n, kPGroups), kThreads / na));
      for (int e = tid; e < na * rg; e += kThreads) {
        const int g = e / na;
        const int a = rows[e - g * na];
        for (int i0 = g; i0 < n; i0 += kPRows * rg) {
          float acc[kPRows];
#pragma unroll
          for (int r = 0; r < kPRows; ++r) acc[r] = 0.0f;
          for (int b0 = 0; b0 < d; b0 += kPLoads) {
            float pv[kPLoads];
#pragma unroll
            for (int q = 0; q < kPLoads; ++q)
              pv[q] = b0 + q < d ? prec[static_cast<size_t>(b0 + q) * d + a] : 0.0f;
#pragma unroll
            for (int q = 0; q < kPLoads; ++q) {
              if (b0 + q >= d) break;
#pragma unroll
              for (int r = 0; r < kPRows; ++r) {
                const int i = i0 + r * rg;
                if (i < n) acc[r] = fmaf(ws[i * d + b0 + q], pv[q], acc[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kPRows; ++r) {
            const int i = i0 + r * rg;
            if (i < n) gs[i * d + a] = -acc[r];
          }
        }
      }
      AVI_CSUB(8, t_m);
      CLUSTER_SYNC();  // S2: every block's columns of g are written
      if (rank == 0) {
        gather_columns(cluster, gs, n, d, cs, rank, tid);
        __syncthreads();
        for (int i = warp; i < n; i += kWarps) {
          float q = 0.0f;
          for (int j = lane; j < d; j += 32) q += ws[i * d + j] * gs[i * d + j];
          q = avi::warp_sum(q);
          if (lane == 0) logpi[i] = 0.5f * q + lognorm;
        }
      }
    }
    __syncthreads();
    AVI_CPHASE(2);

    // C: whitening W = U C^{-1} (trisolve_rows.cuh's mode C) over the cluster:
    // every block stages its strip of C (the rows below its panels, at
    // their columns) once; panel p's owner solves W_p and pushes it into the
    // other blocks' wp; after the barrier every block subtracts W_p C[p, c]
    // from its unsolved columns c
    if (!cf_zero) {
      long long t_sub = AVI_CNOW();
      for (int idx = tid; idx < n * na; idx += kThreads) {  // owned columns start as U
        const int i = idx / na;
        const int e = i * d + rows[idx - i * na];
        ws[e] = us[e];
      }
      for (int q = 0; q < (at.strip ? nq : 0); ++q) {  // the strip, kGather loads in flight
        const int c0q = rows[q * avi::kTriPanel];
        const int a0 = c0q + avi::kTriPanel;
        const int total = max(0, d - a0) * avi::kTriPanel;
        for (int base = tid; base < total; base += kThreads * kGather) {
          float v[kGather];
#pragma unroll
          for (int g = 0; g < kGather; ++g) {
            const int idx = base + g * kThreads;
            const int j = a0 + idx / avi::kTriPanel;
            v[g] = idx < total ? panel_rows(j / avi::kTriPanel)[static_cast<size_t>(
                                     j % avi::kTriPanel) * d + c0q + idx % avi::kTriPanel]
                               : 0.0f;
          }
#pragma unroll
          for (int g = 0; g < kGather; ++g) {
            const int idx = base + g * kThreads;
            if (idx < total) strip[sbase[q] + idx] = v[g];
          }
        }
      }
      __syncthreads();
      AVI_CSUB(6, t_sub);
      int nu = na;  // owned columns below the panel being applied
      for (int p = np - 1; p >= 0; --p) {
        const int c0p = p * avi::kTriPanel;
        const int pw = min(avi::kTriPanel, d - c0p);
        const int o = panel_owner(p, cs);
        t_sub = AVI_CNOW();
        if (o == rank) {  // the panel's unknowns, one warp per row
          const float* Mp = inv + (row_slot(c0p, cs) / avi::kTriPanel) * avi::kTriBlock;
          for (int r = warp; r < n; r += kWarps) {
            float* rr = ws + r * d + c0p;
            float w = 0.0f;
            for (int kk = 0; kk < pw; ++kk) w = fmaf(rr[kk], Mp[kk * avi::kTriPanel + lane], w);
            __syncwarp();
            if (lane < pw) {
              rr[lane] = w;
              for (int q = 0; q < cs; ++q)
                if (q != rank) *cluster.map_shared_rank(wp + r * d + c0p + lane, q) = w;
            }
          }
        }
        AVI_CSUB(7, t_sub);
        CLUSTER_SYNC();  // W_p is solved and pushed; after p = 0, the walk is over
        if (p == 0) break;
        t_sub = AVI_CNOW();
        while (nu > 0 && rows[nu - 1] >= c0p) --nu;
        // a thread per (row, owned unsolved column), each sum over the
        // panel's k in order as solve_right_rows
        const float* W = o == rank ? ws : wp;
        for (int e = tid; e < n * nu; e += kThreads) {
          const int r = e / nu;
          const int t = e - r * nu;
          const int q = t / avi::kTriPanel;
          // C[p, c]: the strip's column, or C's rows where they lie
          const float* sc = at.strip ? strip + sbase[q] +
                                           (c0p - rows[q * avi::kTriPanel] - avi::kTriPanel) *
                                               avi::kTriPanel +
                                           t % avi::kTriPanel
                                     : panel_rows(p) + rows[t];
          const int ss = at.strip ? avi::kTriPanel : d;
          const float* wr = W + r * d + c0p;
          float acc = 0.0f;
          for (int kk = 0; kk < pw; ++kk) acc = fmaf(wr[kk], sc[kk * ss], acc);
          ws[r * d + rows[t]] -= acc;
        }
        __syncthreads();
        AVI_CSUB(9, t_sub);
      }
    }
    AVI_CPHASE(3);

    // D: g_z of the owned columns (into w: rank 0 may still read g), dmu,
    // the rule, the operator on the diagonal and the averaging, owned rows
    float* gz = ws;
    for (int idx = tid; idx < n * na; idx += kThreads) {
      const int i = idx / na;
      const int e = i * d + rows[idx - i * na];
      gz[e] = -inv_n * (cf_zero ? gs[e] : gs[e] + ws[e]);
    }
    __syncthreads();
    for (int t = tid; t < na; t += kThreads) {
      const int a = rows[t];
      float dmu = 0.0f;
      for (int i = 0; i < n; ++i) dmu += gz[i * d + a];
      dm[a] = dmu;
    }
    const float c = static_cast<float>(it) + 1.0f;
    const float bc1 = 1.0f - expf(c * ln_b1);
    const float bc2 = 1.0f - expf(c * ln_b2);
    const float w = (h.avg_eta + 1.0f) / (c + h.avg_eta);
    const float eta = br.algo == avi::kDescent ? h.lr : 0.0f;
    for (int t = tid; t < na; t += kThreads) {  // the thread that formed dm[a]
      const int a = rows[t];
      float G = 0.0f, R = 0.0f, T = 0.0f;
      if (cocob) {
        G = ext_mu[a];
        R = ext_mu[d + a];
        T = ext_mu[2 * d + a];
      }
      rule_fixed(br, h, eta, bc1, bc2, mu[a], m_mu[a], v_mu[a], G, R, T, dm[a]);
      if (cocob) {
        ext_mu[a] = G;
        ext_mu[d + a] = R;
        ext_mu[2 * d + a] = T;
      }
      a_mu[a] = avg_location(w, a_mu[a], mu[a]);
    }
    for (int t = warp; t < na; t += kWarps) {  // the owned rows of the lower triangle
      const int a = rows[t];
      float* sr = mrow(0, a);
      float* mr = mrow(1, a);
      float* vr = mrow(2, a);
      float* ar = mrow(3, a);
      for (int b = lane; b <= a; b += 32) {
        float dcv = lower_grad(gz, us, n, d, a, b);
        if (stl_zero && a == b) dcv += 1.0f / sr[b];  // the pre-update diagonal
        float x = sr[b], m = mr[b], v = vr[b];
        float G = 0.0f, R = 0.0f, T = 0.0f;
        if (cocob) {
          G = mrow(4, a)[b];
          R = mrow(5, a)[b];
          T = mrow(6, a)[b];
        }
        rule_fixed(br, h, eta, bc1, bc2, x, m, v, G, R, T, dcv);
        if (cocob) {
          mrow(4, a)[b] = G;
          mrow(5, a)[b] = R;
          mrow(6, a)[b] = T;
        }
        if (a == b) x = avi::scale_operator(br.op, x, eta, h);
        sr[b] = x;
        mr[b] = m;
        vr[b] = v;
        ar[b] = avg_scale(w, ar[b], x);
      }
    }

    // E: the step's ELBO estimate (rank 0)
    if (rank == 0 && tid == 0) {
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
    AVI_CPHASE(4);
  }

  for (int idx = tid; idx < k * na; idx += kThreads) {
    const int m = idx / na;
    const int a = rows[idx - m * na];
    vec_out[m * d + a] = mu[m * d + a];
  }
  if (at.mat)
    for (int idx = tid; idx < k * na * d; idx += kThreads) {
      const int m = idx / (na * d);
      const int rest = idx - m * na * d;
      const int t = rest / d;
      const int b = rest - t * d;
      mat_out[m * dd + static_cast<size_t>(rows[t]) * d + b] = mrow(m, rows[t])[b];
    }
  if (rank == 0 && tid == 0) *elbo_out = elbo;
  cluster.sync();  // no block leaves while another may read its shared memory
}
#endif  // AVI_AD_BODY

}  // namespace

// The dynamic shared memory of a launch with every per-step array in
// shared memory: with the k scale matrices and the whitening's panel
// operators in shared memory where they fit (place), without them
// otherwise; k is 4, or 7 with COCOB.  Above the limit, the launch takes
// the tiered layout, fused_advi_fullrank_layout.
extern "C" size_t fused_advi_fullrank_smem_bytes(int model, int n_data, int db, int batch,
                                                 int n, int d, int k) {
  const Placement at = place(model, n_data, db, batch, n, d, k);
  return sizeof(float) * static_cast<size_t>(
                             make_layout(model, n_data, db, batch, n, d, k, at.mat, at.inv).total);
}

// What a single-block launch takes: out[0] its tier (-1: every per-step
// array in shared memory, fused_advi_fullrank_smem_bytes), out[1] its bytes
// of dynamic shared memory, out[2] the floats of device workspace the
// caller passes as `ws` (0: none).
extern "C" void fused_advi_fullrank_layout(int model, int n_data, int db, int batch, int n,
                                           int d, int k, long long* out) {
  const size_t all = fused_advi_fullrank_smem_bytes(model, n_data, db, batch, n, d, k);
  if (all <= kSmemLimit) {
    out[0] = -1;
    out[1] = static_cast<long long>(all);
    out[2] = 0;
    return;
  }
  const TierLayout T = tier_layout(model, n_data, db, batch, n, d, k);
  out[0] = T.tier;
  out[1] = static_cast<long long>(sizeof(float)) * T.smem;
  out[2] = T.ws;
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
// whitening's panel operators, used when they do not fit in shared memory;
// ws: the tiered layout's workspace of fused_advi_fullrank_layout's out[2]
// floats (null when that is 0).  algo,
// entropy, grad_est, op: the avi::Branch codes (grad_est must be the
// reparameterization gradient).  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a launch the kernel
// does not take.  Model 6 (a library built with AVI_AD_BODY): K5's
// generated body at its (n, d), c0 = packed float constants, c1 = packed
// int32 constants (on the tiered layout only a body whose constants are not
// staged, kStage 0).
extern "C" int fused_advi_fullrank(
    int model, const float* c0, const float* c1, int n_data, int db, int batch, float s0,
    float s1, const float* vec_in, const float* mat_in, float* vec_out,
    float* mat_out, float* elbo_out, float* trace, const float* noise, float* inv_scratch,
    int n, int d,
    int steps, int log_every, uint32_t seed0, uint32_t seed1, unsigned long long it0,
    float lr, float b1, float b2, float eps, float avg_eta, float clip_eps, int algo,
    int entropy, int grad_est, int op, float cocob_alpha, float* ws, cudaStream_t stream) {
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
  long long lay[3];
  fused_advi_fullrank_layout(model, n_data, db, batch, n, d, k, lay);
  const size_t smem = static_cast<size_t>(lay[1]);
  if (smem > kSmemLimit || (lay[2] > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  const avi::Branch br{algo, entropy, grad_est, op, cocob_alpha};
  if (lay[0] >= 0) {
#ifdef AVI_AD_BODY  // the tiered layout stages no constants
    if (avi::ad::kStage > 0) return static_cast<int>(cudaErrorInvalidValue);
#endif
    cudaError_t err = cudaFuncSetAttribute(fused_advi_fullrank_tier_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_advi_fullrank_tier_kernel<<<1, kThreads, smem, stream>>>(
        model, c0, c1, n_data, db, batch, s0, s1, vec_in, mat_in, vec_out, mat_out, elbo_out,
        trace, noise, inv_scratch, n, d, k, steps, log_every, seed0, seed1, it0, h, br, ws,
        static_cast<int>(lay[0]));
    return static_cast<int>(cudaGetLastError());
  }
  const Placement at = place(model, n_data, db, batch, n, d, k);
  // above 48 KB only after this call; without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(fused_advi_fullrank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_advi_fullrank_kernel<<<1, kThreads, smem, stream>>>(
      model, c0, c1, n_data, db, batch, s0, s1, vec_in, mat_in, vec_out, mat_out, elbo_out,
      trace, noise, inv_scratch, n, d, k, steps, log_every, seed0, seed1, it0, h, br, at);
  return static_cast<int>(cudaGetLastError());
}

#ifndef AVI_AD_BODY
// The cluster kernel's dynamic shared memory a block (every block of the
// cluster has the same layout): its owned rows of the k scale matrices and
// its panels' operators where they fit, as place() does for one block.
extern "C" size_t fused_advi_fullrank_cluster_smem_bytes(int model, int n_data, int db, int n,
                                                         int d, int k, int cs) {
  return sizeof(float) *
         static_cast<size_t>(
             make_cluster_layout(model, n_data, db, n, d, k, cs,
                                 place_cluster(model, n_data, db, n, d, k, cs))
                 .total);
}

// The kernel's attributes for a cluster of cs blocks of `smem` bytes: the
// dynamic shared memory, and above 8 blocks the non-portable cluster size.
static cudaError_t cluster_attributes(int cs, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(fused_advi_fullrank_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess || cs <= 8) return err;
  return cudaFuncSetAttribute(fused_advi_fullrank_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

static cudaLaunchConfig_t cluster_config(int cs, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static bool cluster_size_ok(int d, int cs) {
  return cs >= 2 && cs <= kMaxCluster && (cs & (cs - 1)) == 0 && cs <= avi::tri_panels(d);
}

// How many clusters of cs blocks of this launch's layout the card can hold
// at once (cudaOccupancyMaxActiveClusters) into *out; 0 means it cannot
// schedule one.  Returns the first CUDA error (0 on success).
extern "C" int fused_advi_fullrank_cluster_max_active(int model, int n_data, int db, int n,
                                                      int d, int k, int cs, int* out) {
  *out = 0;
  if (!cluster_size_ok(d, cs)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fused_advi_fullrank_cluster_smem_bytes(model, n_data, db, n, d, k, cs);
  if (smem > kSmemLimit) return 0;
  cudaError_t err = cluster_attributes(cs, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cs, smem, nullptr, attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, fused_advi_fullrank_cluster_kernel, &cfg));
}

// fused_advi_fullrank's launch on a cluster of cs blocks (a power of two
// from 2 to 16, at most tri_panels(d)): the same arguments (batch 0) and
// results, for the full-data models (0-2) and Adam, descent or COCOB;
// cudaErrorInvalidValue for any other launch.  inv_scratch: cs x
// most-owned-panels x 32 x 32 floats, used when the operators do not fit
// in shared memory.
extern "C" int fused_advi_fullrank_cluster(
    int model, const float* c0, const float* c1, int n_data, int db, int batch, float s0,
    float s1, const float* vec_in, const float* mat_in, float* vec_out, float* mat_out, float* elbo_out,
    float* trace, const float* noise, float* inv_scratch, int n, int d, int steps,
    int log_every, uint32_t seed0, uint32_t seed1, unsigned long long it0, float lr, float b1,
    float b2, float eps, float avg_eta, float clip_eps, int algo, int entropy, int grad_est,
    int op, float cocob_alpha, int cs, cudaStream_t stream) {
  const int k = algo == avi::kCOCOB ? 7 : 4;
  if (!cluster_served(model, algo) || grad_est != avi::kRepGrad || batch != 0 ||
      !cluster_size_ok(d, cs))
    return static_cast<int>(cudaErrorInvalidValue);
  const ClusterPlacement at = place_cluster(model, n_data, db, n, d, k, cs);
  // a layout over the limit fails here (the wrapper refuses it first)
  const size_t smem = fused_advi_fullrank_cluster_smem_bytes(model, n_data, db, n, d, k, cs);
  cudaError_t err = cluster_attributes(cs, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const avi::Hyper h{lr, b1, b2, eps, avg_eta, clip_eps};
  const avi::Branch br{algo, entropy, grad_est, op, cocob_alpha};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cs, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_advi_fullrank_cluster_kernel, model, c0, c1, n_data, db,
                           s0, s1, vec_in, mat_in, vec_out, mat_out, elbo_out, trace, noise,
                           inv_scratch, n, d, k, steps, log_every, seed0, seed1, it0, h, br, at,
                           cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef AVI_PHASE_CLOCKS
// Copies the instrumented build's avi_cluster_cycles (10 counters) to host
// memory `out` after the work queued so far, then zeroes them.
extern "C" int fused_advi_fullrank_cluster_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, avi_cluster_cycles, sizeof(avi_cluster_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(avi_cluster_cycles, zero, sizeof(zero)));
}

namespace {
// reps cluster barriers and nothing else: thread 0 of rank 0 adds the
// cycles to *cycles (the barrier's own cost, without a phase's imbalance).
__global__ void cluster_barrier_probe_kernel(int reps, unsigned long long* cycles) {
  cg::cluster_group cluster = cg::this_cluster();
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0)
    *cycles = static_cast<unsigned long long>(clock64() - t0);
}
}  // namespace

// One cluster of cs blocks of 512 threads runs `reps` cluster barriers;
// *cycles (device memory) receives rank 0's SM cycles for all of them.
extern "C" int fused_advi_fullrank_cluster_barrier_probe(int cs, int reps,
                                                         unsigned long long* cycles,
                                                         cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (cs > 8)
    err = cudaFuncSetAttribute(cluster_barrier_probe_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cs, 0, stream, attr);
  err = cudaLaunchKernelEx(&cfg, cluster_barrier_probe_kernel, reps, cycles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
#endif  // AVI_PHASE_CLOCKS
#endif  // AVI_AD_BODY
