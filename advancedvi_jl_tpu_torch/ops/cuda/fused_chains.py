"""Whole-loop fused multi-chain ADVI (CUDA): C mean-field chains, one launch.

Port of ops/pallas/fused_chains.py.  ``FusedChainsADVI`` advances C
independent mean-field chains of the fused engine (``FusedADVI``'s every
branch: Adam, descent, DoWG, DoG or COCOB; the STL or a zero-gradient
entropy, or VarGrad; ClipScale, the entropy prox or none; polynomial
averaging) on one shared model, in one kernel launch per chunk
(csrc/fused_chains.cu, K6: one thread block per chain while the chains do
not outnumber the card's SMs, else ``chains_per_block`` chains a block
sharing the model's data and the step's barriers; plain version
``fused_chains_run_chunk_reference``).  Chains differ in their initial
parameters, their Philox stream and, optionally, their learning rate (an
``(n_chains,)`` lr: step-size sweeps) or their update rule (a list of rule
names: mixed sweeps).

The state holds ``(C, d)`` tensors: the JAX engine's chain and lane padding
(c_pad, D_PAD) is gone, and ``convert.py`` moves states and noise between
the two layouts.  Chain c draws the step-indexed Philox normals of
``chain_seed_words(seed, c)``, so chain c of the engine is the single-chain
``FusedADVI`` run keyed by those words, and chain c of the general path
(``parallel/chains.py``).  ``noise=`` injects base draws of shape ``(steps,
C, n_samples, d)`` instead.

A mixed sweep runs each chain's own rule on its own slots (the JAX kernel
computes every rule's candidate on every chain and blends them with 0/1
weights; the two agree wherever every candidate is finite).  The slots are
the single-chain engine's: Adam's moments in ``m_*``/``v_*``, x0 and [v, r]
for DoWG/DoG, x1, L and the six ``ext`` rows for COCOB; with any COCOB chain
every chain carries the ``ext`` rows.

``fused_chains_run_chunk`` launches the kernel for CUDA tensors and runs its
plain version for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...families.location_scale import MeanFieldGaussian
from . import _build
from .fused_advi import (
    ALGO_ADAM,
    ALGO_COCOB,
    ALGO_CODES,
    ALGO_DESCENT,
    ALGO_DOG,
    ALGO_DOWG,
    AD,
    D_PAD_MAX,
    DEFAULT_BRANCH,
    ENT_CF_ZERO,
    ENT_STL,
    ENT_STL_ZERO,
    ETA_ALGOS,
    GAUSSIAN,
    GE_REPGRAD,
    GE_SCOREGRAD,
    GROUP_RULES,
    LAUNCH_GROUPS,
    LOGREG,
    MEANFIELD,
    MINIBATCH_MODELS,
    MODEL_CODES,
    MVNORMAL,
    OP_CLIP,
    OP_NONE,
    OP_PROX,
    STATE_FIELDS,
    FusedBranch,
    FusedHyper,
    FusedModelSpec,
    _avg,
    ad_program,
    _cocob_update,
    _f32,
    _model_args,
    kernel_precision,
    _model_logpi_grad,
    _prox,
    PHASE_CLOCKS,
    MF_PHASES,
    _trace_out,
    fused_layout,
    layout_groups,
    workspace,
)
from .location_scale_kernels import (
    SeedLike,
    chain_seed_table,
    check_f32,
    philox_normals_reference,
    seed_words,
)

_L2PI = math.log(2.0 * math.pi)

# Per-chain rule codes of a mixed sweep (JAX's RULE_CODES, whose float codes
# 0.0 .. 4.0 are the kernel's rule codes).
RULE_CODES = dict(ALGO_CODES)
MIXED = "mixed"  # the engine's ``algo`` once a per-chain rule list validated
PORTED_MODELS = (LOGREG, MVNORMAL, GAUSSIAN) + MINIBATCH_MODELS + (AD,)


@dataclass(frozen=True)
class FusedChainsState:
    """Engine state of C chains: eight float32 ``(C, d)`` tensors (row c is
    chain c's ``FusedADVIState`` row), the host iteration count shared by the
    chains, the last step's per-chain ELBO estimate ``(C,)`` and ``ext``:
    None, or six ``(C, d)`` tensors (COCOB's G, reward and theta of the
    location, then of the scale)."""

    mu: torch.Tensor
    sig: torch.Tensor
    m_mu: torch.Tensor
    v_mu: torch.Tensor
    m_sig: torch.Tensor
    v_sig: torch.Tensor
    avg_mu: torch.Tensor
    avg_sig: torch.Tensor
    iteration: int
    elbo: torch.Tensor
    ext: Optional[Tuple[torch.Tensor, ...]] = None

    def stacked(self, with_ext: bool = True) -> torch.Tensor:
        """The kernel's ``(C, n_rows, d)`` layout: STATE_FIELDS, then the six
        ext rows when there are any and ``with_ext``."""
        rows = [getattr(self, f) for f in STATE_FIELDS]
        if with_ext and self.ext is not None:
            rows += list(self.ext)
        return torch.stack(rows, dim=1)

    @classmethod
    def from_stacked(cls, rows: torch.Tensor, iteration: int, elbo: torch.Tensor, ext=None):
        """From ``(C, 8, d)`` rows (``ext`` kept as given) or ``(C, 14, d)``."""
        parts = rows.unbind(1)
        if len(parts) == 14:
            ext = tuple(parts[8:])
        return cls(**dict(zip(STATE_FIELDS, parts[:8])), iteration=iteration, elbo=elbo,
                   ext=ext)


# ---------------------------------------------------------------------------
# The plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def _chain_codes(branch: FusedBranch, rules, C: int, dev) -> torch.Tensor:
    if rules is None:
        return torch.full((C,), ALGO_CODES[branch.algo], dtype=torch.int64, device=dev)
    return rules.to(device=dev, dtype=torch.int64)


def _chains_rule_step(codes, hyp: FusedHyper, lr, c, st, dmu, dsig, cocob_alpha: float):
    """Each chain's rule on its own slots (``st``: (C, d) tensors mu, sig,
    m_mu, v_mu, m_sig, v_sig and the ext tuple), the single-chain
    ``_rule_step`` arithmetic per chain with ``lr`` a (C, 1) column.
    Returns the (C, 1) step sizes (descent: lr; DoWG, DoG: eta; else 0)."""
    new = {k: st[k] for k in ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig")}
    new_ext = st["ext"]
    eta = torch.zeros_like(lr)

    def take(code, cand_mu, cand_sig, **slots):
        sel = (codes == code)[:, None]
        new["mu"] = torch.where(sel, cand_mu, new["mu"])
        new["sig"] = torch.where(sel, cand_sig, new["sig"])
        for k, v in slots.items():
            new[k] = torch.where(sel, v, new[k])
        return sel

    present = set(codes.tolist())
    if ALGO_CODES[ALGO_ADAM] in present:
        bc1 = _f32(np.float32(1.0) - np.exp(c * np.log(np.float32(hyp.b1))))
        bc2 = _f32(np.float32(1.0) - np.exp(c * np.log(np.float32(hyp.b2))))
        b1, b2 = np.float32(hyp.b1), np.float32(hyp.b2)
        moments = []
        for m, v, g in ((st["m_mu"], st["v_mu"], dmu), (st["m_sig"], st["v_sig"], dsig)):
            m2 = float(b1) * m + _f32(1 - b1) * g
            v2 = float(b2) * v + _f32(1 - b2) * g * g
            moments.append((m2, v2, (-lr) * (m2 / bc1) / (torch.sqrt(v2 / bc2) + _f32(hyp.eps))))
        (mm, vm, um), (ms, vs, us) = moments
        take(ALGO_CODES[ALGO_ADAM], st["mu"] + um, st["sig"] + us, m_mu=mm, v_mu=vm,
             m_sig=ms, v_sig=vs)
    if ALGO_CODES[ALGO_COCOB] in present:
        g_mu, r_mu, t_mu, g_sig, r_sig, t_sig = st["ext"]
        xm, lm, gm, rm, tm = _cocob_update(cocob_alpha, st["mu"], st["m_mu"], st["v_mu"],
                                           g_mu, r_mu, t_mu, dmu)
        xs, ls, gs, rs, ts = _cocob_update(cocob_alpha, st["sig"], st["m_sig"], st["v_sig"],
                                           g_sig, r_sig, t_sig, dsig)
        sel = take(ALGO_CODES[ALGO_COCOB], xm, xs, v_mu=lm, v_sig=ls)
        new_ext = tuple(torch.where(sel, a, b) for a, b in
                        zip((gm, rm, tm, gs, rs, ts), st["ext"]))
    for rule in (ALGO_DOWG, ALGO_DOG):
        if ALGO_CODES[rule] not in present:
            continue
        dl = st["mu"] - st["m_mu"]
        dx = st["sig"] - st["m_sig"]
        dist = torch.sqrt(torch.sum(dl * dl, dim=1) + torch.sum(dx * dx, dim=1))
        v_prev, r_prev = st["v_mu"][:, 0], st["v_mu"][:, 1]
        r = torch.maximum(dist, r_prev)
        gsq = torch.sum(dmu * dmu, dim=1) + torch.sum(dsig * dsig, dim=1)
        if rule == ALGO_DOWG:
            v = v_prev + r * r * gsq
            e = r * r / torch.sqrt(torch.clamp_min(v, 1e-30))
        else:
            v = v_prev + gsq
            e = r / torch.sqrt(torch.clamp_min(v, 1e-30))
        e = e[:, None]
        v_mu = torch.cat([v[:, None], r[:, None], torch.zeros_like(st["v_mu"][:, 2:])], dim=1)
        sel = take(ALGO_CODES[rule], st["mu"] - e * dmu, st["sig"] - e * dsig, v_mu=v_mu)
        eta = torch.where(sel, e, eta)
    if ALGO_CODES[ALGO_DESCENT] in present:
        sel = take(ALGO_CODES[ALGO_DESCENT], st["mu"] - lr * dmu, st["sig"] - lr * dsig)
        eta = torch.where(sel, lr, eta)
    st.update(new)
    st["ext"] = new_ext
    return eta


def fused_chains_run_chunk_reference(
    model: str, consts, scalars, state, seeds, it0: int, steps: int, n_samples: int,
    hyp: FusedHyper, noise=None, log_every: int = 0, branch: FusedBranch = DEFAULT_BRANCH,
    lrs=None, rules=None, ad=None,
):
    """Plain version of csrc/fused_chains.cu: one Python loop over steps on
    tensors with a leading chain axis, the single-chain kernel's math per
    chain.  ``state``: (C, n_rows, d) (STATE_FIELDS, then COCOB's six ext
    rows); ``seeds``: (C, 2) int32 tensor of the chains' uint32 Philox words
    (``FusedChainsADVI.chain_seeds``); ``noise``:
    optional (steps, C, n_samples, d); ``lrs``: optional (C,) learning rates
    replacing ``hyp.lr``; ``rules``: optional (C,) RULE_CODES replacing
    ``branch.algo``; ``ad``: model "ad"'s program (replayed on each chain's
    n rows).  Returns ``(state, elbo (C,), trace (steps // log_every,
    C) or None)``."""
    branch.codes()
    C, n_rows, d = state.shape
    dev = state.device
    n = n_samples
    inv_n = _f32(1.0 / n)
    parts = state.unbind(1)
    st = dict(zip(STATE_FIELDS, parts[:8]))
    st["ext"] = tuple(parts[8:])
    codes = _chain_codes(branch, rules, C, dev)
    lr = (torch.full((C, 1), _f32(hyp.lr), dtype=torch.float32, device=dev) if lrs is None
          else lrs.to(device=dev, dtype=torch.float32).reshape(C, 1))
    keys = seeds.to(device=dev, dtype=torch.int64)
    vargrad = branch.grad_est == GE_SCOREGRAD
    elbo = torch.zeros(C, dtype=torch.float32, device=dev)
    trace = []
    for s in range(steps):
        it = it0 + s
        u = noise[s] if noise is not None else philox_normals_reference(keys, it, n, d,
                                                                         device=dev)
        mu, sig = st["mu"], st["sig"]
        z = mu[:, None] + sig[:, None] * u
        logpi, grad = _model_logpi_grad(model, consts, scalars, z.reshape(C * n, d), it, ad)
        logpi, grad = logpi.reshape(C, n), grad.reshape(C, n, d)
        logdet = torch.sum(torch.log(sig), dim=1)
        if vargrad:
            logq = -(torch.sum(0.5 * u * u, dim=2) + logdet[:, None] + 0.5 * d * _L2PI)
            f = logq - logpi
            ci = ((f - inv_n * torch.sum(f, dim=1, keepdim=True)) * inv_n)[..., None]
            dmu = torch.sum(ci * (u / sig[:, None]), dim=1)
            dsig = torch.sum(ci * ((u * u - 1.0) / sig[:, None]), dim=1)
            elbo = inv_n * torch.sum(logpi - logq, dim=1)
        else:
            cf = branch.entropy == ENT_CF_ZERO
            g_z = -inv_n * (grad if cf else grad + u / sig[:, None])
            dmu = torch.sum(g_z, dim=1)
            dsig = torch.sum(g_z * u, dim=1)
            if branch.entropy == ENT_STL_ZERO:
                dsig = dsig + 1.0 / sig
            if cf:
                ent = logdet + 0.5 * d * (1.0 + _L2PI)
            else:
                ent = logdet + inv_n * (0.5 * torch.sum(u * u, dim=(1, 2))) + 0.5 * d * _L2PI
            elbo = inv_n * torch.sum(logpi, dim=1) + ent
        c = np.float32(it) + np.float32(1.0)
        eta = _chains_rule_step(codes, hyp, lr, c, st, dmu, dsig, branch.cocob_alpha)
        if branch.operator == OP_CLIP:
            st["sig"] = torch.clamp_min(st["sig"], hyp.clip_eps)
        elif branch.operator == OP_PROX:
            st["sig"] = _prox(st["sig"], eta)
        st["avg_mu"] = _avg(hyp, c, st["avg_mu"], st["mu"])
        st["avg_sig"] = _avg(hyp, c, st["avg_sig"], st["sig"])
        if log_every and (s + 1) % log_every == 0:
            trace.append(elbo)
    out = torch.stack([st[f] for f in STATE_FIELDS] + list(st["ext"]), dim=1)
    tr = _trace_out(trace, log_every, dev)
    if tr is not None and tr.numel() == 0:
        tr = tr.reshape(0, C)
    return out, elbo, tr


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_CHAINS_ARGTYPES = (
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_float]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 7
    + [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_float] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_void_p] * 2  # the workspace, the stream
)


# Chains a block at most (csrc/fused_chains.cu kMaxChains: their ELBO
# threads are lanes of one warp), and the block's threads (kThreads: G > 1
# maps one lane of a chain to a thread, so it needs d <= 512, but on the
# diagonal Gaussian's kGauss group).
MAX_CHAINS_PER_BLOCK = 32
BLOCK_THREADS = 512


def chains_per_block(model: str, n_chains: int, sms: int, d: int,
                     block_bytes: Callable[[int], int], device_layout: bool = False) -> int:
    """G, the chains a block of one K6 launch: 1 while ``n_chains <= sms``
    (the single-chain body, one chain an SM), else the chains spread evenly
    over the fewest waves of ``sms`` blocks that G_max allows: W =
    ceil(C / (SMs G_max)) waves, G = ceil(C / (SMs W)).  G_max is the
    largest G <= MAX_CHAINS_PER_BLOCK whose block's shared memory,
    ``block_bytes(G)`` (the kernel's ``fused_chains_smem_bytes``), fits one
    block.  While C <= SMs G_max that is min(G_max, ceil(C / SMs)); above,
    the fewest chains a block that keep the waves at W (a block of G chains
    takes longer than one of G - 1, so a G that fills no fewer waves is
    slower).  1 for model "ad" (K5's body is placed for one chain), for
    d > 512 but on the diagonal Gaussian (its kGauss blocks take the G
    chains' 4-column groups in turn, csrc/fused_gauss_body.cuh) and for a
    ``device_layout``: a chain whose arrays need the device workspace (the
    kWide layout at tier 2 or 3, the kMbWide one at any tier) runs alone."""
    if model == AD or n_chains <= sms or device_layout or \
            (d > BLOCK_THREADS and model != GAUSSIAN):
        return 1
    g_max = 1
    for g in range(2, min(-(-n_chains // sms), MAX_CHAINS_PER_BLOCK) + 1):
        if block_bytes(g) > _build.SMEM_LIMIT:
            break
        g_max = g
    waves = -(-n_chains // (sms * g_max))
    return -(-n_chains // (sms * waves))


def chains_smem_bytes(body=None):
    """``fused_chains_smem_bytes(code, n_data, db, batch, n, d, n_rows, G)``
    of csrc/fused_chains.cu (the library built with the generated ``body``,
    if any): a block's dynamic shared memory, at G = 1 the single-chain
    layout, else the model's data once and each per-chain array G times."""
    return _build.function("fused_chains", "fused_chains_smem_bytes", [ctypes.c_int] * 8,
                           restype=ctypes.c_size_t, body=body)


def device_sms(dev) -> int:
    """The streaming multiprocessors of the card ``dev`` names."""
    return torch.cuda.get_device_properties(torch.device(dev)).multi_processor_count


_RULE_SETS: dict = {}


def rule_set(rules: torch.Tensor) -> frozenset:
    """The distinct codes of a (C,) rules tensor.  Reading a card tensor
    waits for the card, so the set is kept per tensor (and read again after
    an in-place change): a sweep's launches do not sync the host."""
    hit = _RULE_SETS.get(id(rules))
    if hit is not None and hit[0]() is rules and hit[1] == rules._version:
        return hit[2]
    codes = frozenset(int(c) for c in rules.tolist())
    key = id(rules)
    _RULE_SETS[key] = (weakref.ref(rules, lambda _: _RULE_SETS.pop(key, None)),
                       rules._version, codes)
    return codes


def launch_groups(model: str, branch: FusedBranch, rules=None) -> Tuple[str, ...]:
    """The LAUNCH_GROUPS a chains launch runs: the branch's, with a mixed
    sweep counted in the rules group when any chain's rule is not Adam."""
    groups = list(FusedBranch(ALGO_ADAM, branch.entropy, branch.grad_est,
                              branch.operator).groups(model)
                  if rules is not None else branch.groups(model))
    if rules is not None and rule_set(rules) - {ALGO_CODES[ALGO_ADAM]} \
            and GROUP_RULES not in groups:
        groups.insert(0, GROUP_RULES)
    return tuple(groups)


def fused_chains_run_chunk_cuda(
    model: str, consts, scalars, state, seeds, it0: int, steps: int, n_samples: int,
    hyp: FusedHyper, noise=None, log_every: int = 0, branch: FusedBranch = DEFAULT_BRANCH,
    lrs=None, rules=None, ad=None, instrumented: bool = False,
):
    """Launch csrc/fused_chains.cu on the current stream, ``chains_per_block``
    chains a block (same signature and results as
    ``fused_chains_run_chunk_reference``).  Adds one to
    ``fused_chains_run_chunk_cuda.launches`` per launch, and to each of its
    LAUNCH_GROUPS in ``group_launches``.  ``instrumented`` launches the
    build with per-phase cycle counters instead (PHASE_CLOCKS; read block
    0's with ``chains_phase_cycles``)."""
    dev = state.device
    if not state.is_cuda:
        raise ValueError(f"fused_chains_run_chunk_cuda needs CUDA tensors, got {dev}")
    C, n_rows, d = state.shape
    n = int(n_samples)
    codes = branch.codes()
    if rules is not None:
        rules = rules.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(rules.shape) != (C,):
            raise ValueError(f"rules must have shape ({C},), got {tuple(rules.shape)}")
        present = rule_set(rules)
        dist = bool(present & {ALGO_CODES[ALGO_DOWG], ALGO_CODES[ALGO_DOG]})
        cocob = ALGO_CODES[ALGO_COCOB] in present
    else:
        dist = branch.algo in (ALGO_DOWG, ALGO_DOG)
        cocob = branch.algo == ALGO_COCOB
    if dist and d < 2:
        raise ValueError(f"DoWG and DoG keep [v, r] in lanes 0 and 1 of v_mu: they need "
                         f"d >= 2, got {d}")
    if branch.grad_est == GE_SCOREGRAD and n < 2:
        raise ValueError(f"VarGrad needs n_samples >= 2, got {n}")
    if n_rows not in (8, 14) or (cocob and n_rows != 14):
        raise ValueError(f"the state needs 8 rows, 14 with COCOB chains: got {n_rows}")
    check_f32("state", state, (C, n_rows, d), dev)
    if lrs is not None:
        check_f32("lrs", lrs, (C,), dev)
    c0, c1, n_data, db, batch, s0, s1 = _model_args(model, consts, scalars, d, dev, n, ad)
    if model == MVNORMAL:
        c1 = kernel_precision(c1)
    if noise is not None:
        check_f32("noise", noise, (steps, C, n, d), dev)
        noise = noise.transpose(0, 1).contiguous()  # the kernel's (C, steps, n, d)
    if log_every and steps % log_every:
        raise ValueError(f"traced chunks need steps % log_every == 0, got {steps}/{log_every}")
    code = MODEL_CODES[model]
    body = ad.source if model == AD else None
    defines = PHASE_CLOCKS if instrumented else ()
    smem_bytes = chains_smem_bytes(body)
    layout = fused_layout("fused_chains", body, defines)
    shape = (code, n_data, db, batch, n, d, n_rows)
    G = chains_per_block(model, C, device_sms(dev), d, lambda g: smem_bytes(*shape, g),
                         layout(*shape, 1)[2] > 0)
    group, smem, ws_floats, tier = layout(*shape, G)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"each chain's block keeps its state rows, its row sums and the block "
            f"reduction in shared memory at its last tier: {smem} bytes for "
            f"n_data={n_data}, batch={batch}, d={d}, n={n}, {n_rows} state rows is over "
            f"the {_build.SMEM_LIMIT}-byte limit"
        )
    ws = workspace(C * ws_floats, dev, "fused_chains")
    fn = _build.function("fused_chains", "fused_chains", _CHAINS_ARGTYPES, body=body,
                         defines=defines)
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (C, 2) or seeds.device != dev \
            or not seeds.is_contiguous():
        raise ValueError(f"seeds must be a contiguous int32 ({C}, 2) tensor on {dev}")
    out = torch.empty_like(state)
    elbo = torch.empty(C, dtype=torch.float32, device=dev)
    rows_out = steps // log_every if log_every else 0
    trace = torch.empty((C, rows_out), dtype=torch.float32, device=dev) if log_every else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            code, c0.data_ptr(), c1.data_ptr(), n_data, db, batch, s0, s1,
            state.data_ptr(), out.data_ptr(), elbo.data_ptr(),
            trace.data_ptr() if trace is not None else None,
            noise.data_ptr() if noise is not None else None,
            C, G, n, d, n_rows, steps, log_every, seeds.data_ptr(), it0,
            lrs.data_ptr() if lrs is not None else None,
            rules.data_ptr() if rules is not None else None,
            hyp.lr, hyp.b1, hyp.b2, hyp.eps, hyp.avg_eta, hyp.clip_eps,
            *codes, branch.cocob_alpha, ws.data_ptr() if ws is not None else None, stream,
        )
    _build.check(err, f"fused_chains launch (group {group}, tier {tier}, G = {G})")
    fused_chains_run_chunk_cuda.launches += 1
    for g in launch_groups(model, branch, rules) + layout_groups(model, group, tier):
        fused_chains_run_chunk_cuda.group_launches[g] += 1
    return out, elbo, (trace.T.contiguous() if trace is not None else None)


fused_chains_run_chunk_cuda.launches = 0
fused_chains_run_chunk_cuda.group_launches = dict.fromkeys(LAUNCH_GROUPS, 0)


def chains_phase_cycles() -> dict:
    """SM cycles that thread 0 of block 0 of the instrumented chains kernel
    spent in each mean-field phase (MF_PHASES) over the launches since the
    last call, summed; the counters restart at zero.  Waits for the queued
    work."""
    fn = _build.function("fused_chains", "fused_chains_phase_cycles", [ctypes.c_void_p],
                         defines=PHASE_CLOCKS)
    out = (ctypes.c_ulonglong * len(MF_PHASES))()
    _build.check(fn(ctypes.addressof(out)), "fused_chains_phase_cycles")
    return dict(zip(MF_PHASES, out))


def fused_chains_run_chunk(model, consts, scalars, state, seeds, it0, steps, n_samples, hyp,
                           noise=None, log_every=0, branch=DEFAULT_BRANCH, lrs=None,
                           rules=None, ad=None, interpret=False):
    """The chains kernel for CUDA tensors, its plain version for CPU tensors
    or when ``interpret`` asks for it."""
    args = (model, consts, scalars, state, seeds, it0, steps, n_samples, hyp, noise,
            log_every, branch, lrs, rules, ad)
    if interpret:
        return fused_chains_run_chunk_reference(*args)
    if state.is_cuda:
        return fused_chains_run_chunk_cuda(*args)
    if state.device.type == "cpu":
        return fused_chains_run_chunk_reference(*args)
    raise ValueError(f"no fused chains engine for device {state.device}")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _is_array(x) -> bool:
    return isinstance(x, (list, tuple)) or (hasattr(x, "shape") and tuple(x.shape) != ())


class FusedChainsADVI:
    """C independent mean-field chains of the fused engine in one kernel
    launch per chunk; the engine runs where the model's tensors lie.

    Per-chain semantics are ``FusedADVI``'s (by default ADVI + STL + Adam +
    ClipScale + polynomial averaging; ``optimizer``, ``entropy``,
    ``grad_est`` and ``operator`` pick the other branches, as the JAX
    engine's arguments).  ``lr`` may be an ``(n_chains,)`` array (an Adam or
    descent step-size sweep) and ``optimizer`` a list of ``n_chains`` rule
    names (a mixed sweep).  Chains share the model and the other
    hyperparameters.  ``interpret=True`` runs the kernel's plain PyTorch
    version on any device."""

    def __init__(
        self,
        model: FusedModelSpec,
        n_chains: int,
        n_samples: int = 10,
        lr=1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        avg_eta: float = 8.0,
        clip_eps: float = 1e-5,
        interpret: bool = False,
        optimizer=ALGO_ADAM,
        entropy: str = ENT_STL,
        grad_est: str = GE_REPGRAD,
        operator: str = OP_CLIP,
        alpha: float = 1e-6,
    ):
        self.interpret = bool(interpret)
        self._rule_list = None
        if optimizer == MIXED:
            raise ValueError(
                "pass the per-chain rule NAMES as a list/tuple (e.g. "
                "optimizer=['adam', 'dowg', ...]), not the string 'mixed'"
            )
        if isinstance(optimizer, (list, tuple)):
            if len(optimizer) != n_chains:
                raise ValueError(
                    f"per-chain optimizer needs {n_chains} entries, got {len(optimizer)}"
                )
            bad = [o for o in optimizer if o not in RULE_CODES]
            if bad:
                raise ValueError(f"unknown optimizers in sweep: {bad!r}")
            if operator == OP_PROX:
                raise ValueError(
                    "operator='prox' is not supported with a mixed rule "
                    "sweep (the step size is undefined on adam/cocob rows)"
                )
            self._rule_list = tuple(optimizer)
            optimizer = MIXED
        if optimizer != MIXED and optimizer not in RULE_CODES:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if entropy not in (ENT_STL, ENT_CF_ZERO, ENT_STL_ZERO):
            raise ValueError(f"unknown entropy {entropy!r}")
        if grad_est not in (GE_REPGRAD, GE_SCOREGRAD):
            raise ValueError(f"unknown grad_est {grad_est!r}")
        if operator not in (OP_CLIP, OP_PROX, OP_NONE):
            raise ValueError(f"unknown operator {operator!r}")
        if operator == OP_PROX:
            if optimizer not in ETA_ALGOS:
                raise ValueError(
                    "operator='prox' needs an extractable step size: use "
                    f"one of {ETA_ALGOS}"
                )
            if grad_est == GE_SCOREGRAD or entropy == ENT_STL:
                raise ValueError(
                    "operator='prox' pairs with the zero-gradient RepGrad "
                    "entropies (closed_form_zero_grad / stl_zero_grad)"
                )
        if grad_est == GE_SCOREGRAD and n_samples < 2:
            raise ValueError(
                "the VarGrad estimator needs n_samples >= 2 (sample "
                f"variance), got {n_samples}"
            )
        if n_chains < 1 or n_samples < 1:
            raise ValueError(f"n_chains and n_samples must be >= 1, got {n_chains}, {n_samples}")
        if model.model not in PORTED_MODELS:
            raise ValueError(f"unknown fused model {model.model!r}; known: {PORTED_MODELS}")
        if model.dim > D_PAD_MAX:
            raise ValueError(f"fused engine supports dim <= {D_PAD_MAX}, got {model.dim}")
        rules = self._rule_list or (optimizer,)
        self.n_rows = 14 if ALGO_COCOB in rules else 8
        self.ad = ad_program(model, n_samples, MEANFIELD, self.n_rows) \
            if model.model == AD else None
        if model.dim < 2 and (ALGO_DOWG in rules or ALGO_DOG in rules):
            raise ValueError(
                f"DoWG and DoG keep [v, r] in lanes 0 and 1 of v_mu: they need d >= 2, "
                f"got {model.dim}"
            )
        self.model = model
        self.dim = model.dim
        self.n_chains = n_chains
        self.n_samples = n_samples
        dev = model.device
        self.lrs = None
        if _is_array(lr):
            if optimizer == MIXED:
                if not any(o in (ALGO_ADAM, ALGO_DESCENT) for o in self._rule_list):
                    raise ValueError(
                        "per-chain lr with a mixed sweep needs at least "
                        "one adam/descent row (the other rules never read lr)"
                    )
            elif optimizer not in (ALGO_ADAM, ALGO_DESCENT):
                raise ValueError(
                    f"per-chain lr sweeps need a step-size-driven optimizer "
                    f"('{ALGO_ADAM}' or '{ALGO_DESCENT}'); "
                    f"optimizer={optimizer!r} never reads lr"
                )
            lrs = torch.as_tensor(np.asarray(lr, dtype=np.float32)).to(dev)
            if tuple(lrs.shape) != (n_chains,):
                raise ValueError(
                    f"per-chain lr must have shape ({n_chains},), got {tuple(lrs.shape)}"
                )
            self.lrs = lrs.contiguous()
            lr_scalar = 0.0
        else:
            lr_scalar = float(lr)
        self.lr = lr
        self.hyp = FusedHyper(lr_scalar, b1, b2, eps, avg_eta, clip_eps)
        self.algo = optimizer
        self.entropy = entropy
        self.grad_est = grad_est
        self.operator = operator
        self.alpha = alpha
        self.cocob_alpha = 100.0  # COCOB's bet-fraction floor (optim/rules.py)
        self.rules = None
        if self._rule_list is not None:
            self.rules = torch.tensor([RULE_CODES[o] for o in self._rule_list],
                                      dtype=torch.int32, device=dev)
        self._seeds = (None, None)

    def branch(self) -> FusedBranch:
        """The kernel branch (a mixed sweep's chains take their own rules)."""
        algo = ALGO_ADAM if self.algo == MIXED else self.algo
        return FusedBranch(algo, self.entropy, self.grad_est, self.operator,
                           float(self.cocob_alpha))

    def init(self, locations: torch.Tensor, scale_diags: torch.Tensor) -> FusedChainsState:
        """``locations``/``scale_diags``: (n_chains, d) stacked per-chain
        initial parameters (e.g. from a jittered common start).  The rules'
        slots follow the JAX engine's layout, per chain in a mixed sweep."""
        C, d = self.n_chains, self.dim
        dev = self.model.device
        if tuple(locations.shape) != (C, d):
            raise ValueError(f"expected ({C}, {d}) locations, got {tuple(locations.shape)}")
        if tuple(scale_diags.shape) != (C, d):
            raise ValueError(f"expected ({C}, {d}) scale_diags, got {tuple(scale_diags.shape)}")
        mu = locations.detach().to(device=dev, dtype=torch.float32).clone()
        sig = scale_diags.detach().to(device=dev, dtype=torch.float32).clone()
        zeros = torch.zeros_like(mu)
        rules = self._rule_list or (self.algo,) * C
        copy = torch.tensor([o in (ALGO_DOWG, ALGO_DOG, ALGO_COCOB) for o in rules],
                            device=dev)[:, None]
        pf = torch.tensor([o in (ALGO_DOWG, ALGO_DOG) for o in rules], device=dev)
        # x0 / x1 in m_* for DoWG, DoG and COCOB chains; r0 = alpha (1 + ||x0||)
        # over the chain's own entries in lane 1 of v_mu for DoWG and DoG
        norm0 = torch.sqrt(torch.sum(mu * mu, dim=1) + torch.sum(sig * sig, dim=1))
        r0 = torch.where(pf, np.float32(self.alpha) * (1.0 + norm0), torch.zeros_like(norm0))
        v_mu = zeros.clone()
        if d >= 2:
            v_mu[:, 1] = r0
        ext = None
        if self.n_rows == 14:
            ext = tuple(zeros.clone() for _ in range(6))
        return FusedChainsState(
            mu=mu, sig=sig, m_mu=torch.where(copy, mu, zeros), v_mu=v_mu,
            m_sig=torch.where(copy, sig, zeros), v_sig=zeros.clone(), avg_mu=mu.clone(),
            avg_sig=sig.clone(), iteration=0,
            elbo=torch.zeros(C, dtype=torch.float32, device=dev), ext=ext,
        )

    def chain_seeds(self, key: SeedLike) -> torch.Tensor:
        """The uint32 Philox words of the chains of a run keyed by ``key``
        (``chain_seed_words``) as a (n_chains, 2) int32 tensor on the
        model's device; the last key's is kept, so a run's chunks make and
        copy it once."""
        words = seed_words(key)
        if self._seeds[0] != words:
            bits = chain_seed_table(words, self.n_chains).numpy().astype(np.uint32)
            self._seeds = (words, torch.from_numpy(bits.view(np.int32)).to(self.model.device))
        return self._seeds[1]

    def run_chunk(self, state: FusedChainsState, key: SeedLike, steps: int,
                  noise: Optional[torch.Tensor] = None) -> FusedChainsState:
        """Advance every chain ``steps`` iterations in one launch.  ``key``:
        an int, two seed words or a ``PhiloxKey``; chain c draws under
        ``chain_seed_words(key, c)``.  ``noise``: optional (steps, n_chains,
        n_samples, d) base draws replacing the Philox streams."""
        return self._run(state, key, steps, noise, 0)[0]

    def run_chunk_traced(self, state: FusedChainsState, key: SeedLike, steps: int,
                         log_every: int, noise: Optional[torch.Tensor] = None):
        """Like ``run_chunk``, and also returns the per-chain ELBO trace: a
        ``(steps // log_every, n_chains)`` tensor of every chain's estimate
        at each ``log_every``-th step, recorded in the kernel (feed it to
        ``first_chain_divergence``)."""
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        return self._run(state, key, steps, noise, log_every)

    def _run(self, state, key, steps, noise, log_every, chains=None, gather=None):
        """The launch of ``run_chunk(_traced)``; ``chains=(c0, count)``
        launches those chains alone (a rank's block in ``run_sharded``), and
        ``gather`` turns their (rows, ELBOs, trace) into every chain's."""
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        if log_every and steps % log_every:
            raise ValueError(
                f"traced chunks need steps % log_every == 0, got {steps}/{log_every}"
            )
        if self.n_rows == 14 and state.ext is None:
            if self.algo == MIXED:
                raise ValueError(
                    "this mixed sweep contains cocob rows; init() the state "
                    "with this engine so the ext accumulators exist"
                )
            raise ValueError(
                "COCOB needs a state created with optimizer='cocob' "
                "(its ext accumulators are missing)"
            )
        dev = self.model.device
        C, n, d = self.n_chains, self.n_samples, self.dim
        if noise is not None:
            noise = noise.to(device=dev, dtype=torch.float32).contiguous()
            expect = (steps, C, n, d)
            if tuple(noise.shape) != expect:
                raise ValueError(f"noise must have shape {expect}, got {tuple(noise.shape)}")
        if steps == 0:
            empty = torch.zeros((0, C), dtype=torch.float32, device=dev)
            return state, (empty if log_every else None)
        with_ext = self.n_rows == 14
        keep = None if with_ext else state.ext  # another rule's ext rows ride through
        consts = self.model.consts if self.ad is None else self.ad.consts
        sl = slice(None) if chains is None else slice(chains[0], chains[0] + chains[1])
        rows, elbo, trace = fused_chains_run_chunk(
            self.model.model, consts, self.model.scalars,
            state.stacked(with_ext=with_ext)[sl], self.chain_seeds(key)[sl], state.iteration,
            steps, n, self.hyp, noise, log_every, self.branch(),
            None if self.lrs is None else self.lrs[sl], self.rules, self.ad,
            interpret=self.interpret,
        )
        if gather is not None:
            rows, elbo, trace = gather(rows, elbo, trace)
        new = FusedChainsState.from_stacked(rows, state.iteration + steps, elbo, keep)
        return new, trace

    def run_sharded(self, state: FusedChainsState, key: SeedLike, steps: int, mesh,
                    axis: str = "mc", log_every: int = 0):
        """``run_chunk`` with the chain axis over ``mesh[axis]``: each rank
        launches the kernel once on its contiguous block of chains
        [i C / R, (i + 1) C / R) and the blocks are gathered, in chain order,
        on every rank (no other collective).  Chain c draws under the run's
        chain key ``chain_seed_words(key, c)`` whatever rank runs it, so the
        result is bit for bit the one-rank ``run_chunk``.  A per-chain lr
        sweep takes the block's lrs.  Needs n_chains a multiple of 8 and of
        the axis size, the block a multiple of 8 (the JAX engine's checks).

        ``log_every > 0`` returns ``(state, trace)`` with the per-chain ELBO
        trace in global chain order (feed it to ``first_chain_divergence``);
        0 returns the state."""
        from ...parallel.mesh import all_gather_rows, block, use_mesh

        n_dev = mesh.size(mesh.mesh_dim_names.index(axis))
        if self.rules is not None:
            raise ValueError(
                "run_sharded does not yet support mixed per-chain rule "
                "sweeps; run them single-device (one dispatch) or build "
                "one engine per device"
            )
        if self.n_chains % 8 or self.n_chains % n_dev:
            raise ValueError(
                f"run_sharded needs n_chains (= {self.n_chains}) to be a "
                f"multiple of 8 and of the '{axis}' axis size {n_dev}"
            )
        c_loc = self.n_chains // n_dev
        if c_loc % 8:
            raise ValueError(
                f"per-device chain block {c_loc} must be a multiple of 8"
            )
        if log_every < 0:
            raise ValueError(f"log_every must be >= 0, got {log_every}")
        C = self.n_chains

        def gather(rows, elbo, trace):  # every rank's block, in chain order
            with use_mesh(mesh):
                return (all_gather_rows(rows, C, axis), all_gather_rows(elbo, C, axis),
                        all_gather_rows(trace, C, axis, dim=1) if log_every else trace)

        c0, _ = block(C, n_dev, mesh.get_local_rank(axis))
        new, trace = self._run(state, key, steps, None, log_every, (c0, c_loc), gather)
        return (new, trace) if log_every else new

    def chains_per_block(self, sms: Optional[int] = None, block_bytes=None) -> int:
        """G, the chains each block of this engine's launches takes on a card
        of ``sms`` SMs (default: the model's card), by ``chains_per_block``;
        ``block_bytes(code, n_data, db, batch, n, d, n_rows, G)`` gives a
        block's shared memory (default: the kernel's own count,
        ``chains_smem_bytes``)."""
        if self.ad is not None:
            return 1
        _, _, n_data, db, batch, _, _ = _model_args(
            self.model.model, self.model.consts, self.model.scalars, self.dim,
            self.model.device, self.n_samples)
        fn = chains_smem_bytes() if block_bytes is None else block_bytes
        shape = (MODEL_CODES[self.model.model], n_data, db, batch, self.n_samples, self.dim,
                 self.n_rows)
        device_layout = block_bytes is None and fused_layout("fused_chains")(*shape, 1)[2] > 0
        return chains_per_block(self.model.model, self.n_chains,
                                device_sms(self.model.device) if sms is None else sms, self.dim,
                                lambda g: fn(*shape, g), device_layout)

    def q(self, state: FusedChainsState, averaged: bool = True):
        """Stacked MeanFieldGaussian with (n_chains, d) leaves (averaged
        parameters by default), for the chains helpers (scoring,
        ``best_chain``)."""
        mu, sig = (state.avg_mu, state.avg_sig) if averaged else (state.mu, state.sig)
        return MeanFieldGaussian(mu, sig)


def first_chain_divergence(trace, log_every: int):
    """First non-finite entry of a per-chain ELBO trace, as ``(chain,
    iteration)``, or None if every entry is finite.  ``trace``: the
    ``(G, n_chains)`` trace of ``run_chunk_traced``; ``iteration`` is
    chunk-relative (row g records the ELBO after ``(g + 1) * log_every``
    steps)."""
    if isinstance(trace, torch.Tensor):
        trace = trace.detach().cpu().numpy()
    bad = ~np.isfinite(np.asarray(trace))
    if not bad.any():
        return None
    g, c = np.argwhere(bad)[0]  # earliest row, lowest chain
    return int(c), int((g + 1) * log_every)
