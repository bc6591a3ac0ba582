#!/usr/bin/env python3
"""Smoke run of the PyTorch port (advancedvi_jl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--parent OTHER_CHECKOUT]

It builds the port's CUDA kernels from advancedvi_jl_tpu_torch/csrc with
nvcc, holds each kernel against its plain PyTorch version on the card, and
drives the port's paths through the entry points a user calls.  The
flagship path: mean-field ADVI + STL, 10 samples, Adam(1e-3), ClipScale,
polynomial averaging on the 208 x 61 hierarchical logistic regression,
d = 62, through ``optimize`` with ``KLMinRepGradDescent`` and
``FusedLogRegADVI.optimize``.  The full-rank paths: ``optimize`` with
``FullRankGaussian`` at d = 1024 and 256 samples a step (solve-free
normal_fullrank_wellcond target, the K8 solve), and
``FusedADVI(family="fullrank")`` on the logreg (d = 62) and on a dense
Gaussian (d = 512).  The measure-space paths: ``optimize`` with each
measure-space algorithm on the logreg and a d = 256 Gaussian, with
``WithTermination``, and ``pathfinder`` / ``multipath_pathfinder``.  The proximal and score-gradient paths:
``optimize`` with ``KLMinRepGradProxDescent`` and ``KLMinScoreGradDescent``
and ``FusedProxADVI.optimize`` / ``FusedScoreGradVI.optimize`` on the
flagship, and full-rank proximal ADVI on normal-lognormal (d = 11).
Phases:

  (a) the card (nvidia-smi name and power limit);  (b) kernel builds;
  (c) the mean-field sampler against its plain version, normal statistics,
      and a CUDA graph of its launches reading the iteration from a device
      word against host-int launches, bit for bit;
  (d) the fused kernel against its plain version with injected noise;
  (e) the fused kernel with in-kernel Philox: chunking, tracing, plain version;
  (f) the general path on the card;  (g) the fused engine on the card;
  (h) steps/s of both paths and each kernel's time beside its plain version
      (the sampler also by CUDA-graph replay, without the wrapper's host time,
      beside an empty kernel of its geometry: the launch floor; behind a
      kernel that writes its input; and its host time a call by the host
      clock); the flagship step's phase split (an instrumented build's
      counters);
  (i) the full-rank sampler (K7b) against its plain version and K7a's draws
      at the main path's, ragged and bench_large's shapes, C with NaN above
      its diagonal: u bitwise, z within 1e-6 and bitwise across two calls;
  (j) the triangular solve (K8), both modes, against a float64 solve and
      its plain version at the main path's and at ragged shapes (n from 1
      to 300, d from 1 to 1,024), every rows-a-block choice bit-equal;
  (k) the full-rank fused kernel (K3-FR) against its plain version at
      d = 62 (logreg) and d = 512 (dense Gaussian): noise, Philox, chunking;
      the single-block kernel and the cluster kernel at every cluster size
      (``cluster_blocks``' choice among them), each cluster size bitwise
      the single-block kernel;
  (l) the full-rank paths: ``optimize`` with FullRankGaussian at d = 1024,
      n = 256, the fused full-rank logreg engine to 20,000 steps and the
      dense Gaussian at d = 512 to 1,000 (the cluster kernel's launches
      counted apart), fused vs general on the same key at d = 62 and 512;
  (m) steps/s of the full-rank paths and the new kernels' times beside
      their plain versions; K7b by CUDA-graph replay at 256 x 1024 and
      128 x 2048 beside cuBLAS's product alone (addmm on given draws);
      K8 beside cuBLAS trsm by CUDA events and by
      CUDA-graph replay, at each rows-a-block choice; the full-rank step's
      phase split (an instrumented build's cycle counters) at d = 62 and
      512; the cluster sweep (chunk ms at 1, 2, 4, 8, 16 blocks, the rule's
      choice, ``cudaOccupancyMaxActiveClusters``), the cluster kernel's
      split on rank 0 at each size and a cluster barrier's own cycles; the
      route sweep (every model the cluster serves at several widths under
      four rules, at one block and every size, beside the rule's choice);
  (n) every branch added by the proximal/score-gradient slice (update
      rules, zero-gradient entropies, prox, VarGrad, the diagonal-Gaussian
      body) in both fused kernels against its plain version: noise,
      Philox, chunking, tracing;
  (o) the slice's general paths on the card through ``optimize``;
  (p) the slice's fused engines: 20,000 steps on the flagship, fused vs
      general on one key, full-rank prox against the analytic optimum;
  (q) steps/s of the slice's fused engines beside their plain versions,
      and of its two mean-field general paths;
  (r) K4's minibatch logreg body in both fused kernels, each slab transport
      (in place, staged, staged + prefetch) against the plain version at
      n = 16,384, B = 512 and at n = 500,000: noise, Philox, chunking,
      tracing, the transports bit-equal;
  (s) the K9 probes against their plain versions, exactly; each probe by
      CUDA-graph replay beside an empty kernel of its geometry, and its host
      time a call;
  (t) the general subsampled paths through ``optimize``: ADVI on the
      16,384 x 61 logreg (B = 512), the BNN of bench_large.py (d = 8,705,
      B = 2,048, ADVI and proximal DoWG), subsampled normals against their
      analytic posterior;
  (u) the fused minibatch engines through ``optimize``: 20,000 steps in
      place at n = 16,384 and staged (with and without prefetch) at
      n = 500,000, reshuffling between chunks; fused vs general on one key
      and one permutation over one epoch; each transport's time beside its
      plain version with its step's phase split (``[u] mf_phase_split=``),
      one reshuffle at n = 500,000, general steps/s;
  (v) the multi-chain kernel (K6) against its plain version at C = 8 on the
      flagship: Adam, a per-chain lr sweep, a mixed rule sweep, prox-DoWG,
      VarGrad, the staged minibatch spec; chunking, tracing, each chain
      against the single-chain kernel, the divergence channel;
  (w) the chains paths: 64 jittered chains through ``FusedChainsADVI`` for
      20,000 steps and ``optimize_chains`` at C = 4 (equal to ``optimize``
      per chain), 1,024 jittered chains for 20,000 steps (several chains a
      block), then 200-step chunks at C = 1 to 4,096 (chain-steps/s, the
      chains a block G beside each), K6 against its plain version and chains
      0, G - 1, G and C - 1 against the single-chain kernel (bitwise) at
      C = 64 and 1,024, and the chains step's phase split;
  (x) the low-rank sampler (K7c) against its plain version and K7a at
      65,536 x 256, rank 8 (timed) and at the shapes of the low-rank ADVI
      runs; low-rank ADVI through ``optimize`` on
      tests/test_lowrank_advi.py's target and on the flagship (rank 8);
  (y) K5, the AD-derived model body: the generated libraries (each
      program's loops, barriers, block products and staged constants; nvcc
      seconds, registers, spills), each against its plain version (the graph's
      replay) in the mean-field, full-rank and chains (C = 64) kernels on
      the flagship logreg through ``ad_spec``, on normal-lognormal and on
      the quartic ``from_log_density`` target; the ad logreg chunk against
      the hand ``logreg_spec`` chunk on one injected noise; the main path
      ``fused_spec_for(fn_target(...))`` at the flagship's width through
      ``FusedADVI.optimize`` (both families), ``FusedProxADVI``,
      ``FusedScoreGradVI`` and ``FusedChainsADVI``, counted; the 200-step
      ad chunk timed beside the hand one with its phase split; and the
      sampler RNG checks (K7c's u2 moments, K7b's and K7c's sample
      covariance at 65,536 draws, 64 chains agreeing on the optimum);
  (z) the measure-space slice: K7b against its plain version and K7a's
      draws at n = 16, 32, 64 x d = 62, 256, 512 and at d = 62 with
      Pathfinder's 250 pooled draws a path and the 20,000-sample ELBO
      (every K7b shape of (l)'s and (z)'s counted runs, recorded there, must
      be one that (i) or (z) checks); NGD (with and without the
      posdef correction, and on the Stein path), sqrt-NGD, Wass (eigh and
      Newton-Schulz) and BaM through ``optimize`` on the flagship logreg
      (d = 62, 2,000 steps) against (l)'s fused full-rank tail, and on a
      d = 256 dense Gaussian (the error halved in 400 steps; BaM's spectrum
      after 150); ``WithTermination(alg, elbo_at_least(x))`` for ADVI and
      NGD, stopping at the dense run's step with its whole state bitwise;
      Pathfinder on the flagship (best ELBO, NGD warm start beside a cold
      one, 8-path k-hat and ESS), counted; steps/s of each algorithm at
      d = 62, 256 and 512, and one NGD, Wass and BaM step at d = 62 and 512
      split by the profiler (kernels, device busy share, cuSOLVER's time,
      host syncs, K7b's card and host time).

With ``--parent CHECKOUT`` (e.g. a ``git archive`` of the parent commit
under the ignored ``_archive/``) it then times K8, K7b, K7a, the K9 probes,
a step of flagship ADVI through ``optimize`` and the chunks of
``ab_chunks`` with that checkout's package and with this one's, a fresh
process each, alternating, each side with the mean-field phase split of
its flagship and minibatch chunks (the other checkout needs the
``instrumented=`` builds, which every commit since the block-product
redesign has), and compares the SASS of every kernel both builds have: each
library but those this tree edits (``AB_CHANGED``) must be the parent's.
The other checkout is copied under this one's ``build/ab_parent`` and timed
there, never built or written in place.

Every failed check raises and the script exits non-zero; it also exits
non-zero without a CUDA device, or when the package is not beside it.  The
line before the last is a JSON object of the kernels (launch counts from the
main-path runs of (f), (g), (l), (o), (p), (s), (u), (w), (x), (y) and (z), errors, times, each
time's bound on this card and, for K8, the library call's time); the last
line is ``{"ok": true, "device": {...}}``.  It imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# bench.py's BENCH_CONFIG (bench.py imports JAX, so the shapes are restated)
N_DATA, N_FEATURES, N_SAMPLES, LR, DATA_SEED = 208, 60, 10, 1e-3, 11
SEED = 0
FUSED_STEPS = 20_000
GENERAL_STEPS = 2_000
LOG_EVERY = 100
TAIL_ROWS = 20  # ELBO at a horizon: mean of the last 20 logged rows
SAMPLER_SHAPE = (65_536, 512)
# the full-rank slice: bench_large.py bench_fullrank_flopbound's first size,
# and the full-rank fused engine at the JAX engine's widest d
FR_D, FR_N = 1024, 256
FR_SHAPE = (FR_N, FR_D)
FR_WIDE_SHAPE = (128, 2048)  # bench_fullrank_flopbound's second size: K7b timed there too
FR_GENERAL_STEPS = 500
FR_FUSED_D = 512
FR_AGREE_STEPS = 2_000  # fused vs general, logreg d = 62
FR_MV_STEPS = 1_000     # fused vs general, mvnormal d = 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, calls: int = 50, replays: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the card without the host: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between two
    CUDA events.  What a call costs the card when nothing waits on the
    wrapper's Python and ctypes work (``cuda_ms`` counts that work whenever it
    outlasts the kernel).  The capture is relaxed: the wrappers set a
    kernel's shared-memory attribute on every call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def host_us(fn, calls: int = 1000) -> float:
    """Mean microseconds of ``fn()`` by the host clock over ``calls``
    back-to-back calls ending in one synchronize (warmed up): the wrapper's
    host time per call wherever it outlasts the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def after_op_ms(fn, op, calls: int = 200) -> float:
    """What ``fn()`` adds to the card's time behind ``op()``, a kernel that
    writes fn's inputs (as the general step's update precedes the sampler):
    graph replay of ``calls`` (op, fn) pairs less that of ``calls`` ops."""
    return graph_ms(lambda: (op(), fn()), calls) - graph_ms(op, calls)


def smi_clocks() -> str:
    """The card's SM clock, power draw and limit and temperature, as
    nvidia-smi reads them now."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=120)
    return f"'{smi.stdout.strip()}'"


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_a():
    if not (ROOT / "advancedvi_jl_tpu_torch" / "__init__.py").is_file():
        fail(f"the package advancedvi_jl_tpu_torch/ is not beside {__file__}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    say("a", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return card


def ptxas_entries(log: str) -> dict:
    """{kernel entry: its registers and spills} from a ``-Xptxas -v`` log;
    K6's entries named ``fused_chains_kernel<general,group>`` (one chain a
    block) and ``fused_chains_g_kernel<general,group>`` (several)."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            m = re.search(r"(fused_chains(?:_g)?_kernel)ILb(\d)ELi(\d)E", name)
            if m:
                name = f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: " ".join(v) for k, v in out.items()}


def phase_b():
    from advancedvi_jl_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    paths = _build.build_all()  # one nvcc per source, all started together
    say("b", kernels=len(paths), build_s=f"{time.perf_counter() - t0:.2f}")
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text()
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        say("b", kernel=name, lib=path.name)
        for ln in ptxas:
            print(f"    {ln}", flush=True)
        if name == "fused_chains":  # each instance: G = 1 and G > 1 chains a block
            for entry, text in ptxas_entries(log).items():
                say("b", chains_instance=entry, ptxas=f"'{text}'")
                check(" 0 bytes spill stores, 0 bytes spill loads" in text,
                      f"K6 instance {entry} spills: {text}")


def phase_c(dev):
    from scipy import stats

    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        meanfield_sample_cuda, meanfield_sample_reference, normal_moments_ok,
        seed_words,
    )

    seed = seed_words(SEED)
    g = torch.Generator().manual_seed(1)
    worst = 0.0
    for n, d in (SAMPLER_SHAPE, (N_SAMPLES, N_FEATURES + 2)):
        loc = torch.randn(d, generator=g).to(dev)
        scale = (0.5 + torch.rand(d, generator=g)).to(dev)
        z, u = meanfield_sample_cuda(seed, 3, loc, scale, n)
        zr, ur = meanfield_sample_reference(seed, 3, loc, scale, n)
        torch.cuda.synchronize()
        u_err, z_err = max_err(u, ur), max_err(z, zr)
        same = bool(torch.equal(u, ur))
        say("c", shape=f"{n}x{d}", u_bitwise=same, u_max_abs_err=u_err,
            z_max_abs_err=z_err)
        if not same:
            print("    u differs from the plain version: the kernel's logf/cosf "
                  "and torch's CUDA log/cos round differently", flush=True)
        check(u_err <= 1e-6, f"sampler u error {u_err} > 1e-6")
        zmax = float(zr.abs().max())
        check(z_err <= 1e-6 * (1.0 + zmax), f"sampler z error {z_err}")
        worst = max(worst, z_err)
        if (n, d) == SAMPLER_SHAPE:
            big_u = u
    # statistics of the base normals
    check(normal_moments_ok(big_u), "sampler moments outside 5 sigma")
    flat = big_u.flatten()[:100_000].double().cpu().numpy()
    ks = stats.kstest(flat, "norm").pvalue
    um = big_u.double()
    um = (um - um.mean(0)) / um.std(0)
    corr = (um[:, :-1] * um[:, 1:]).mean(0).abs().max().item()
    corr4 = (um[:, :-4] * um[:, 4:]).mean(0).abs().max().item()
    bound = 5.0 / math.sqrt(um.shape[0])
    say("c", mean=float(big_u.double().mean()), var=float(big_u.double().var()),
        ks_p=ks, lane_corr_max=corr, lane4_corr_max=corr4, corr_bound=bound)
    check(ks > 1e-3, f"Kolmogorov-Smirnov p-value {ks} <= 1e-3")
    check(corr < bound and corr4 < bound, "lane-to-lane correlation over 5 sigma")
    # step-indexed: the same (seed, it) draws the same, another it does not
    loc = torch.zeros(512, device=dev)
    one = torch.ones(512, device=dev)
    _, a = meanfield_sample_cuda(seed, 7, loc, one, 4096)
    _, b = meanfield_sample_cuda(seed, 7, loc, one, 4096)
    _, c = meanfield_sample_cuda(seed, 8, loc, one, 4096)
    same_frac = float((a == c).double().mean())
    say("c", same_it_equal=bool(torch.equal(a, b)), other_it_equal_frac=same_frac)
    check(torch.equal(a, b), "same (seed, it) gave different draws")
    check(same_frac < 1e-3, "a different iteration gave the same draws")
    # the iteration from a device word: a graph of K launches at offsets
    # 0 .. K-1 and the word's advance draws the host-int launches' iterations
    for n, d, K, it0 in ((N_SAMPLES, N_FEATURES + 2, 20, 100), (33, 5, 8, 2**32 - 3)):
        loc = torch.randn(d, generator=g).to(dev)
        scale = (0.5 + torch.rand(d, generator=g)).to(dev)
        same = device_word_graph_bitwise(seed, loc, scale, n, K, it0)
        say("c", device_word_graph=f"{n}x{d}", K=K, it0=it0, replays=2, bitwise=same)
        check(same, f"device-word launches at {n}x{d} differ from the host-int ones")
    return worst


def device_word_graph_bitwise(seed, loc, scale, n, K, it0) -> bool:
    """Whether two replays of a CUDA graph of K K7a launches reading the
    iteration from a device word (offsets 0 .. K-1, then the word advanced
    by K) equal K host-int launches at it0 .. it0 + 2K - 1, bit for bit."""
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import meanfield_sample_cuda

    word = torch.tensor([it0], dtype=torch.int64, device=loc.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        meanfield_sample_cuda(seed, 0, loc, scale, n, it_word=word)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [meanfield_sample_cuda(seed, k, loc, scale, n, it_word=word) for k in range(K)]
        word.add_(K)
    same = True
    for rep in range(2):
        graph.replay()
        for k, (z, u) in enumerate(outs):
            zh, uh = meanfield_sample_cuda(seed, it0 + rep * K + k, loc, scale, n)
            same &= bool(torch.equal(u, uh)) and bool(torch.equal(z, zh))
    return same and int(word) == it0 + 2 * K


def compare_state(tag, a, b, rtol):
    """Each (d,) state row within ``rtol`` of the plain version, norm-wise:
    max |a - b| <= rtol * max |b|.  The gradients are sums over 208 data
    and 10 samples taken in another order (and with FMAs) by the kernel than
    by torch's CUDA ops, so an entry that cancels to near zero carries an
    absolute error of the size of its terms' rounding, not of its own."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import STATE_FIELDS

    worst, bad = 0.0, []
    for i, f in enumerate(STATE_FIELDS):
        err = max_err(a[i], b[i])
        scale = float(b[i].abs().max())
        worst = max(worst, err)
        print(f"    {f}: max_abs_err={err:.3e} max_abs={scale:.3e} "
              f"rel={err / max(scale, 1e-30):.3e}", flush=True)
        if not err <= rtol * scale:
            bad.append(f)
    check(not bad, f"{tag}: {bad} over rtol {rtol} (norm-wise)")
    return worst


def flagship(dev):
    from advancedvi_jl_tpu_torch.models.logreg import make_logreg

    return make_logreg(DATA_SEED, n_data=N_DATA, n_features=N_FEATURES, device=dev)


def initial_rows(d, dev):
    mu, sig = torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev)
    z = torch.zeros(d, device=dev)
    return torch.stack([mu, sig, z, z, z, z, mu, sig])


def phase_d(dev):
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        FusedHyper, fused_run_chunk_cuda, fused_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    prob = flagship(dev)
    d = prob.dim
    sc = (1.0, 3.0)
    hyp = FusedHyper(lr=LR)
    s0 = initial_rows(d, dev)
    steps = 50
    noise = torch.randn((steps, N_SAMPLES, d), generator=torch.Generator().manual_seed(5)).to(dev)
    args = ("logreg", (prob.X, prob.y), sc, s0, seed_words(SEED), 0, steps, N_SAMPLES, hyp,
            noise)
    k_rows, k_elbo, _ = fused_run_chunk_cuda(*args)
    r_rows, r_elbo, r_tr = fused_run_chunk_reference(*args, log_every=5)
    kt_rows, kt_elbo, k_tr = fused_run_chunk_cuda(*args, log_every=5)
    torch.cuda.synchronize()
    worst = compare_state("fused vs plain, injected noise", k_rows, r_rows, 1e-5)
    e_err = abs(float(k_elbo) - float(r_elbo))
    check(torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4), f"ELBO differs by {e_err}")
    check(torch.allclose(k_tr, r_tr, rtol=1e-5, atol=1e-4), "trace rows differ from the plain version")
    check(torch.equal(kt_rows, k_rows) and torch.equal(kt_elbo, k_elbo),
          "traced and untraced launches differ")
    check(float(k_tr[-1]) == float(k_elbo), "last trace row is not the final ELBO")
    say("d", steps=steps, state_max_abs_err=worst, elbo_kernel=float(k_elbo),
        elbo_plain=float(r_elbo), trace_max_abs_err=max_err(k_tr, r_tr))
    return worst


def phase_e(dev):
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        FusedHyper, fused_run_chunk_cuda, fused_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    prob = flagship(dev)
    d = prob.dim
    sc, hyp, seed = (1.0, 3.0), FusedHyper(lr=LR), seed_words(SEED)
    s0 = initial_rows(d, dev)
    base = ("logreg", (prob.X, prob.y), sc)
    one, e1, _ = fused_run_chunk_cuda(*base, s0, seed, 0, 2000, N_SAMPLES, hyp)
    half, _, _ = fused_run_chunk_cuda(*base, s0, seed, 0, 1000, N_SAMPLES, hyp)
    two, e2, _ = fused_run_chunk_cuda(*base, half, seed, 1000, 1000, N_SAMPLES, hyp)
    tr_rows, tr_e, tr = fused_run_chunk_cuda(*base, s0, seed, 0, 2000, N_SAMPLES, hyp,
                                             log_every=100)
    torch.cuda.synchronize()
    check(torch.equal(one, two) and torch.equal(e1, e2),
          "run_chunk(2000) differs from two run_chunk(1000)")
    check(torch.equal(one, tr_rows) and float(tr[-1]) == float(e1),
          "traced and untraced Philox runs differ")
    say("e", chunked_bitwise=True, traced_bitwise=True, elbo_2000=float(e1))
    k_rows, k_elbo, _ = fused_run_chunk_cuda(*base, s0, seed, 0, 200, N_SAMPLES, hyp)
    r_rows, r_elbo, _ = fused_run_chunk_reference(*base, s0, seed, 0, 200, N_SAMPLES, hyp)
    torch.cuda.synchronize()
    # f32 transcendentals and summation order differ between the kernel and
    # torch's CUDA ops; 200 steps of Adam carry the difference along
    worst = compare_state("fused vs plain, Philox, 200 steps", k_rows, r_rows, 1e-4)
    check(torch.allclose(k_elbo, r_elbo, rtol=1e-4, atol=1e-3), "ELBO after 200 steps differs")
    say("e", steps=200, state_max_abs_err=worst, elbo_kernel=float(k_elbo),
        elbo_plain=float(r_elbo))


class ClusterCount:
    """The full-rank wrapper's count of cluster-kernel launches
    (``cluster_launches``), read and reset as a wrapper's ``launches``."""

    @property
    def launches(self) -> int:
        from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import fused_fullrank_run_chunk_cuda

        return fused_fullrank_run_chunk_cuda.cluster_launches

    @launches.setter
    def launches(self, value: int) -> None:
        from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import fused_fullrank_run_chunk_cuda

        fused_fullrank_run_chunk_cuda.cluster_launches = value


def wrappers():
    """Each kernel's name and its wrapper (whose ``launches`` counts)."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        fused_fullrank_run_chunk_cuda, fused_run_chunk_cuda,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import fused_chains_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        fullrank_sample_cuda, lowrank_sample_cuda, meanfield_sample_cuda,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import probe_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import solve_right_cuda

    return {"meanfield_sample": meanfield_sample_cuda,
            "fused_advi_meanfield": fused_run_chunk_cuda,
            "fullrank_sample": fullrank_sample_cuda,
            "trisolve": solve_right_cuda,
            "fused_advi_fullrank": fused_fullrank_run_chunk_cuda,
            "fused_advi_fullrank_cluster": ClusterCount(),
            "probes": probe_cuda,
            "fused_chains": fused_chains_run_chunk_cuda,
            "lowrank_sample": lowrank_sample_cuda}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0
        for g in getattr(fn, "group_launches", {}):
            fn.group_launches[g] = 0


def read_launches():
    """Each wrapper's count, and each launch group's (LAUNCH_GROUPS: the
    K3 rules, VarGrad and the K4 Gaussian body) summed over both fused
    kernels."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import LAUNCH_GROUPS

    counts = {name: fn.launches for name, fn in wrappers().items()}
    for g in LAUNCH_GROUPS:
        counts[g] = sum(fn.group_launches[g] for fn in wrappers().values()
                        if hasattr(fn, "group_launches"))
    return counts


def tail_elbo(infos) -> float:
    rows = [r["elbo"] for r in infos[-TAIL_ROWS:]]
    return sum(rows) / len(rows)


def main_path(dev):
    """(f) and (g): both entry points, counted launches in between."""
    import advancedvi_jl_tpu_torch as avt

    prob = flagship(dev)
    target = prob.unconstrained()
    d = prob.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                  optimizer=avt.adam(LR), operator=avt.ClipScale())
    eng = avt.FusedLogRegADVI(prob.X, prob.y, n_samples=N_SAMPLES, lr=LR)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    _, infos_g, st_g = avt.optimize(SEED, alg, GENERAL_STEPS, target, q0,
                                    log_every=LOG_EVERY)
    t_general = time.perf_counter() - t0
    counts_f = read_launches()
    elbo_g = infos_g[-1]["elbo"]
    say("f", steps=GENERAL_STEPS, elbo=elbo_g, seconds=f"{t_general:.2f}",
        sampler_launches=counts_f["meanfield_sample"])
    check(math.isfinite(elbo_g), "general path ELBO is not finite")
    check(counts_f["meanfield_sample"] > 0, "the general path launched no sampler kernel")

    t0 = time.perf_counter()
    q_f, infos_f, st_f = eng.optimize(SEED, FUSED_STEPS, q0, log_every=LOG_EVERY)
    t_fused = time.perf_counter() - t0
    # the general path on to the same horizon, warm-started
    _, infos_g2, st_g = avt.optimize(SEED, alg, FUSED_STEPS - GENERAL_STEPS, target,
                                     None, state=st_g, log_every=LOG_EVERY)
    torch.cuda.synchronize()
    counts = read_launches()
    elbo_f, elbo_g = tail_elbo(infos_f), tail_elbo(infos_g2)
    check(all(math.isfinite(r["elbo"]) for r in infos_f), "fused ELBO not finite")
    say("g", steps=FUSED_STEPS, elbo_last=infos_f[-1]["elbo"], elbo_tail_mean=elbo_f,
        general_elbo_tail_mean=elbo_g, seconds=f"{t_fused:.2f}",
        fused_launches=counts["fused_advi_meanfield"])
    check(elbo_f > -150.0, f"fused ELBO {elbo_f} <= -150 (not converged)")
    check(abs(elbo_f - elbo_g) <= 2.0, f"fused {elbo_f} vs general {elbo_g}: over 2.0 apart")
    check(counts["fused_advi_meanfield"] > 0, "the fused engine launched no kernel")
    mu_err = max_err(q_f.location, st_g.avg_state[0].location)
    say("g", averaged_location_max_abs_diff_vs_general=mu_err)
    return counts


def flagship_chunk_args(dev):
    """The arguments of the timed flagship chunk (phase (h), and
    ab_fused_chunk.py's A/B): 200 in-kernel-Philox steps of the flagship
    logreg from the initial rows, keyed by SEED."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedHyper
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    prob = flagship(dev)
    return ("logreg", (prob.X, prob.y), (1.0, 3.0), initial_rows(prob.dim, dev),
            seed_words(SEED), 0, 200, N_SAMPLES, FusedHyper(lr=LR))


# An empty kernel at a launch geometry: what a launch costs the card with no
# work (K7a's: csrc/meanfield_sample.cu's 32 lane groups, two threads each,
# x 4 rows a block; K9's: one block of probe_plan's threads).
LAUNCH_FLOOR = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int gx, int gy, int bx, int by, cudaStream_t stream) {
  empty_kernel<<<dim3(gx, gy), dim3(bx, by), 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def meanfield_geometry(n, d):
    """K7a's (grid, block) at (n, d)."""
    groups = -(-d // 4)
    return (-(-groups // 32), min(-(-n // 4), 65535)), (64, 4)


def launch_floor_ms(geometries):
    """Milliseconds of an empty kernel at each (grid, block) of
    ``geometries`` by CUDA-graph replay, as ``graph_ms`` times the kernels:
    the floor of any launch of that geometry.  Built with the kernels' flags
    into a temporary directory under build/kernels/."""
    import ctypes
    import tempfile

    from advancedvi_jl_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        src, lib = Path(tmp) / "launch_floor.cu", Path(tmp) / "liblaunch_floor.so"
        src.write_text(LAUNCH_FLOOR)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       capture_output=True, text=True, timeout=300, check=True)
        fn = ctypes.CDLL(str(lib)).empty_launch
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        out = []
        for grid, block in geometries:
            def launch(grid=grid, block=block):
                _build.check(fn(*grid, *block, torch.cuda.current_stream().cuda_stream),
                             "empty launch")

            out.append(graph_ms(launch, 200))
        return out


def phase_h(dev, card):
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        fused_run_chunk_cuda, fused_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        meanfield_sample_cuda, meanfield_sample_reference, seed_words,
    )

    prob = flagship(dev)
    d = prob.dim
    seed = seed_words(SEED)
    # fused engine steps/s: one 20k-step launch
    eng = avt.FusedLogRegADVI(prob.X, prob.y, n_samples=N_SAMPLES, lr=LR)
    st = eng.init(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    fused_ms = cuda_ms(lambda: eng.run_chunk(st, seed, FUSED_STEPS), 3)
    # general path steps/s: host clock over 500 steps ending in a sync
    target = prob.unconstrained()
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                  optimizer=avt.adam(LR), operator=avt.ClipScale())
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    s = alg.init(SEED, q0, target)
    for _ in range(50):
        s, _ = alg.step(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        s, _ = alg.step(s)
    torch.cuda.synchronize()
    general_sps = 500 / (time.perf_counter() - t0)
    fused_sps = FUSED_STEPS / (fused_ms / 1e3)
    say("h", card=f"'{card}'", fused_steps_per_s=f"{fused_sps:.1f}",
        general_steps_per_s=f"{general_sps:.1f}")
    # each kernel beside its plain version at the main path's shapes
    loc, sc = torch.zeros(d, device=dev), torch.ones(d, device=dev)
    def sample():
        return meanfield_sample_cuda(seed, 1, loc, sc, N_SAMPLES)

    samp_ms = cuda_ms(sample, 1000)
    samp_graph = graph_ms(sample, 200)
    samp_host_us = host_us(sample)
    samp_after_op = after_op_ms(sample, lambda: loc.mul_(1.0))
    samp_plain = cuda_ms(lambda: meanfield_sample_reference(seed, 1, loc, sc, N_SAMPLES), 50)
    args = flagship_chunk_args(dev)
    fk_ms = cuda_ms(lambda: fused_run_chunk_cuda(*args), 20)
    fr_ms = cuda_ms(lambda: fused_run_chunk_reference(*args), 1)
    # events over back-to-back calls time the wrapper's host work (the kernel
    # is ~2 us), as the host clock does; the graph replay times the card
    # alone; behind an op, what the launch adds after a kernel that writes m
    (floor,) = launch_floor_ms([meanfield_geometry(N_SAMPLES, d)])
    say("h", meanfield_sample_ms=samp_ms, meanfield_sample_graph_ms=samp_graph,
        meanfield_sample_plain_ms=samp_plain, shape=f"{N_SAMPLES}x{d}")
    say("h", card=f"'{card}'", launch_floor_graph_ms=floor, meanfield_sample_graph_ms=samp_graph,
        meanfield_sample_over_floor=f"{samp_graph / floor:.3f}",
        meanfield_sample_host_us=f"{samp_host_us:.3f}",
        meanfield_sample_after_op_graph_ms=samp_after_op, shape=f"{N_SAMPLES}x{d}")
    say("h", fused_chunk_ms=fk_ms, fused_chunk_plain_ms=fr_ms, chunk_steps=args[6])
    mf_split("h", "flagship_hand", args, fk_ms)
    return {"meanfield_sample": (samp_graph, samp_plain),
            "fused_advi_meanfield": (fk_ms, fr_ms)}


# ---------------------------------------------------------------------------
# The full-rank slice: K7b, K8 and K3-FR, and the full-rank paths
# ---------------------------------------------------------------------------


def rel_err(a, b) -> float:
    """Norm-wise relative difference ||a - b||_F / ||b||_F, in float64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def factor(d, dev, seed=3):
    """The well-conditioned Cholesky factor of normal_fullrank_wellcond(d),
    with ones written above the diagonal (no kernel may read them)."""
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond

    _, _, L = normal_fullrank_wellcond(seed, d, device="cpu")
    return L.to(dev), (L + torch.triu(torch.ones(d, d), 1)).to(dev)


# K7b's shapes in (i): the main path's, the fused comparison's, ragged ones
# (n and d off every tile and step multiple of csrc/fullrank_sample.cu) and
# bench_large's second size
FR_SAMPLE_SHAPES = [FR_SHAPE, (N_SAMPLES, N_FEATURES + 2)] + [
    (n, d) for n in (1, 3, 7, 33, 300) for d in (1, 5, 33, 62, 100, 1000)] + [FR_WIDE_SHAPE]


def nan_factor(d, dev, seed=3):
    """The well-conditioned Cholesky factor of normal_fullrank_wellcond(d),
    with NaN above the diagonal: a kernel that read it would put NaN in z."""
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond

    _, _, L = normal_fullrank_wellcond(seed, d, device="cpu")
    return (L + torch.triu(torch.full((d, d), float("nan")), 1)).to(dev)


@contextlib.contextmanager
def k7b_shapes():
    """Records the (n, d) of every K7b launch made inside into the yielded
    set: a pass-through in front of the wrapper's dispatch
    (``fullrank_sample_raw``), so the counts are the wrapper's own."""
    from advancedvi_jl_tpu_torch.ops.cuda import location_scale_kernels as lsk

    raw, shapes = lsk.fullrank_sample_raw, set()

    def recording(seed, it, location, scale, n):
        if location.is_cuda:
            shapes.add((int(n), location.shape[-1]))
        return raw(seed, it, location, scale, n)

    lsk.fullrank_sample_raw = recording
    try:
        yield shapes
    finally:
        lsk.fullrank_sample_raw = raw


def check_k7b_shapes(phase, shapes, checked):
    """Fails unless every K7b shape of a counted run is one that the
    checks against the plain version covered."""
    missing = sorted(set(shapes) - set(checked))
    say(phase, k7b_counted_shapes=",".join(f"{n}x{d}" for n, d in sorted(shapes)))
    check(not missing, f"({phase}) K7b launched at {missing}, which no check covers")


def phase_i(dev, shapes=FR_SAMPLE_SHAPES, phase="i", shown=(FR_SHAPE, FR_WIDE_SHAPE)):
    """K7b against its plain version and K7a's draws at every shape of
    ``shapes`` (FR_SAMPLE_SHAPES; (z) passes its own), C with NaN above its
    diagonal: u bitwise the plain version's and K7a's, z finite, within 1e-6
    norm-wise of the plain version, and the same bits on a second call.
    Prints the shapes in ``shown``; returns the largest error."""
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        fullrank_sample_cuda, fullrank_sample_reference, meanfield_sample_cuda, seed_words,
    )

    seed = seed_words(SEED)
    worst_err = worst_rel = 0.0
    for n, d in shapes:
        C = nan_factor(d, dev)
        loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
        z, u = fullrank_sample_cuda(seed, 5, loc, C, n)
        z2, u2 = fullrank_sample_cuda(seed, 5, loc, C, n)
        zr, ur = fullrank_sample_reference(seed, 5, loc, C, n)
        _, umf = meanfield_sample_cuda(seed, 5, loc, torch.ones_like(loc), n)
        torch.cuda.synchronize()
        rel, err = rel_err(z, zr), max_err(z, zr)
        checks = {"u_bitwise_plain": torch.equal(u, ur), "u_bitwise_meanfield": torch.equal(u, umf),
                  "z_finite": bool(torch.isfinite(z).all()),
                  "z_bitwise_two_calls": torch.equal(z, z2) and torch.equal(u, u2)}
        if (n, d) in shown or not all(checks.values()):
            say(phase, shape=f"{n}x{d}", **checks, z_rel_err=rel, z_max_abs_err=err)
        for name, ok in checks.items():
            check(ok, f"full-rank sampler at {n}x{d}: {name} failed")
        # z sums d products in another order than the plain product
        check(rel <= 1e-6, f"full-rank sampler z at {n}x{d}: norm-wise error {rel} > 1e-6")
        worst_err, worst_rel = max(worst_err, err), max(worst_rel, rel)
    say(phase, shapes=len(shapes), all_checks=True, worst_z_rel_err=worst_rel,
        worst_z_max_abs_err=worst_err, upper_triangle="nan")
    return worst_err


# K8's ragged shapes: n not a multiple of a block's rows, d not of a panel's 32
TRI_NS = (1, 3, 7, 256, 300)
TRI_DS = (1, 5, 33, 62, 100, 512, 1000, 1024)


def phase_j(dev):
    """K8 in both modes against a float64 solve (residual) and its plain
    version, at the main path's shapes and at ragged ones; at the main
    shape every rows-a-block choice gives the same bits."""
    from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import (
        ROWS_PER_BLOCK, solve_right_cuda, solve_right_reference,
    )

    shapes = [FR_SHAPE, (N_SAMPLES, FR_FUSED_D), (N_SAMPLES, N_FEATURES + 2)]
    shapes += [(n, d) for n in TRI_NS for d in TRI_DS if (n, d) not in shapes]
    factors = {}
    worst, worst_resid = 0.0, 0.0
    for n, d in shapes:
        if d not in factors:
            factors[d] = factor(d, dev)
        L, C = factors[d]
        V = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).to(dev)
        line = {}
        for mode in ("C", "CT"):
            W = solve_right_cuda(C, V, mode)
            Wr = solve_right_reference(C, V, mode)
            torch.cuda.synchronize()
            op = L.double() if mode == "C" else L.double().T
            resid = float((W.double() @ op - V.double()).norm() / V.double().norm())
            rel = rel_err(W, Wr)
            line[f"{mode}_residual"], line[f"{mode}_rel_err_vs_plain"] = resid, rel
            check(resid <= 1e-5, f"trisolve {mode} {n}x{d}: residual {resid} > 1e-5")
            check(rel <= 1e-5, f"trisolve {mode} {n}x{d}: {rel} from its plain version")
            worst, worst_resid = max(worst, max_err(W, Wr)), max(worst_resid, resid)
            if (n, d) == FR_SHAPE:
                same = all(torch.equal(W, solve_right_cuda(C, V, mode, rows))
                           for rows in ROWS_PER_BLOCK)
                check(same, f"trisolve {mode} {n}x{d}: the rows-a-block choices differ")
                line[f"{mode}_rows_bitwise"] = same
        say("j", shape=f"{n}x{d}", **line)
    say("j", shapes=len(shapes), worst_residual=worst_resid, worst_max_abs_err_vs_plain=worst)
    return worst


def fullrank_specs(dev):
    """The two full-rank fused configurations: the flagship logreg at d = 62
    (q0 = 0.1 I) and the dense Gaussian normal_fullrank_wellcond at d = 512
    (q0 = I), each with its general-path target."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond

    prob = flagship(dev)
    target, mu, L = normal_fullrank_wellcond(3, FR_FUSED_D, device=dev)
    d = prob.dim
    return {
        "logreg": (avt.logreg_spec(prob.X, prob.y), prob.unconstrained(),
                   0.1 * torch.eye(d, device=dev)),
        "mvnormal": (avt.mvnormal_spec(mu, L), target.solve_free(),
                     torch.eye(FR_FUSED_D, device=dev)),
    }


def compare_fullrank(tag, kv, km, rv, rm, rtol):
    """Norm-wise per field, as compare_state: max |a - b| <= rtol max |b|."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FR_MAT_FIELDS, FR_VEC_FIELDS

    worst, bad = 0.0, []
    for f, a, b in zip(FR_VEC_FIELDS + FR_MAT_FIELDS, list(kv) + list(km), list(rv) + list(rm)):
        err, scale = max_err(a, b), float(b.abs().max())
        worst = max(worst, err)
        print(f"    {f}: max_abs_err={err:.3e} max_abs={scale:.3e} "
              f"rel={err / max(scale, 1e-30):.3e}", flush=True)
        if not err <= rtol * scale:
            bad.append(f)
    check(not bad, f"{tag}: {bad} over rtol {rtol} (norm-wise)")
    return worst


def cluster_sizes(d):
    """The cluster sizes the full-rank kernel takes at width d (1: the
    single-block kernel)."""
    return [cs for cs in (1, 2, 4, 8, 16) if cs == 1 or cs <= -(-d // 32)]


def phase_k(dev):
    """K3-FR against its plain version at d = 62 (logreg) and d = 512
    (mvnormal): 50 steps of injected noise, 200 of Philox; chunking and
    tracing bitwise; for the single-block kernel and at every cluster size,
    each cluster size bitwise the single-block kernel.  Returns the worst
    error of the single-block kernel and of the cluster kernel."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        DEFAULT_BRANCH, FusedHyper, fused_fullrank_run_chunk_cuda,
        fused_fullrank_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    seed, hyp, worst = seed_words(SEED), FusedHyper(lr=LR), {1: 0.0, 2: 0.0}
    for name, (spec, _, C0) in fullrank_specs(dev).items():
        d = spec.dim
        vec = torch.zeros(4, d, device=dev)
        mat = torch.stack([C0, torch.zeros_like(C0), torch.zeros_like(C0), C0])
        base = (spec.model, spec.consts, spec.scalars)
        noise = torch.randn((50, N_SAMPLES, d), generator=torch.Generator().manual_seed(5)).to(dev)
        r = fused_fullrank_run_chunk_reference(*base, vec, mat, seed, 0, 50, N_SAMPLES, hyp,
                                               noise, 5)
        ref = fused_fullrank_run_chunk_reference(*base, vec, mat, seed, 0, 200, N_SAMPLES, hyp)
        single = None
        rule = rule_size(spec.model, d, DEFAULT_BRANCH, N_DATA if name == "logreg" else 0)
        for cs in cluster_sizes(d):
            tag = f"{name} cluster={cs}"
            run = lambda *a: fused_fullrank_run_chunk_cuda(*base, *a, cluster=cs)
            k = run(vec, mat, seed, 0, 50, N_SAMPLES, hyp, noise, 5)
            one = run(vec, mat, seed, 0, 200, N_SAMPLES, hyp)
            half = run(vec, mat, seed, 0, 100, N_SAMPLES, hyp)
            two = run(half[0], half[1], seed, 100, 100, N_SAMPLES, hyp)
            traced = run(vec, mat, seed, 0, 200, N_SAMPLES, hyp, None, 50)
            torch.cuda.synchronize()
            err = compare_fullrank(f"{tag} fused vs plain, injected noise",
                                   k[0], k[1], r[0], r[1], 1e-5)
            check(torch.allclose(k[2], r[2], rtol=1e-5, atol=1e-4), f"{tag}: ELBO differs")
            check(torch.allclose(k[3], r[3], rtol=1e-5, atol=1e-4), f"{tag}: trace rows differ")
            check(torch.equal(torch.triu(k[1][0], 1), torch.triu(mat[0], 1)),
                  f"{tag}: the upper triangle of the scale moved")
            check(all(torch.equal(a, b) for a, b in zip(one[:3], two[:3])),
                  f"{tag}: run_chunk(200) differs from two run_chunk(100)")
            check(all(torch.equal(a, b) for a, b in zip(one[:3], traced[:3]))
                  and float(traced[3][-1]) == float(one[2]), f"{tag}: traced and untraced differ")
            # float32 transcendentals and sums in another order, carried by
            # 200 steps of Adam
            err = max(err, compare_fullrank(f"{tag} fused vs plain, Philox, 200 steps",
                                            one[0], one[1], ref[0], ref[1], 1e-4))
            check(torch.allclose(one[2], ref[2], rtol=1e-4, atol=1e-3),
                  f"{tag}: ELBO after 200 steps")
            worst[min(cs, 2)] = max(worst[min(cs, 2)], err)
            if single is None:
                single = (k, one)
            same = all(torch.equal(a, b) for a, b in zip(single[0] + single[1][:3], k + one[:3]))
            check(same, f"{tag}: not bitwise the single-block kernel")
            say("k", model=name, d=d, cluster=cs, rule=rule, steps="50+200", max_abs_err=err,
                chunked_bitwise=True, traced_bitwise=True, single_block_bitwise=same,
                elbo_kernel=float(one[2]), elbo_plain=float(ref[2]))
    return worst[1], worst[2]


def fullrank_alg(n_samples):
    import advancedvi_jl_tpu_torch as avt

    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=n_samples,
                                   optimizer=avt.adam(LR), operator=avt.ClipScale())


def wide_general(dev):
    """The general full-rank path of bench_large.py bench_fullrank_flopbound
    at d = 1024, n = 256: (solve-free target, q0, algorithm)."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond

    target, _, _ = normal_fullrank_wellcond(3, FR_D, device=dev)
    q0 = avt.FullRankGaussian(torch.zeros(FR_D, device=dev), solve_mode="pallas")
    return target.solve_free(), q0, fullrank_alg(FR_N)


def fullrank_paths(dev):
    """(l) The full-rank main paths, each with counted launches: the general
    path at d = 1024, n = 256 (bench_large.py bench_fullrank_flopbound), the
    fused logreg engine to 20,000 steps, and fused vs general at d = 62 and
    d = 512 on the same Philox key.  Returns the counts and the fused
    logreg's tail ELBO and averaged location at 20,000 steps."""
    import advancedvi_jl_tpu_torch as avt

    target, q0, alg = wide_general(dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with k7b_shapes() as shapes:
        _, infos, _ = avt.optimize(SEED, alg, FR_GENERAL_STEPS, target, q0, log_every=10)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_launches()
    check_k7b_shapes("l", shapes, FR_SAMPLE_SHAPES)
    elbos = [r["elbo"] for r in infos]
    first, last = sum(elbos[:5]) / 5, sum(elbos[-5:]) / 5
    say("l", path="general", d=FR_D, n=FR_N, steps=FR_GENERAL_STEPS, elbo_first5=first,
        elbo_last5=last, seconds=f"{secs:.2f}", fullrank_sample_launches=counts["fullrank_sample"],
        trisolve_launches=counts["trisolve"])
    check(all(math.isfinite(e) for e in elbos), "full-rank general ELBO not finite")
    check(last > first, f"full-rank general ELBO did not rise: {first} -> {last}")
    check(counts["fullrank_sample"] > 0, "the full-rank general path launched no sampler kernel")
    check(counts["trisolve"] > 0, "the full-rank general path launched no trisolve kernel")

    specs = fullrank_specs(dev)
    spec, _, C0 = specs["logreg"]
    d = spec.dim
    lq0 = avt.FullRankGaussian(torch.zeros(d, device=dev), C0, solve_mode="pallas")
    eng = avt.FusedADVI(spec, family="fullrank", n_samples=N_SAMPLES, lr=LR)
    mspec, _, mC0 = specs["mvnormal"]
    meng = avt.FusedADVI(mspec, family="fullrank", n_samples=N_SAMPLES, lr=LR)
    mq0 = avt.FullRankGaussian(torch.zeros(mspec.dim, device=dev), mC0, solve_mode="pallas")
    reset_launches()
    t0 = time.perf_counter()
    q_agree, rows_a, st = eng.optimize(SEED, FR_AGREE_STEPS, lq0, log_every=LOG_EVERY)
    q_fused, rows_b, st = eng.optimize(SEED, FUSED_STEPS - FR_AGREE_STEPS, state=st,
                                       log_every=LOG_EVERY)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mv_q, mv_rows, _ = meng.optimize(SEED, FR_MV_STEPS, mq0, log_every=LOG_EVERY)
    torch.cuda.synchronize()
    fused_counts = read_launches()
    rows = rows_a + rows_b
    tail = tail_elbo(rows)
    say("l", path="fused", model="logreg", d=d, steps=FUSED_STEPS, elbo_last=rows[-1]["elbo"],
        elbo_tail_mean=tail, seconds=f"{secs:.2f}", mvnormal_steps=FR_MV_STEPS,
        mvnormal_elbo_last=mv_rows[-1]["elbo"],
        single_block_launches=fused_counts["fused_advi_fullrank"],
        cluster_launches=fused_counts["fused_advi_fullrank_cluster"])
    check(all(math.isfinite(r["elbo"]) for r in rows + mv_rows), "full-rank fused ELBO not finite")
    check(tail > -150.0, f"full-rank fused ELBO {tail} <= -150 (not converged)")
    check(fused_counts["fused_advi_fullrank_cluster"] > 0,
          "the full-rank fused path launched no cluster kernel")
    for kern in ("fused_advi_fullrank", "fused_advi_fullrank_cluster"):
        counts[kern] = fused_counts[kern]

    for name, steps, fq in (("logreg", FR_AGREE_STEPS, q_agree), ("mvnormal", FR_MV_STEPS, mv_q)):
        spec, tgt, C0 = specs[name]
        d = spec.dim
        q0 = avt.FullRankGaussian(torch.zeros(d, device=dev), C0, solve_mode="pallas")
        gq, ginfos, _ = avt.optimize(SEED, fullrank_alg(N_SAMPLES), steps, tgt, q0,
                                     log_every=LOG_EVERY)
        torch.cuda.synchronize()
        loc_diff = max_err(fq.location, gq.location)
        scale_diff = max_err(fq.scale, gq.scale)
        say("l", compare=f"fused_vs_general_{name}", d=d, steps=steps,
            averaged_location_max_abs_diff=loc_diff, averaged_scale_max_abs_diff=scale_diff,
            general_elbo=ginfos[-1]["elbo"])
        # same draws; the two paths round sums in other orders
        check(loc_diff <= 1e-3, f"fused vs general {name}: location {loc_diff} > 1e-3 apart")
    # the fused logreg's tail and averaged location: (z)'s reference
    return counts, (tail, q_fused.location)


def fullrank_chunk_args(dev):
    """The timed full-rank chunks of phase (m): 200 in-kernel-Philox steps
    of each full-rank fused configuration from its initial state."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedHyper
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    out = {}
    for name, (spec, _, C0) in fullrank_specs(dev).items():
        vec = torch.zeros(4, spec.dim, device=dev)
        mat = torch.stack([C0, torch.zeros_like(C0), torch.zeros_like(C0), C0])
        out[name] = (spec.model, spec.consts, spec.scalars, vec, mat, seed_words(SEED), 0, 200,
                     N_SAMPLES, FusedHyper(lr=LR))
    return out


def trisolve_args(dev):
    """K8's timed inputs: the main path's 256 x 1024 (C with ones above the
    diagonal, which the kernel must not read)."""
    n, d = FR_SHAPE
    _, C = factor(d, dev)
    return C, torch.randn(n, d, generator=torch.Generator().manual_seed(7)).to(dev)


def ab_chunks(dev):
    """The chunks the A/B times: 200 steps each (in-kernel Philox) with the
    package of the working directory: the flagship hand chunk (phase (h))
    and its ad chunk (y), the prox-DoWG and VarGrad chunks (q), K6 at C = 64,
    128 and 1,024 on the hand body and at C = 64 on the ad body (w, y), the
    full-rank d = 62 logreg chunk and its ad chunk (m, y), the d = 512
    chunk (m), and K4's minibatch body: the three transports at n = 16,384
    and the staged ones at n = 500,000 (u; these walk the epoch, it0 200
    further each call, so that the 500k slabs come from HBM), the staged
    16k spec in the full-rank kernel and in K6 at C = 64; K6 at C = 256, 512
    and 1,024 on the hand body and on the staged 16k spec, and at C = 1,024
    with VarGrad (clip), on the in-place and prefetch 16k specs and on the
    diagonal Gaussian at d = 11 (and C = 4,224: 32 chains a block) and
    d = 512.  Returns
    ({name: (launch, reps)}, {name: (args, ad, walk)} of the chunks whose
    mean-field phase split the A/B takes, (the flagship's K5 programs))."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda import fused_advi as fa
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import fused_chains_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    prob = flagship(dev)
    hand = flagship_chunk_args(dev)
    spec = avt.ad_spec(prob.unconstrained())
    mf = fa.ad_program(spec, N_SAMPLES, "meanfield", 8)
    fr = fa.ad_program(spec, N_SAMPLES, "fullrank", 4)
    vec, mat = ad_rows(prob.dim, dev, "fullrank")
    ad_args = ("ad", mf.consts, ()) + hand[3:]
    out = {
        "flagship_hand": (lambda: fa.fused_run_chunk_cuda(*hand), 20),
        "flagship_ad": (lambda: fa.fused_run_chunk_cuda(*ad_args, ad=mf), 20),
        "fullrank_ad": (lambda: fa.fused_fullrank_run_chunk_cuda(
            "ad", fr.consts, (), vec, mat, *hand[4:], ad=fr), 10),
    }
    splits = {"flagship_hand": (hand, None, False), "flagship_ad": (ad_args, mf, False)}
    for name, args in fullrank_chunk_args(dev).items():
        out[f"fullrank_{name}"] = (lambda a=args: fa.fused_fullrank_run_chunk_cuda(*a), 10)
    engines = slice_engines(dev)
    for name in ("prox", "bbvi"):  # prox-DoWG; VarGrad (DoWG, clip)
        eng, q0 = engines[name]
        args = (eng.model.model, eng.model.consts, eng.model.scalars,
                eng.init(q0.location, q0.scale_diag).stacked(), seed_words(SEED), 0, 200,
                N_SAMPLES, eng.hyp, None, 0, eng.branch())
        out[name] = (lambda a=args: fa.fused_run_chunk_cuda(*a), 10)
    big = large_logreg(dev)
    mb = {f"{tr}_16k": sp for tr, sp in mb_specs(big.X, big.y).items()}
    mb.update({f"{tr}_500k": sp for tr, sp in mb_specs(*streamed_data(dev)).items()
               if tr != "inplace"})
    for name, sp in mb.items():  # K4's minibatch body
        args = (sp.model, sp.consts, sp.scalars, initial_rows(sp.dim, dev), seed_words(SEED),
                0, 200, N_SAMPLES, fa.FusedHyper(lr=LR))
        out[f"minibatch_{name}"] = (walking(fa.fused_run_chunk_cuda, args), 5)
        splits[f"minibatch_{name}"] = (args, None, True)
    sp = mb["staged_16k"]
    C0 = 0.1 * torch.eye(sp.dim, device=dev)
    args = (sp.model, sp.consts, sp.scalars, torch.zeros(4, sp.dim, device=dev),
            torch.stack([C0, torch.zeros_like(C0), torch.zeros_like(C0), C0]),
            seed_words(SEED), 0, 200, N_SAMPLES, fa.FusedHyper(lr=LR))
    out["fullrank_minibatch_staged_16k"] = (
        lambda a=args: fa.fused_fullrank_run_chunk_cuda(*a), 5)
    hand_spec = avt.logreg_spec(prob.X, prob.y)
    gauss = {}
    for d in (11, 512):  # the diagonal Gaussian: 32 chains a block fit at d = 11, 2 at 512
        g = torch.Generator().manual_seed(d)
        gauss[d] = avt.gaussian_spec(torch.randn(d, generator=g).to(dev),
                                     (0.5 + torch.rand(d, generator=g)).to(dev))
    vargrad = dict(grad_est="scoregrad", operator="clip")
    for tag, sp, C, kw in (
            ("chains64", hand_spec, 64, {}), ("chains128", hand_spec, 128, {}),
            ("chains256", hand_spec, 256, {}),
            ("chains512", hand_spec, 512, {}), ("chains1024", hand_spec, 1024, {}),
            ("chains1024_vargrad", hand_spec, 1024, vargrad),
            ("chains64_ad", spec, 64, {}),
            ("chains64_minibatch_staged_16k", mb["staged_16k"], 64, {}),
            ("chains256_minibatch_staged_16k", mb["staged_16k"], 256, {}),
            ("chains512_minibatch_staged_16k", mb["staged_16k"], 512, {}),
            ("chains1024_minibatch_staged_16k", mb["staged_16k"], 1024, {}),
            ("chains1024_minibatch_inplace_16k", mb["inplace_16k"], 1024, {}),
            ("chains1024_minibatch_prefetch_16k", mb["prefetch_16k"], 1024, {}),
            ("chains1024_gaussian11", gauss[11], 1024, {}),
            ("chains4224_gaussian11", gauss[11], 4224, {}),
            ("chains1024_gaussian512", gauss[512], 1024, {})):
        e, rows, seeds = chains_case(dev, sp, C, **kw)
        out[tag] = (lambda e=e, r=rows, sd=seeds: chains_run(
            fused_chains_run_chunk_cuda, e, r, sd, 0, 200), 5 if C > 64 else 10)
    return out, splits, (mf, fr)


def walking(fn, args, step=200):
    """``fn(*args)`` with it0 (``args[5]``) ``step`` further each call: a
    timed minibatch chunk walks the epoch as a run does (phase (u))."""
    it0 = [args[5]]

    def call(**kw):
        a = args[:5] + (it0[0],) + args[6:]
        it0[0] += step
        return fn(*a, **kw)

    return call


def ab_times(dev):
    """The A/B's side of one checkout, run in a child process with that
    checkout's package: K8 at 256 x 1024 in both modes (events and graph
    replay), K7b at 256 x 1024 and 128 x 2048 (graph replay), K7a at 10 x 62
    (graph replay, behind a kernel that writes m, host time a call), each K9
    probe (graph replay, host time a call), a step of flagship ADVI through
    ``optimize`` (``optimize_step_ms``), every chunk of ``ab_chunks``, and
    the mean-field phase split of
    the flagship hand and ad chunks and of the mean-field minibatch
    chunks."""
    from advancedvi_jl_tpu_torch.ops.cuda import _build
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        fullrank_sample_cuda, meanfield_sample_cuda, seed_words,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import probe_cuda, probe_inputs
    from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import solve_right_cuda

    _build.build_all()
    chunks, splits, (mf, fr) = ab_chunks(dev)
    pairs = [(k, mf.source) for k in ("fused_advi_meanfield", "fused_chains")] + \
        [("fused_advi_fullrank", fr.source)]
    libs = _build.build_generated_all(pairs)
    C, V = trisolve_args(dev)
    out = {}
    for (kern, _), path in libs.items():  # the flagship's K5 libraries: registers and spills
        out[f"ptxas_k5_{kern}"] = " | ".join(
            ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
            if "spill" in ln or "registers" in ln)
    for mode in ("C", "CT"):
        out[f"trisolve_{mode}"] = cuda_ms(lambda: solve_right_cuda(C, V, mode), 200)
        out[f"trisolve_{mode}_graph"] = graph_ms(lambda: solve_right_cuda(C, V, mode))
    for n, d in (FR_SHAPE, FR_WIDE_SHAPE):  # K7b by graph replay: the card alone
        _, Cf = factor(d, dev)
        loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
        out[f"fullrank_sample_{n}x{d}_graph"] = graph_ms(
            lambda: fullrank_sample_cuda(seed_words(SEED), 1, loc, Cf, n))
    # K7a at the main path's shape: the card alone (graph replay), behind a
    # kernel that writes m, and the host time a call; each K9 probe likewise
    d = N_FEATURES + 2
    loc, sc = torch.zeros(d, device=dev), torch.ones(d, device=dev)

    def sample():
        return meanfield_sample_cuda(seed_words(SEED), 1, loc, sc, N_SAMPLES)

    out["meanfield_sample_graph"] = graph_ms(sample, 200)
    out["meanfield_sample_after_op_graph"] = after_op_ms(sample, lambda: loc.mul_(1.0))
    out["meanfield_sample_host_us"] = host_us(sample)
    for i, t in probe_graph_ms(dev).items():
        out[f"probe{i}_graph"] = t
    for i, x in probe_inputs(dev).items():
        out[f"probe{i}_host_us"] = host_us(lambda: probe_cuda(i, x, device=dev))
    out["optimize_advi_step_ms"] = optimize_step_ms(dev)
    for name, (fn, reps) in chunks.items():
        out[name] = cuda_ms(fn, reps)
    for name, (args, ad, walk) in splits.items():
        cycles, _ = mf_phase_cycles(args, ad, walk=walk)
        total = sum(cycles)
        for phase, c in zip(MF_PHASES, cycles):
            out[f"split_{name}_{phase}_us"] = 1e3 * out[name] / 200 * c / total
    return out


OPT_STEPS = 500


def optimize_step_ms(dev):
    """Host ms a step of phase (h)'s flagship ADVI through ``optimize``: one
    OPT_STEPS-step chunk (its rows read in one sync), after a 50-step
    warm-up run, ending in a sync; the loop's own cost beside the steps."""
    import advancedvi_jl_tpu_torch as avt

    prob = flagship(dev)
    d, target = prob.dim, prob.unconstrained()
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                  optimizer=avt.adam(LR), operator=avt.ClipScale())
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    avt.optimize(SEED, alg, 50, target, q0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avt.optimize(SEED, alg, OPT_STEPS, target, q0, log_every=10)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / OPT_STEPS


AB_CHILD = r"""
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
torch.backends.cuda.matmul.allow_tf32 = False
print(json.dumps(smoke.ab_times(torch.device("cuda:0"))))
"""


# The kernel libraries this tree edits against its parent: every other one
# must compile to the parent's SASS.
AB_CHANGED = ()


def ab_parent(parent: Path):
    """The A/B: ``ab_times`` with the parent checkout's package and with
    this one's, a fresh process each, in the order parent, this, this,
    parent (each builds its kernels under its own build/kernels); the
    parent's side runs in ``parent_copy``'s copy of it."""
    parent = parent_copy(parent)
    runs = {"parent": [], "this": []}
    for tag, path in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", AB_CHILD, str(ROOT / "chip_smoke.py")],
                              cwd=path, capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"A/B in {path}: {proc.stderr[-2000:]}")
        runs[tag].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    from advancedvi_jl_tpu_torch.ops.cuda import _build

    differ = []
    for lib in _build.KERNELS:  # every kernel both libraries have
        for fn, same in sass_equal(built_library(parent, lib), built_library(ROOT, lib)):
            say("ab", sass=f"{lib}:{fn}", equal=same)
            if not same and lib not in AB_CHANGED:
                differ.append(f"{lib}:{fn}")
    for key in runs["this"][0]:
        if key.startswith("ptxas"):
            say("ab", lib=key, parent=f"'{runs['parent'][0][key]}'", this=f"'{runs['this'][0][key]}'")
            continue
        say("ab", chunk=key, parent_ms=",".join(f"{r[key]:.7g}" for r in runs["parent"]),
            this_ms=",".join(f"{r[key]:.7g}" for r in runs["this"]))
    check(not differ, f"SASS of kernels this change does not edit differs: {differ}")


def built_library(checkout: Path, name: str) -> Path:
    """The plain build (no generated body, no defines) of kernel ``name`` under
    ``checkout``'s build/kernels."""
    import re

    libs = [p for p in (checkout / "build" / "kernels").glob(f"lib{name}-*.so")
            if re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", p.name)]
    check(len(libs) == 1, f"{checkout}: {len(libs)} plain builds of {name}")
    return libs[0]


def sass_functions(lib: Path) -> dict:
    """{kernel: its SASS text} of a library, by ``cuobjdump -sass``; a kernel
    in an anonymous namespace is named without the namespace's per-file
    hash, so two builds of one kernel from edited files share its name."""
    import re
    import shutil

    from advancedvi_jl_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anonymous)",
                          ln.split("Function :", 1)[1].strip())
            out[name] = []
        elif name is not None:
            out[name].append(ln.strip())
    return {k: "\n".join(v) for k, v in out.items()}


def sass_equal(a: Path, b: Path):
    """(kernel, whether its SASS is the same) for each kernel of both
    libraries, in order."""
    fa, fb = sass_functions(a), sass_functions(b)
    return [(fn, fa[fn] == fb[fn]) for fn in fa if fn in fb]


def parent_copy(parent: Path) -> Path:
    """A fresh copy of the checkout ``parent`` under this checkout's
    ``build/ab_parent`` (without its builds), which the A/B builds and times
    instead of ``parent`` itself."""
    import shutil

    copy = ROOT / "build" / "ab_parent"
    check(parent not in (copy, *copy.parents), f"--parent {parent}: it holds its own copy")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(parent, copy, ignore=shutil.ignore_patterns(
        ".git", "build", "_archive", "__pycache__"))
    return copy


# the mean-field step's phases (csrc/fused_meanfield_body.cuh, AVI_PHASE_CLOCKS)
MF_PHASES = ("draws_z", "row_sums", "logits", "logpi", "grad", "rule", "elbo_wait")


def mf_phase_cycles(args, ad=None, launches=4, walk=False):
    """SM cycles of thread 0 in each mean-field phase (MF_PHASES), summed
    over ``launches`` launches of the instrumented build of the chunk
    ``args`` (with ``ad``'s K5 body when given; with ``walk``, it0 a chunk
    further each launch, as ``walking``), and the milliseconds a launch."""
    from advancedvi_jl_tpu_torch.ops.cuda import fused_advi as fa

    kw = {} if ad is None else {"ad": ad}
    run = walking(fa.fused_run_chunk_cuda, args, args[6] if walk else 0)
    run(instrumented=True, **kw)
    torch.cuda.synchronize()
    fa.meanfield_phase_cycles(ad)  # the counters restart at zero
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        run(instrumented=True, **kw)
    stop.record()
    torch.cuda.synchronize()
    return list(fa.meanfield_phase_cycles(ad).values()), start.elapsed_time(stop) / launches


def mf_split(phase, name, args, chunk_ms, ad=None, walk=False):
    """Print the mean-field step's phase split of the chunk ``args``: each
    phase's share of thread 0's cycles, in microseconds of ``chunk_ms``'
    step (the build without counters), and its cycles a step."""
    cycles, inst_ms = mf_phase_cycles(args, ad, walk=walk)
    total = sum(cycles)
    steps = 4 * args[6]
    step_us = 1e3 * chunk_ms / args[6]
    say(phase, mf_phase_split=name, step_us=f"{step_us:.3f}", instrumented_chunk_ms=inst_ms,
        cycles_per_step=f"{total / steps:.0f}",
        **{f"{p}_us": f"{step_us * c / total:.3f}" for p, c in zip(MF_PHASES, cycles)})
    return dict(zip(MF_PHASES, cycles))


def phase_split(dev, name, args, chunk_ms):
    """Each phase's share of a full-rank step (the instrumented build's SM
    cycles of thread 0, PHASES), in microseconds of ``chunk_ms``' step."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        fused_fullrank_run_chunk_cuda, phase_cycles,
    )

    fused_fullrank_run_chunk_cuda(*args, instrumented=True, cluster=1)
    torch.cuda.synchronize()
    phase_cycles()  # restart the counters
    inst_ms = cuda_ms(lambda: fused_fullrank_run_chunk_cuda(*args, instrumented=True, cluster=1),
                      4)
    cycles = phase_cycles()
    total = sum(cycles.values())
    step_us = 1e3 * chunk_ms / args[7]
    say("m", phase_split=name, step_us=step_us, instrumented_chunk_ms=inst_ms,
        **{f"{p}_us": step_us * c / total for p, c in cycles.items()})


def cluster_split(name, args, cs, chunk_ms):
    """The cluster kernel's step split on rank 0 (the instrumented build's
    SM cycles of thread 0, CLUSTER_PHASES): each phase's share of the first
    five, in microseconds of ``chunk_ms``' step; the cluster barriers' wait
    and the whitening's parts on the same scale."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        cluster_phase_cycles, fused_fullrank_run_chunk_cuda,
    )

    fused_fullrank_run_chunk_cuda(*args, instrumented=True, cluster=cs)
    torch.cuda.synchronize()
    cluster_phase_cycles()  # restart the counters
    inst_ms = cuda_ms(lambda: fused_fullrank_run_chunk_cuda(*args, instrumented=True,
                                                            cluster=cs), 4)
    cycles = cluster_phase_cycles()
    total = sum(list(cycles.values())[:5])
    step_us = 1e3 * chunk_ms / args[7]
    say("m", cluster_split=name, cluster=cs, step_us=step_us, instrumented_chunk_ms=inst_ms,
        **{f"{p}_us": step_us * c / total for p, c in cycles.items()})


# The launches the cluster rule routes, each timed at one block and at every
# cluster size it takes: every served model at several widths, under Adam
# (the engines' default), descent with the STL-zero entropy and the prox
# operator, COCOB (seven state rows), and Adam with the closed-form-zero
# entropy (no whitening).  The logreg's widths are its features plus two.
ROUTE_WIDTHS = {"logreg": (33, 62, 128), "mvnormal": (33, 62, 100, 200, 512),
                "gaussian": (33, 62, 100, 200, 512)}
ROUTE_BRANCHES = ("adam", "descent_prox", "cocob", "cf_zero")


def route_branch(name):
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedBranch

    return {"adam": FusedBranch(),
            "descent_prox": FusedBranch("descent", "stl_zero_grad", "repgrad", "prox"),
            "cocob": FusedBranch("cocob"),
            "cf_zero": FusedBranch("adam", "closed_form_zero_grad")}[name]


def rule_size(model, d, branch, n_data=0):
    """``cluster_blocks``' choice for a launch of ``N_SAMPLES`` draws, asked
    with the kernel's own layout count, as the wrapper asks it."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        MODEL_CODES, cluster_blocks, cluster_smem_bytes,
    )

    k = 4 + branch.ext_rows // 2
    db = d - 1 if model == "logreg" else 0
    return cluster_blocks(model, d, N_SAMPLES, branch,
                          lambda cs: cluster_smem_bytes()(MODEL_CODES[model], n_data, db,
                                                          N_SAMPLES, d, k, cs))


def route_case(dev, model, d, branch):
    """The 200-step chunk's arguments for a served model at width d under
    ``branch``, from the engine's initial state (q0 = 0.1 I for the logreg,
    I otherwise)."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.models.logreg import make_logreg
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    C0 = torch.eye(d, device=dev)
    if model == "logreg":
        prob = make_logreg(DATA_SEED, n_data=N_DATA, n_features=d - 2, device=dev)
        spec, C0 = avt.logreg_spec(prob.X, prob.y), 0.1 * C0
    elif model == "mvnormal":
        _, mu, L = normal_fullrank_wellcond(3, d, device=dev)
        spec = avt.mvnormal_spec(mu, L)
    else:
        g = torch.Generator().manual_seed(d)
        spec = avt.gaussian_spec(torch.randn(d, generator=g).to(dev),
                                 (0.5 + torch.rand(d, generator=g)).to(dev))
    eng = case_engine(dev, "fullrank", spec, branch, LR, 1e-4)
    rows = eng.init(torch.zeros(d, device=dev), C0).stacked_fullrank()
    return (spec.model, spec.consts, spec.scalars, *rows, seed_words(SEED), 0, 200, N_SAMPLES,
            eng.hyp, None, 0, branch)


def route_sweep(dev):
    """The rule's routed launches (ROUTE_WIDTHS x ROUTE_BRANCHES): each
    200-step chunk at one block and at every cluster size, in order and
    back; the fastest size beside the rule's choice.  Returns {(model, d,
    branch): (best size, rule, {size: ms})}."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import fused_fullrank_run_chunk_cuda

    out = {}
    for model, widths in ROUTE_WIDTHS.items():
        for d in widths:
            for bname in ROUTE_BRANCHES:
                branch = route_branch(bname)
                args = route_case(dev, model, d, branch)
                reps = 2 if d >= 200 else 5
                times = {}
                for cs in cluster_sizes(d) + cluster_sizes(d)[::-1]:
                    ms = cuda_ms(lambda: fused_fullrank_run_chunk_cuda(*args, cluster=cs), reps)
                    times[cs] = min(times.get(cs, ms), ms)
                best = min(times, key=times.get)
                rule = rule_size(model, d, branch, N_DATA if model == "logreg" else 0)
                say("m", route=f"{model}/{bname}", d=d, best=best, rule=rule,
                    rule_over_best=f"{times[rule] / times[best]:.3f}",
                    rule_over_single=f"{times[rule] / times[1]:.3f}",
                    **{f"cs{cs}_ms": f"{ms:.4f}" for cs, ms in times.items()})
                out[(model, d, bname)] = (best, rule, times)
    return out


def kernel_us(fn, calls: int = 20) -> dict:
    """{kernel name: device microseconds a call} of the kernels ``fn()``
    launches, by torch.profiler over ``calls`` warmed-up calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls for e in prof.key_averages()
            if e.device_time_total > 0}


def fullrank_sample_times(dev, n, d):
    """K7b at (n, d) by CUDA-graph replay (the card alone: events over
    back-to-back calls time the wrapper's host work, 0.02-0.05 ms), and by
    events beside it; its plain version; and the library's product alone,
    ``torch.addmm(m, u, tril(C)^T)`` on given draws and a transposed
    triangle made beforehand (cuBLAS, no draws).  Returns (graph ms, plain
    ms, library graph ms)."""
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        fullrank_sample_cuda, fullrank_sample_reference, seed_words,
    )

    seed = seed_words(SEED)
    _, C = factor(d, dev)
    loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    kernel = lambda: fullrank_sample_cuda(seed, 1, loc, C, n)
    k_graph, k_events = graph_ms(kernel), cuda_ms(kernel, 200)
    plain = cuda_ms(lambda: fullrank_sample_reference(seed, 1, loc, C, n), 20)
    u = fullrank_sample_cuda(seed, 1, loc, C, n)[1]
    lt = torch.tril(C).T.contiguous()
    library = lambda: torch.addmm(loc, u, lt)
    l_graph, l_events = graph_ms(library), cuda_ms(library, 200)
    # the two launches' device time; the product's includes its wait for the
    # draws, since it starts while they run (programmatic dependent launch)
    split = {("draw" if "draw" in k else "product" if "product" in k else k): v
             for k, v in kernel_us(kernel).items()}
    say("m", fullrank_sample_split=f"{n}x{d}", **{f"{k}_us": v for k, v in split.items()})
    say("m", fullrank_sample_graph_ms=k_graph, fullrank_sample_events_ms=k_events,
        fullrank_sample_plain_ms=plain, library_product_alone_graph_ms=l_graph,
        library_product_alone_events_ms=l_events, faster_than_library=k_graph < l_graph,
        shape=f"{n}x{d}")
    return k_graph, plain, l_graph


def phase_m(dev, card):
    """Steps/s of the full-rank paths and each new kernel's time beside its
    plain version at the main path's shapes; K8 beside trsm by events and by
    graph replay, at each rows-a-block choice; the full-rank step's phase
    split."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        DEFAULT_BRANCH, MODEL_CODES, cluster_barrier_cycles, cluster_max_active,
        fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import (
        ROWS_PER_BLOCK, rows_per_block, solve_right_cuda, solve_right_reference,
    )

    target, q0, alg = wide_general(dev)
    s = alg.init(SEED, q0, target)
    for _ in range(20):
        s, _ = alg.step(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        s, _ = alg.step(s)
    torch.cuda.synchronize()
    general_sps = 100 / (time.perf_counter() - t0)
    out = {}
    for name, args in fullrank_chunk_args(dev).items():
        d = args[3].shape[1]
        model = args[0]
        k_ms = cuda_ms(lambda: fused_fullrank_run_chunk_cuda(*args, cluster=1), 10)
        p_ms = cuda_ms(lambda: fused_fullrank_run_chunk_reference(*args), 1)
        k_ms2 = cuda_ms(lambda: fused_fullrank_run_chunk_cuda(*args, cluster=1), 10)
        # the chunk's bound: z, the whitening and dC (three (n, d) x triangle
        # products) and the model (the logreg's two (n, 208, 61) products, or
        # the dense Gaussian's (n, d) x (d, d) precision product) a step; the
        # model's data, the mean and the eight scale matrices in and out
        tri = 3 * N_SAMPLES * d * (d + 1) // 2
        if model == "mvnormal":
            body_macs, data = N_SAMPLES * d * d, 4.0 * (d * d + d)
        else:
            body_macs, data = 2 * N_SAMPLES * N_DATA * (d - 1), 4.0 * (N_DATA * d)
        b_ms, b_by = bound(2.0 * 200 * (tri + body_macs), data + 4.0 * (8 * d + 8 * d * d))
        body_ms, _ = bound(2.0 * 200 * body_macs, data)
        say("m", fused_fullrank_model=name, d=d, chunk_steps=200, kernel_ms=f"{k_ms},{k_ms2}",
            plain_ms=p_ms, fused_steps_per_s=f"{200 / (min(k_ms, k_ms2) / 1e3):.1f}",
            bound_ms=b_ms, bound_by=b_by, model_body_bound_ms=body_ms)
        out[f"fused_advi_fullrank_{name}"] = (min(k_ms, k_ms2), p_ms)
        phase_split(dev, name, args, min(k_ms, k_ms2))
        # the cluster sweep: every size in turns with the single block; the
        # sizes the kernel does not take at this d are refused
        rule = rule_size(model, d, DEFAULT_BRANCH, N_DATA if model == "logreg" else 0)
        for cs in (2, 4, 8, 16):
            if cs not in cluster_sizes(d):
                try:
                    fused_fullrank_run_chunk_cuda(*args, cluster=cs)
                    refused = None
                except ValueError as e:
                    refused = str(e)
                check(refused is not None, f"cluster={cs} at d = {d} was not refused")
                say("m", cluster_sweep=name, d=d, cluster=cs, refused=f"'{refused}'")
        sweep = {}
        for cs in cluster_sizes(d) + cluster_sizes(d)[::-1]:
            ms = cuda_ms(lambda: fused_fullrank_run_chunk_cuda(*args, cluster=cs), 5)
            sweep[cs] = sweep.get(cs, ()) + (ms,)
        for cs, times in sweep.items():
            active = (cluster_max_active(MODEL_CODES[model], N_DATA if model == "logreg" else 0,
                                         d - 1 if model == "logreg" else 0, N_SAMPLES, d, 4, cs)
                      if cs > 1 else None)
            say("m", cluster_sweep=name, d=d, cluster=cs,
                chunk_ms=",".join(f"{t:.4f}" for t in times),
                rule=rule, chosen=cs == rule, max_active_clusters=active,
                speedup_vs_single=f"{min(sweep[1]) / min(times):.3f}")
        for cs in cluster_sizes(d)[1:]:
            cluster_split(name, args, cs, min(sweep[cs]))
        if rule > 1:
            out[f"fused_advi_fullrank_cluster_{name}"] = (min(sweep[rule]), p_ms, b_ms, b_by)
    route_sweep(dev)
    for cs in (1, 2, 4, 8, 16):
        cluster_barrier_cycles(cs, 10)
        say("m", cluster_barrier=cs, cycles_per_barrier=cluster_barrier_cycles(cs, 1000) / 1000)
    say("m", card=f"'{card}'", fullrank_general_steps_per_s=f"{general_sps:.1f}",
        d=FR_D, n=FR_N)
    for n, d in (FR_SHAPE, FR_WIDE_SHAPE):
        out[f"fullrank_sample_{n}x{d}"] = fullrank_sample_times(dev, n, d)
    out["fullrank_sample"] = out[f"fullrank_sample_{FR_N}x{FR_D}"]
    n, d = FR_SHAPE
    C, V = trisolve_args(dev)
    Lt = torch.tril(C)
    say("m", trisolve_rows_per_block=rows_per_block(n), shape=f"{n}x{d}")
    for mode in ("C", "CT"):
        op = Lt if mode == "C" else Lt.T
        for rows in ROWS_PER_BLOCK:
            say("m", trisolve_mode=mode, rows=rows,
                events_ms=cuda_ms(lambda: solve_right_cuda(C, V, mode, rows), 200),
                graph_ms=graph_ms(lambda: solve_right_cuda(C, V, mode, rows)))
        t_ms = cuda_ms(lambda: solve_right_cuda(C, V, mode), 200)
        t_graph = graph_ms(lambda: solve_right_cuda(C, V, mode))
        t_plain = cuda_ms(lambda: solve_right_reference(C, V, mode), 200)
        # the library call alone (cuBLAS trsm), on a triangle made beforehand
        trsm = lambda: torch.linalg.solve_triangular(op, V, upper=mode == "CT", left=False)
        l_ms, l_graph = cuda_ms(trsm, 200), graph_ms(trsm)
        say("m", trisolve_mode=mode, trisolve_ms=t_ms, trisolve_graph_ms=t_graph,
            trisolve_plain_ms=t_plain, trisolve_library_ms=l_ms, trisolve_library_graph_ms=l_graph,
            faster_than_trsm_events=t_ms < l_ms, faster_than_trsm_graph=t_graph < l_graph,
            shape=f"{n}x{d}")
        out[f"trisolve_{mode}"] = (t_graph, t_plain, l_graph)
    return out


# ---------------------------------------------------------------------------
# The proximal and score-gradient slice: the rest of K3 and K4's Gaussian
# ---------------------------------------------------------------------------

NLN_DIMS = 10            # make_normallognormal(n_dims=10): d = 11
NLN_STEPS = 50_000       # full-rank proximal ADVI against the analytic optimum
NLN_GENERAL_STEPS = 1_000
AGREE_STEPS = 2_000      # fused vs general on one key
# DoWG and DoG start with r0 = 1e-6 (1 + |x0|): their first steps move the
# scale by less than its float32 rounding, so there the plain version in
# float32 is itself ~1e-3 from float64.  Their kernel/plain comparisons
# start after this many steps of the kernel, where float32 holds ~1e-7.
WARM = 300


def slice_branches():
    """The proximal branches and the VarGrad branches of phase (n)."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedBranch

    prox = [FusedBranch(a, e, "repgrad", "prox") for a in ("descent", "dowg", "dog")
            for e in ("closed_form_zero_grad", "stl_zero_grad")]
    vargrad = [FusedBranch(a, "stl", "scoregrad", o)
               for a in ("adam", "descent", "dowg", "dog", "cocob") for o in ("clip", "none")]
    return prox, vargrad


def nln_target(dev):
    """make_normallognormal(n_dims=10): (target, analytic location, scale)."""
    from advancedvi_jl_tpu_torch.models.normallognormal import make_normallognormal

    return make_normallognormal(SEED, NLN_DIMS, device=dev)


def branch_cases(dev):
    """Phase (n)'s cases: (tag, family, spec, initial scale, branch, lr,
    DoWG/DoG alpha, warm-up steps, injected-noise steps, Philox steps)."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedBranch

    prox, vargrad = slice_branches()
    prob = flagship(dev)
    lr_spec = avt.logreg_spec(prob.X, prob.y)
    g_spec = avt.normallognormal_spec(nln_target(dev)[0])
    _, mu, L = normal_fullrank_wellcond(3, FR_FUSED_D, device=dev)
    d, dg = lr_spec.dim, g_spec.dim
    mf_lr, mf_g = 0.1 * torch.ones(d), 0.2 * torch.ones(dg)
    fr_lr, fr_g = 0.1 * torch.eye(d), 0.2 * torch.eye(dg)

    def case(tag, family, spec, scale, b, lr=LR, alpha=1e-6, warm=None, steps=(50, 200)):
        if warm is None:
            warm = WARM if b.algo in ("dowg", "dog") else 0
        return (tag, family, spec, scale, b, lr, alpha, warm) + steps

    cases = [case("mf-logreg", "meanfield", lr_spec, mf_lr, b) for b in prox]
    for b in vargrad:
        if (b.algo, b.operator) == ("dowg", "none"):
            # without ClipScale, sigma crosses zero within ~60 steps (the
            # reference's own behaviour): 10 steps after 40
            cases.append(case("mf-logreg", "meanfield", lr_spec, mf_lr, b, warm=40,
                              steps=(10, 10)))
        else:  # VarGrad's score gradient on the logreg is ~100x the pathwise one
            cases.append(case("mf-logreg", "meanfield", lr_spec, mf_lr, b,
                              lr=1e-5 if b.algo == "descent" else LR))
    cases += [case("mf-gaussian", "meanfield", g_spec, mf_g, b)
              for b in (FusedBranch(), prox[1], prox[2], vargrad[7], vargrad[8])]
    for b in prox:
        # full-rank proximal descent/DoWG/DoG on the logreg is fragile (the
        # JAX package's own finding): a smaller step and r0 scale; DoWG's
        # step size runs away after ~40 steps, so it is held for 10 after 20
        if b.algo == "dowg":
            cases.append(case("fr-logreg", "fullrank", lr_spec, fr_lr, b, alpha=1e-4, warm=20,
                              steps=(10, 10)))
        else:
            cases.append(case("fr-logreg", "fullrank", lr_spec, fr_lr, b, lr=1e-4, alpha=1e-4,
                              warm=100 if b.algo == "dog" else 0))
        cases.append(case("fr-gaussian", "fullrank", g_spec, fr_g, b))
    cases.append(case("fr-logreg", "fullrank", lr_spec, fr_lr,
                      FusedBranch("cocob", "stl", "repgrad", "clip")))
    cases.append(case("fr-mvnormal", "fullrank", avt.mvnormal_spec(mu, L), torch.eye(FR_FUSED_D),
                      prox[2]))
    return cases


def case_engine(dev, family, spec, branch, lr, alpha):
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedADVI

    eng = FusedADVI(spec, family=family, n_samples=N_SAMPLES, lr=lr)
    eng.algo, eng.entropy, eng.grad_est, eng.operator = (
        branch.algo, branch.entropy, branch.grad_est, branch.operator)
    eng.alpha = alpha
    return eng


def state_tensors(out, nr):
    """The state rows (and full-rank matrices) of a run's first ``nr``
    outputs, one tensor each."""
    return [t for x in out[:nr] for t in x]


def compare_tensors(tag, got, want, rtol):
    """Each state row or matrix within ``rtol`` of the plain version,
    norm-wise (max |a - b| <= rtol max |b|); returns the largest norm-wise
    relative error."""
    errs = [max_err(a, b) for a, b in zip(got, want)]
    scales = [float(b.abs().max()) for b in want]
    bad = [i for i, (e, m) in enumerate(zip(errs, scales)) if not e <= rtol * m]
    if bad:
        for i, (e, m) in enumerate(zip(errs, scales)):
            print(f"    row {i}: max_abs_err={e:.3e} max_abs={m:.3e}", flush=True)
    check(not bad, f"{tag}: state rows {bad} over rtol {rtol} (norm-wise)")
    return max(e / m for e, m in zip(errs, scales) if m > 0)


def parameter_err(out, nr):
    """The largest absolute difference of the parameters and their
    averages (mu, sig, avg_mu, avg_sig) between two runs' outputs."""
    if nr == 1:  # mean-field rows STATE_FIELDS
        return max(max_err(out[0][0][i], out[1][0][i]) for i in (0, 1, 6, 7))
    (kv, km), (rv, rm) = out  # full-rank FR_VEC_FIELDS, FR_MAT_FIELDS
    return max(max_err(a[i], b[i]) for a, b in ((kv, rv), (km, rm)) for i in (0, 3))


def phase_n(dev):
    """Every new branch of both fused kernels against its plain version:
    50 steps of injected noise (rtol 1e-5, traced equal to untraced) and 200
    Philox steps (rtol 1e-4, one launch equal to two), fewer for the two
    runaway configurations (branch_cases).  Returns each launch group's
    largest parameter error after the injected-noise steps."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        LAUNCH_GROUPS, fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference,
        fused_run_chunk_cuda, fused_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    seed = seed_words(SEED)
    worst = dict.fromkeys(LAUNCH_GROUPS, 0.0)
    t0 = time.perf_counter()
    cases = branch_cases(dev)
    for tag, family, spec, scale0, b, lr, alpha, warm, n_noise, n_philox in cases:
        eng = case_engine(dev, family, spec, b, lr, alpha)
        st = eng.init(torch.zeros(spec.dim, device=dev), scale0.to(dev))
        if family == "fullrank":
            rows = st.stacked_fullrank()
            kern, plain = fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference
        else:
            rows = (st.stacked(),)
            kern, plain = fused_run_chunk_cuda, fused_run_chunk_reference
        nr = len(rows)
        branch = eng.branch()

        def run(fn, rows, it0, steps, noise=None, log_every=0):
            return fn(spec.model, spec.consts, spec.scalars, *rows, seed, it0, steps, N_SAMPLES,
                      eng.hyp, noise, log_every, branch)

        if warm:
            rows = run(kern, rows, 0, warm)[:nr]
        noise = torch.randn((n_noise, N_SAMPLES, spec.dim),
                            generator=torch.Generator().manual_seed(5)).to(dev)
        k = run(kern, rows, warm, n_noise, noise, n_noise // 5)
        ku = run(kern, rows, warm, n_noise, noise)
        r = run(plain, rows, warm, n_noise, noise, n_noise // 5)
        one = run(kern, rows, warm, n_philox)
        half = run(kern, rows, warm, n_philox // 2)
        two = run(kern, half[:nr], warm + n_philox // 2, n_philox // 2)
        ref = run(plain, rows, warm, n_philox)
        torch.cuda.synchronize()
        label = f"{tag}:{b.algo}/{b.entropy}/{b.grad_est}/{b.operator}"
        check(all(bool(torch.isfinite(t).all()) for t in state_tensors(one, nr)),
              f"{label}: not finite")
        rel = compare_tensors(f"{label}, injected noise", state_tensors(k, nr),
                              state_tensors(r, nr), 1e-5)
        err = parameter_err((k[:nr], r[:nr]), nr)
        check(torch.allclose(k[nr], r[nr], rtol=1e-5, atol=1e-4), f"{label}: ELBO differs")
        check(torch.allclose(k[nr + 1], r[nr + 1], rtol=1e-5, atol=1e-4),
              f"{label}: trace rows differ")
        check(all(torch.equal(a, c) for a, c in zip(k[:nr + 1], ku[:nr + 1])),
              f"{label}: traced and untraced launches differ")
        check(all(torch.equal(a, c) for a, c in zip(one[:nr + 1], two[:nr + 1])),
              f"{label}: one Philox launch differs from two")
        compare_tensors(f"{label}, Philox, {n_philox} steps", state_tensors(one, nr),
                        state_tensors(ref, nr), 1e-4)
        check(torch.allclose(one[nr], ref[nr], rtol=1e-4, atol=1e-3),
              f"{label}: ELBO after {n_philox} Philox steps differs")
        for g in b.groups(spec.model):
            worst[g] = max(worst[g], err)
        say("n", case=label, d=spec.dim, warm=warm, steps=f"{n_noise},{n_philox}",
            parameter_max_abs_err=f"{err:.3e}", state_max_rel_err=f"{rel:.3e}",
            elbo_kernel=float(k[nr]), elbo_plain=float(r[nr]))
    say("n", cases=len(cases), chunked_bitwise=True, traced_bitwise=True,
        seconds=f"{time.perf_counter() - t0:.2f}")
    return worst


def slice_general(dev):
    """(o) The slice's general paths through ``optimize``, with counted
    launches: proximal ADVI and BBVI on the mean-field flagship, proximal
    ADVI on the full-rank family and normal-lognormal."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words

    prob = flagship(dev)
    d = prob.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    t, mu, _ = nln_target(dev)
    dg = mu.shape[0]
    fq0 = avt.FullRankGaussian(torch.zeros(dg, device=dev), torch.eye(dg, device=dev),
                               solve_mode="pallas")
    runs = {
        "prox": (avt.KLMinRepGradProxDescent(n_samples=N_SAMPLES, optimizer=avt.dowg()),
                 prob.unconstrained(), q0, AGREE_STEPS),
        "bbvi": (avt.KLMinScoreGradDescent(n_samples=N_SAMPLES, optimizer=avt.dowg(),
                                           operator=avt.ClipScale()),
                 prob.unconstrained(), q0, AGREE_STEPS),
        "prox_fullrank_nln": (avt.KLMinRepGradProxDescent(n_samples=N_SAMPLES,
                                                          optimizer=avt.dowg()),
                              t.unconstrained(), fq0, NLN_GENERAL_STEPS),
    }
    # the ELBO of each start, 1,000 draws (not counted: before the reset)
    key = PhiloxKey(seed_words(SEED + 1), 0)
    start = {name: -float(alg.estimate_objective(key, q, target, n_samples=1000))
             for name, (alg, target, q, _) in runs.items()}
    torch.cuda.synchronize()
    reset_launches()
    out = {}
    for name, (alg, target, q, steps) in runs.items():
        t0 = time.perf_counter()
        gq, infos, _ = avt.optimize(SEED, alg, steps, target, q, log_every=LOG_EVERY)
        torch.cuda.synchronize()
        elbos = [r["elbo"] for r in infos]
        say("o", path=name, steps=steps, elbo_start=start[name], elbo_first_row=elbos[0],
            elbo_last_row=elbos[-1], seconds=f"{time.perf_counter() - t0:.2f}")
        check(all(math.isfinite(e) for e in elbos), f"general {name}: ELBO not finite")
        check(elbos[-1] > start[name], f"general {name}: ELBO did not rise from the start")
        out[name] = gq
    counts = read_launches()
    say("o", meanfield_sample_launches=counts["meanfield_sample"],
        fullrank_sample_launches=counts["fullrank_sample"])
    check(counts["meanfield_sample"] > 0, "the mean-field general paths launched no sampler")
    check(counts["fullrank_sample"] > 0, "the full-rank general path launched no sampler")
    return out, counts


def slice_engines(dev):
    """The slice's fused engines on the flagship, and full-rank proximal
    ADVI on normal-lognormal: (name, engine, q0)."""
    import advancedvi_jl_tpu_torch as avt

    prob = flagship(dev)
    spec = avt.logreg_spec(prob.X, prob.y)
    d = prob.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    t, mu, _ = nln_target(dev)
    dg = mu.shape[0]
    fq0 = avt.FullRankGaussian(torch.zeros(dg, device=dev), torch.eye(dg, device=dev))
    return {
        "prox": (avt.FusedProxADVI(spec, n_samples=N_SAMPLES), q0),
        "bbvi": (avt.FusedScoreGradVI(spec, n_samples=N_SAMPLES, operator="clip"), q0),
        "bbvi_cocob": (avt.FusedScoreGradVI(spec, n_samples=N_SAMPLES, optimizer="cocob",
                                            operator="clip"), q0),
        "prox_fullrank_nln": (avt.FusedProxADVI(avt.normallognormal_spec(t), family="fullrank",
                                                n_samples=N_SAMPLES), fq0),
    }


def slice_fused(dev, general):
    """(p) The slice's fused engines through ``optimize``, with counted
    launches: tail ELBO at 20,000 steps on the flagship, fused vs general on
    one key at 2,000, full-rank proximal ADVI on normal-lognormal against
    the analytic optimum at 50,000."""
    _, mu, sd = nln_target(dev)
    engines = slice_engines(dev)
    torch.cuda.synchronize()
    reset_launches()
    for name, (eng, q0) in engines.items():
        t0 = time.perf_counter()
        if name == "prox_fullrank_nln":
            q, rows, _ = eng.optimize(SEED, NLN_STEPS, q0, log_every=1000)
            torch.cuda.synchronize()
            loc_err = max_err(q.location, mu)
            diag_err = max_err(torch.diagonal(q.scale), sd)
            say("p", engine=name, d=mu.shape[0], steps=NLN_STEPS, elbo_last=rows[-1]["elbo"],
                location_max_abs_err=loc_err, scale_diag_max_abs_err=diag_err,
                seconds=f"{time.perf_counter() - t0:.2f}")
            check(loc_err < 0.02 and diag_err < 0.02,
                  f"full-rank proximal ADVI: {loc_err}, {diag_err} from the optimum (>= 0.02)")
            continue
        qa, rows, st = eng.optimize(SEED, AGREE_STEPS, q0, log_every=LOG_EVERY)
        _, more, _ = eng.optimize(SEED, FUSED_STEPS - AGREE_STEPS, state=st, log_every=LOG_EVERY)
        torch.cuda.synchronize()
        rows += more
        tail = tail_elbo(rows)
        fields = dict(engine=name, steps=FUSED_STEPS, elbo_last=rows[-1]["elbo"],
                      elbo_tail_mean=tail, seconds=f"{time.perf_counter() - t0:.2f}")
        if name in general:
            diff = max_err(qa.location, general[name].location)
            fields[f"averaged_location_max_abs_diff_vs_general_at_{AGREE_STEPS}"] = diff
            check(diff <= 1e-3, f"fused vs general {name}: location {diff} > 1e-3 apart")
        say("p", **fields)
        check(all(math.isfinite(r["elbo"]) for r in rows), f"fused {name}: ELBO not finite")
        check(tail > -150.0, f"fused {name}: tail ELBO {tail} <= -150 (not converged)")
    counts = read_launches()
    say("p", fused_meanfield_launches=counts["fused_advi_meanfield"],
        fused_fullrank_launches=counts["fused_advi_fullrank"],
        **{f"{g}_launches": counts[g] for g in ("k3_rules", "k3_vargrad", "k4_gaussian")})
    for g in ("fused_advi_meanfield", "fused_advi_fullrank", "k3_rules", "k3_vargrad",
              "k4_gaussian"):
        check(counts[g] > 0, f"the slice's fused engines launched no {g} kernel")
    return counts


def phase_q(dev, card):
    """Steps/s of each new fused engine beside its plain version (200-step
    chunks, CUDA events; kernel, plain, kernel) and of the two mean-field
    general paths over 500 steps."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference,
        fused_run_chunk_cuda, fused_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    seed = seed_words(SEED)
    engines = slice_engines(dev)
    prob = flagship(dev)
    fr = case_engine(dev, "fullrank", avt.logreg_spec(prob.X, prob.y),
                     engines["prox"][0].branch(), LR, 1e-4)
    engines["prox_fullrank_logreg"] = (fr, avt.FullRankGaussian(
        torch.zeros(prob.dim, device=dev), 0.1 * torch.eye(prob.dim, device=dev)))
    out = {}
    for name, (eng, q0) in engines.items():
        spec, branch = eng.model, eng.branch()
        if eng.family == "fullrank":
            rows = eng.init(q0.location, q0.scale_matrix()).stacked_fullrank()
            kern, plain = fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference
        else:
            rows = (eng.init(q0.location, q0.scale_diag).stacked(),)
            kern, plain = fused_run_chunk_cuda, fused_run_chunk_reference
        args = (spec.model, spec.consts, spec.scalars, *rows, seed, 0, 200, N_SAMPLES, eng.hyp,
                None, 0, branch)
        k_ms = cuda_ms(lambda: kern(*args), 10)
        p_ms = cuda_ms(lambda: plain(*args), 1)
        k_ms2 = cuda_ms(lambda: kern(*args), 10)
        best = min(k_ms, k_ms2)
        say("q", card=f"'{card}'", engine=name, d=spec.dim, chunk_steps=200,
            kernel_ms=f"{k_ms},{k_ms2}", plain_ms=p_ms,
            fused_steps_per_s=f"{200 / (best / 1e3):.1f}",
            plain_steps_per_s=f"{200 / (p_ms / 1e3):.1f}")
        out[name] = (best, p_ms)
    target = prob.unconstrained()
    d = prob.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    for name, alg in (("prox", avt.KLMinRepGradProxDescent(n_samples=N_SAMPLES)),
                      ("bbvi", avt.KLMinScoreGradDescent(n_samples=N_SAMPLES,
                                                         operator=avt.ClipScale()))):
        s = alg.init(SEED, q0, target)
        for _ in range(50):
            s, _ = alg.step(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            s, _ = alg.step(s)
        torch.cuda.synchronize()
        say("q", card=f"'{card}'", general=name,
            general_steps_per_s=f"{500 / (time.perf_counter() - t0):.1f}")
    return out


# ---------------------------------------------------------------------------
# The subsampling slice: K4's minibatch body (three transports), K9, and the
# general subsampled paths
# ---------------------------------------------------------------------------

MB_N, MB_B = 16_384, 512      # _fused_mb_chip.py: make_logreg(16_384, 60), B = 512
STREAM_N, STREAM_P = 500_000, 60  # _round5_chip.py section 5: the streamed logreg
MB_NOISE_STEPS = 65           # > 2 nb + 1 = 65 at nb = 32: wraps the schedule twice
MB_AGREE_STEPS = MB_N // MB_B  # one epoch: fused and general see the same batches
MB_GENERAL_STEPS = 500
BNN_N, BNN_IN, BNN_HIDDEN, BNN_B, BNN_SAMPLES = 16_384, 32, 256, 2048, 16  # bench_large.py
BNN_STEPS = 200
SN_STEPS = 2_000              # subsampled normals: tests/test_subsampling.py:91-106
TRANSPORTS = ("inplace", "staged", "prefetch")
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12  # H100 SXM peaks: float32 without tensor cores, HBM


def bound(flops: float, nbytes: float, issue_ms: float = 0.0):
    """(bound_ms, bound_by): the largest of the operations over the float32
    peak, the bytes over the memory rate and (the samplers, whose Philox and
    Box-Muller work is integer and transcendental code) the instructions
    over the card's issue rate, ``issue_ms``, also "operations"."""
    t_ops = max(flops / F32_FLOPS * 1e3, issue_ms)
    t_bytes = nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def large_logreg(dev):
    from advancedvi_jl_tpu_torch.models.logreg import make_logreg

    return make_logreg(21, n_data=MB_N, n_features=N_FEATURES, device=dev)


def streamed_data(dev):
    """_round5_chip.py's streamed logreg at n = 500,000 x 60 (no intercept),
    drawn on the card: X ~ N(0, 1), y ~ Bernoulli(sigmoid(X beta)),
    beta ~ N(0, 0.25)."""
    g = torch.Generator(device=dev).manual_seed(21)
    X = torch.randn(STREAM_N, STREAM_P, generator=g, device=dev)
    beta = 0.5 * torch.randn(STREAM_P, generator=g, device=dev)
    y = (torch.rand(STREAM_N, generator=g, device=dev) < torch.sigmoid(X @ beta)).float()
    return X, y


def mb_specs(X, y, gen=3):
    """The in-place, staged and prefetching specs of one permutation."""
    import advancedvi_jl_tpu_torch as avt

    kw = dict(batch_size=MB_B, generator=gen)
    return dict(zip(TRANSPORTS, (avt.logreg_minibatch_spec(X, y, **kw),
                                 avt.logreg_minibatch_hbm_spec(X, y, prefetch=False, **kw),
                                 avt.logreg_minibatch_hbm_spec(X, y, **kw))))


def mb_flops_bytes(spec, n, steps):
    """Operations and bytes of a ``steps``-step mean-field minibatch chunk:
    two (n, B, db) products a step; the slabs the steps read, each once, and
    the state in and out."""
    X, yX = spec.consts
    nb, db = yX.shape
    B, d = X.shape[0] // nb, spec.dim
    macs = 2 * n * B * db
    rows = min(steps, nb) * B
    return 2.0 * macs * steps, 4.0 * (rows * db + min(steps, nb) * db + 16 * d)


def phase_r(dev):
    """K4's minibatch body against its plain version: every transport x
    {STL x Adam x clip, prox-DoWG closed-form zero, VarGrad-DoWG-clip}
    mean-field and {STL x Adam x clip, prox-DoWG} full-rank at n = 16,384,
    B = 512 (65 injected-noise steps, rtol 1e-5; 200 Philox steps, rtol
    1e-4), and every transport of the flagship branch at n = 500,000; the
    transports bit-equal; one launch equal to a 3 + rest split (a cut
    between a prefetch and its use); traced equal to untraced.  The plain
    version reads the slab one way for all three transports, so it runs
    once a case.  Returns each transport's largest parameter error after
    the injected-noise steps."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        GROUP_MB, FusedBranch, fused_fullrank_run_chunk_cuda,
        fused_fullrank_run_chunk_reference, fused_run_chunk_cuda, fused_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    seed = seed_words(SEED)
    prob = large_logreg(dev)
    Xs, ys = streamed_data(dev)
    data = {"16k": mb_specs(prob.X, prob.y), "500k": mb_specs(Xs, ys)}
    prox, vargrad = slice_branches()
    cases = [("meanfield", "16k", b) for b in (FusedBranch(), prox[2], vargrad[4])]
    cases += [("fullrank", "16k", b) for b in (FusedBranch(), prox[2])]
    cases.append(("meanfield", "500k", FusedBranch()))
    worst = dict.fromkeys(TRANSPORTS, 0.0)
    t0 = time.perf_counter()
    for family, size, b in cases:
        specs = data[size]
        spec0 = specs[TRANSPORTS[0]]
        d = spec0.dim
        eng = case_engine(dev, family, spec0, b, LR, 1e-6)
        st = eng.init(torch.zeros(d, device=dev), 0.1 * (
            torch.ones(d, device=dev) if family == "meanfield" else torch.eye(d, device=dev)))
        if family == "meanfield":
            rows = (st.stacked(),)
            kern, plain = fused_run_chunk_cuda, fused_run_chunk_reference
        else:
            rows = st.stacked_fullrank()
            kern, plain = fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference
        nr, branch = len(rows), eng.branch()

        def run(fn, spec, rows, it0, steps, noise=None, log_every=0):
            return fn(spec.model, spec.consts, spec.scalars, *rows, seed, it0, steps,
                      N_SAMPLES, eng.hyp, noise, log_every, branch)

        warm = WARM if b.algo in ("dowg", "dog") else 0
        n_noise, n_philox = MB_NOISE_STEPS, 200
        if family == "fullrank" and b.algo == "dowg":
            # full-rank proximal DoWG on the logreg runs away within ~40 steps
            # (phase (n)): 10 + 10 steps after 20, a larger r0
            warm, n_noise, n_philox = 20, 10, 10
            eng.alpha = 1e-4
        if warm:
            rows = run(kern, spec0, rows, 0, warm)[:nr]
        noise = torch.randn((n_noise, N_SAMPLES, d),
                            generator=torch.Generator().manual_seed(5)).to(dev)
        r = run(plain, spec0, rows, warm, n_noise, noise, n_noise // 5)
        ref = run(plain, spec0, rows, warm, n_philox)
        outs = {}
        for tr, spec in specs.items():
            k = run(kern, spec, rows, warm, n_noise, noise, n_noise // 5)
            ku = run(kern, spec, rows, warm, n_noise, noise)
            one = run(kern, spec, rows, warm, n_philox)
            two = run(kern, spec, run(kern, spec, rows, warm, 3)[:nr], warm + 3, n_philox - 3)
            torch.cuda.synchronize()
            label = f"{family}-{size}:{tr}:{b.algo}/{b.entropy}/{b.grad_est}/{b.operator}"
            check(all(bool(torch.isfinite(t).all()) for t in state_tensors(one, nr)),
                  f"{label}: not finite")
            rel = compare_tensors(f"{label}, injected noise", state_tensors(k, nr),
                                  state_tensors(r, nr), 1e-5)
            err = parameter_err((k[:nr], r[:nr]), nr)
            check(torch.allclose(k[nr], r[nr], rtol=1e-5, atol=1e-4), f"{label}: ELBO differs")
            check(torch.allclose(k[nr + 1], r[nr + 1], rtol=1e-5, atol=1e-4),
                  f"{label}: trace rows differ")
            check(all(torch.equal(a, c) for a, c in zip(k[:nr + 1], ku[:nr + 1])),
                  f"{label}: traced and untraced launches differ")
            check(all(torch.equal(a, c) for a, c in zip(one[:nr + 1], two[:nr + 1])),
                  f"{label}: one Philox launch differs from a 3 + rest split")
            compare_tensors(f"{label}, Philox, {n_philox} steps", state_tensors(one, nr),
                            state_tensors(ref, nr), 1e-4)
            check(torch.allclose(one[nr], ref[nr], rtol=1e-4, atol=1e-3),
                  f"{label}: ELBO after {n_philox} Philox steps differs")
            check(kern.group_launches[GROUP_MB[spec.model]] > 0, f"{label}: not counted")
            worst[tr] = max(worst[tr], err)
            outs[tr] = (k, one)
            say("r", case=label, d=d, n_data=spec.consts[0].shape[0], warm=warm,
                steps=f"{n_noise},{n_philox}", parameter_max_abs_err=f"{err:.3e}",
                state_max_rel_err=f"{rel:.3e}", elbo_kernel=float(k[nr]),
                elbo_plain=float(r[nr]))
        first = outs[TRANSPORTS[0]]
        same = all(all(torch.equal(a, c) for a, c in zip(x[:nr + 1], y[:nr + 1]))
                   for o in outs.values() for x, y in zip(first, o))
        check(same, f"{family}-{size}/{b.algo}: the transports differ on the same arguments")
        say("r", case=f"{family}-{size}:{b.algo}/{b.entropy}/{b.grad_est}",
            transports=len(outs), transports_bitwise_equal=same)
    say("r", chunked_bitwise=True, traced_bitwise=True,
        seconds=f"{time.perf_counter() - t0:.2f}")
    return worst


def phase_s(dev):
    """K9: the four probes through ``run_probes`` (counted), then each
    against its plain version, exactly; each probe's card time by CUDA-graph
    replay beside an empty kernel of its geometry, and its host time per
    call."""
    from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import (
        probe_cuda, probe_inputs, probe_plan, probe_reference, run_probes,
    )

    torch.cuda.synchronize()
    reset_launches()
    outs = run_probes(dev)
    torch.cuda.synchronize()
    launches = probe_cuda.launches
    check(launches == 4, f"the probes made {launches} launches, expected 4")
    err = 0.0
    for i, x in probe_inputs(dev).items():
        want = probe_reference(i, x, device=dev)
        err = max(err, max_err(outs[i], want))
        check(torch.equal(outs[i], want), f"probe {i} differs from its plain version")
    x = torch.arange(24 * 128, dtype=torch.float32, device=dev).reshape(24, 128) % 7
    check(torch.equal(probe_cuda(4, x), probe_reference(4, x)), "probe 4: rem schedule differs")
    say("s", probes=4, launches=launches, exact=True,
        values=[float(outs[i][-1, 0]) for i in (1, 2, 3, 4)])
    inputs = probe_inputs(dev)
    ms = cuda_ms(lambda: [probe_cuda(i, x, device=dev) for i, x in inputs.items()], 20)
    plain_ms = cuda_ms(lambda: [probe_reference(i, x, device=dev)
                                for i, x in inputs.items()], 3)
    graph = probe_graph_ms(dev)
    plans = {i: probe_plan(i) for i in inputs}
    floors = dict(zip(plans, launch_floor_ms([((1, 1), (p.threads, 1)) for p in plans.values()])))
    for i, x in inputs.items():
        say("s", probe=i, threads=plans[i].threads, units=plans[i].units,
            graph_ms=graph[i], floor_graph_ms=floors[i],
            over_floor=f"{graph[i] / floors[i]:.3f}",
            host_us=f"{host_us(lambda: probe_cuda(i, x, device=dev)):.3f}")
    say("s", probes_events_ms=ms, probes_graph_ms=sum(graph.values()), probes_plain_ms=plain_ms)
    # bytes: the two inputs read and the four outputs written, once each
    nbytes = 4.0 * (128 * 128 + 24 * 128 + 128 + 16 * 128 + 8 * 128 + 128)
    return {"launches": launches, "max_abs_err": err, "ms": sum(graph.values()),
            "plain_ms": plain_ms, "bound": bound(2.0 * 128 * 128 * 2, nbytes)}


def probe_graph_ms(dev) -> dict:
    """Each probe's milliseconds on the card by CUDA-graph replay, at
    ``_pallas_probe.py``'s inputs."""
    from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import probe_cuda, probe_inputs

    return {i: graph_ms(lambda i=i, x=x: probe_cuda(i, x, device=dev), 200)
            for i, x in probe_inputs(dev).items()}


def bnn_problem(dev):
    import advancedvi_jl_tpu_torch as avt

    bnn = avt.make_bnn(1, n_data=BNN_N, in_dim=BNN_IN, hidden=BNN_HIDDEN, device=dev)
    d = bnn.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.05 * torch.ones(d, device=dev))
    sub = avt.ReshufflingBatchSubsampling(BNN_N, BNN_B)
    return bnn, q0, {
        "bnn_advi": avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=BNN_SAMPLES,
                                            subsampling=sub, optimizer=avt.adam(LR),
                                            operator=avt.ClipScale()),
        "bnn_prox_dowg": avt.KLMinRepGradProxDescent(
            entropy_zerograd=avt.CLOSED_FORM_ZERO_GRAD, n_samples=BNN_SAMPLES,
            subsampling=sub, optimizer=avt.dowg(), averager=avt.PolynomialAveraging()),
    }


def mb_general_alg():
    import advancedvi_jl_tpu_torch as avt

    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                   subsampling=avt.ReshufflingBatchSubsampling(MB_N, MB_B),
                                   optimizer=avt.adam(LR), operator=avt.ClipScale())


def phase_t(dev):
    """The general subsampled paths on the card through ``optimize``,
    counted: ADVI on the large-n logreg, the BNN (ADVI and proximal DoWG,
    bench_large.py's pair), and subsampled normals against their analytic
    posterior.  Returns the logreg run's state."""
    import advancedvi_jl_tpu_torch as avt

    prob = large_logreg(dev)
    d = prob.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    bnn, bq0, bnn_algs = bnn_problem(dev)
    sn, mu, L = avt.subsampled_normals(2, 8, device=dev)
    sn_alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=10,
                                     subsampling=avt.ReshufflingBatchSubsampling(8, 1),
                                     optimizer=avt.descent(3e-3), operator=avt.ClipScale())
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, infos, lr_state = avt.optimize(SEED, mb_general_alg(), MB_GENERAL_STEPS,
                                      prob.unconstrained(), q0, log_every=LOG_EVERY)
    torch.cuda.synchronize()
    elbos = [r["elbo"] for r in infos]
    say("t", path="logreg_subsampled_advi", n_data=MB_N, batch=MB_B, steps=MB_GENERAL_STEPS,
        elbo_first_row=elbos[0], elbo_last_row=elbos[-1], epoch=infos[-1]["epoch"],
        seconds=f"{time.perf_counter() - t0:.2f}")
    check(all(math.isfinite(e) for e in elbos) and elbos[-1] > elbos[0],
          "general subsampled logreg: ELBO not finite or not rising")
    for name, alg in bnn_algs.items():
        t0 = time.perf_counter()
        _, infos, _ = avt.optimize(SEED, alg, BNN_STEPS, bnn, bq0, log_every=10)
        torch.cuda.synchronize()
        elbos = [r["elbo"] for r in infos]
        # bench_large.py's check: finite; the first and last five of 20 rows
        first, last = sum(elbos[:5]) / 5, sum(elbos[-5:]) / 5
        say("t", path=name, d=bnn.dim, batch=BNN_B, n_samples=BNN_SAMPLES, steps=BNN_STEPS,
            elbo_first5=first, elbo_last5=last, seconds=f"{time.perf_counter() - t0:.2f}")
        check(all(math.isfinite(e) for e in elbos), f"general {name}: ELBO not finite")
    t0 = time.perf_counter()
    q0s = avt.FullRankGaussian(torch.zeros(1, device=dev), solve_mode="pallas")
    out, _, _ = avt.optimize(SEED, sn_alg, SN_STEPS, sn, q0s, log_every=LOG_EVERY)
    torch.cuda.synchronize()
    loc_err = abs(float(out.location[0]) - float(mu[0]))
    sd_err = abs(float(out.scale[0, 0]) - float(L[0, 0]))
    say("t", path="subsampled_normals", steps=SN_STEPS, location_err=loc_err,
        scale_err=sd_err, seconds=f"{time.perf_counter() - t0:.2f}")
    check(loc_err < 0.1 and sd_err < 0.1, "subsampled normals: not within 0.1 of the posterior")
    counts = read_launches()
    say("t", meanfield_sample_launches=counts["meanfield_sample"],
        fullrank_sample_launches=counts["fullrank_sample"])
    check(counts["meanfield_sample"] > 0, "the general subsampled paths launched no K7a")
    return lr_state


def phase_u(dev, card, lr_state):
    """The fused minibatch engines through ``optimize`` (counted): 20,000
    steps on the large-n logreg reshuffling between chunks; fused against
    general on one key and the general schedule's first permutation for
    one epoch (1e-3), then a report past it; the streamed spec at n =
    500,000 with and without prefetch.  Then times: each transport's
    200-step chunk beside its plain version, one reshuffle at n = 500,000,
    and the general subsampled paths' steps/s."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        GROUP_MB, fused_run_chunk_cuda, fused_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words

    prob = large_logreg(dev)
    d = prob.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    Xs, ys = streamed_data(dev)
    gen_alg = mb_general_alg()
    first_perm = gen_alg.init(SEED, q0, prob.unconstrained()).obj_state.perm
    agree = avt.FusedADVI(avt.logreg_minibatch_spec(prob.X, prob.y, MB_B, perm=first_perm),
                          n_samples=N_SAMPLES, lr=LR)
    runs = {"inplace_16k": (avt.logreg_minibatch_spec(prob.X, prob.y, MB_B, generator=3), q0)}
    dq0 = avt.MeanFieldGaussian(torch.zeros(STREAM_P + 1, device=dev),
                                0.1 * torch.ones(STREAM_P + 1, device=dev))
    for prefetch in (False, True):
        runs[f"{'prefetch' if prefetch else 'staged'}_500k"] = (
            avt.logreg_minibatch_hbm_spec(Xs, ys, MB_B, generator=3, prefetch=prefetch), dq0)
    torch.cuda.synchronize()
    reset_launches()
    for name, (spec, q) in runs.items():
        eng = avt.FusedADVI(spec, n_samples=N_SAMPLES, lr=LR)
        t0 = time.perf_counter()
        _, rows, _ = eng.optimize(SEED, FUSED_STEPS, q, log_every=LOG_EVERY, chunk_size=5_000)
        torch.cuda.synchronize()
        head = sum(r["elbo"] for r in rows[:TAIL_ROWS]) / len(rows[:TAIL_ROWS])
        tail = tail_elbo(rows)
        say("u", engine=name, steps=FUSED_STEPS, reshuffles=FUSED_STEPS // 5_000 - 1,
            elbo_head_mean=head, elbo_tail_mean=tail, elbo_last=rows[-1]["elbo"],
            seconds=f"{time.perf_counter() - t0:.2f}")
        check(all(math.isfinite(r["elbo"]) for r in rows), f"fused {name}: ELBO not finite")
        check(tail > head, f"fused {name}: tail ELBO {tail} did not improve on {head}")
    # one epoch on one key and one permutation: the same batches, the same draws
    qa, _, _ = agree.optimize(SEED, MB_AGREE_STEPS, q0, log_every=MB_AGREE_STEPS)
    qg, _, _ = avt.optimize(SEED, mb_general_alg(), MB_AGREE_STEPS, prob.unconstrained(), q0,
                            log_every=MB_AGREE_STEPS)
    torch.cuda.synchronize()
    counts = read_launches()
    diff = max_err(qa.location, qg.location)
    say("u", compare="fused_vs_general_one_epoch", steps=MB_AGREE_STEPS,
        averaged_location_max_abs_diff=diff)
    check(diff <= 1e-3, f"fused vs general minibatch: location {diff} > 1e-3 apart")
    for tr, g in GROUP_MB.items():
        check(counts[g] > 0, f"the fused minibatch engines launched no {g} kernel")
    # past the epoch (a report): the general schedule reshuffles every epoch,
    # the fused one between chunks; the general path's 500 timed steps
    qf500, _, _ = agree.optimize(SEED, MB_GENERAL_STEPS, q0, log_every=LOG_EVERY)
    qg500 = gen_alg.output(lr_state)
    key = PhiloxKey(seed_words(SEED + 9), 0)
    ev = {n: -float(gen_alg.estimate_objective(key, q, prob.unconstrained(), 4096))
          for n, q in (("fused", qf500), ("general", qg500))}
    say("u", compare="fused_vs_general_500_steps", max_abs_dloc=max_err(qf500.location,
                                                                        qg500.location),
        eval_elbo_fused=ev["fused"], eval_elbo_general=ev["general"])
    # times: 200-step chunks, kernel, plain, kernel.  Successive calls walk
    # the epoch (it0 advances 200 a call), so at n = 500,000 (976 batches) a
    # call's 200 slabs, 24.6 MB, were last read four or more calls before,
    # with at least 600 other slabs (73.7 MB) read since, and come from HBM,
    # not L2.  For contrast, the same
    # window every call (it0 = 0: 24.6 MB that stays in the 50 MB L2).
    seed = seed_words(SEED)
    times = {}
    large = mb_specs(prob.X, prob.y)
    cfgs = {"inplace": runs["inplace_16k"][0], "staged": large["staged"],
            "prefetch": large["prefetch"],
            "staged_500k": runs["staged_500k"][0], "prefetch_500k": runs["prefetch_500k"][0],
            "inplace_500k": avt.logreg_minibatch_spec(Xs, ys, MB_B, generator=3)}
    for name, spec in cfgs.items():
        eng = avt.FusedADVI(spec, n_samples=N_SAMPLES, lr=LR)
        rows = eng.init(torch.zeros(spec.dim, device=dev),
                        0.1 * torch.ones(spec.dim, device=dev)).stacked()
        walk = [0]

        def chunk(fn, step=200):
            it0, walk[0] = walk[0], walk[0] + step
            return fn(spec.model, spec.consts, spec.scalars, rows, seed, it0, 200, N_SAMPLES,
                      eng.hyp)

        k_ms = cuda_ms(lambda: chunk(fused_run_chunk_cuda), 10)
        p_ms = cuda_ms(lambda: chunk(fused_run_chunk_reference), 1)
        k_ms2 = cuda_ms(lambda: chunk(fused_run_chunk_cuda), 10)
        walk[0] = 0
        fixed_ms = cuda_ms(lambda: chunk(fused_run_chunk_cuda, 0), 10)
        best = min(k_ms, k_ms2)
        mf_split("u", name, (spec.model, spec.consts, spec.scalars, rows, seed, 0, 200,
                             N_SAMPLES, eng.hyp), best, walk=True)
        flops, nbytes = mb_flops_bytes(spec, N_SAMPLES, 200)
        b_ms, b_by = bound(flops, nbytes)
        times[name] = (best, p_ms, b_ms, b_by)
        say("u", card=f"'{card}'", transport=name, n_data=spec.consts[0].shape[0], batch=MB_B,
            chunk_steps=200, kernel_ms=f"{k_ms},{k_ms2}", kernel_ms_same_window=fixed_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            fused_steps_per_s=f"{200 / (best / 1e3):.1f}",
            plain_steps_per_s=f"{200 / (p_ms / 1e3):.1f}")
    spec = runs["prefetch_500k"][0]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spec.reshuffle(seed, 1)
    torch.cuda.synchronize()
    start.record()
    spec.reshuffle(seed, 2)
    stop.record()
    torch.cuda.synchronize()
    say("u", card=f"'{card}'", reshuffle_500k_ms=start.elapsed_time(stop))
    bnn, bq0, bnn_algs = bnn_problem(dev)
    general = {"logreg_subsampled_advi": (gen_alg, prob.unconstrained(), q0)}
    general.update({n: (a, bnn, bq0) for n, a in bnn_algs.items()})
    for name, (alg, target, q) in general.items():
        s = alg.init(SEED, q, target)
        for _ in range(20):
            s, _ = alg.step(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            s, _ = alg.step(s)
        torch.cuda.synchronize()
        say("u", card=f"'{card}'", general=name,
            general_steps_per_s=f"{100 / (time.perf_counter() - t0):.1f}")
    return counts, times


# ---------------------------------------------------------------------------
# The multi-chain and low-rank slice: K6, K7c, the chains paths and low-rank
# ADVI
# ---------------------------------------------------------------------------

CHAINS_C = 8                   # phase (v): tests/test_fused_chains.py's 8-row sweeps
CHAINS_SWEEP = (1, 8, 32, 128, 256, 512, 1024, 4096)
CHAINS_MAIN_C, CHAINS_MAIN_STEPS = 64, 20_000
CHAINS_WIDE_C = 1024           # several chains a block: the counted run and its checks
CHAINS_GENERAL_C, CHAINS_GENERAL_STEPS = 4, 500
MIXED_RULES = ["adam", "descent", "dowg", "dog", "cocob", "adam", "dowg", "cocob"]
LR_SHAPE = (65_536, 256, 8)    # BENCH_NOTES' low-rank sampler shape (n, d, r)
LR_D, LR_R, LR_STEPS = 12, 2, 3_000  # tests/test_lowrank_advi.py's convergence case
LR_FLAGSHIP_R, LR_FLAGSHIP_STEPS = 8, 2_000


def chains_engine(dev, spec, n_chains, seed=4, **kw):
    """A FusedChainsADVI and its initial state: locations 0.2 N(0, 1) (seeded)
    and scales 0.1."""
    import advancedvi_jl_tpu_torch as avt

    eng = avt.FusedChainsADVI(spec, n_chains=n_chains, n_samples=N_SAMPLES, **kw)
    g = torch.Generator().manual_seed(seed)
    st = eng.init((0.2 * torch.randn(n_chains, spec.dim, generator=g)).to(dev),
                  0.1 * torch.ones(n_chains, spec.dim, device=dev))
    return eng, st


def chains_case(dev, spec, n_chains, **kw):
    """An Adam(LR) engine of ``n_chains`` chains (with the engine arguments
    ``kw``), its stacked initial rows and its chains' seed words: the inputs
    of a timed or compared launch."""
    eng, st = chains_engine(dev, spec, n_chains, lr=LR, **kw)
    return eng, st.stacked(), eng.chain_seeds(SEED)


def chains_run(fn, eng, rows, seeds, it0, steps, noise=None, log_every=0, **kw):
    consts = eng.model.consts if eng.ad is None else eng.ad.consts  # K5: the engine's program
    return fn(eng.model.model, consts, eng.model.scalars, rows, seeds, it0, steps,
              N_SAMPLES, eng.hyp, noise, log_every, eng.branch(), eng.lrs, eng.rules, eng.ad,
              **kw)


def chains_split(phase, name, eng, rows, seeds, chunk_ms, launches=4):
    """Print the chains kernel's step by phase (MF_PHASES): thread 0 of
    block 0's SM cycles in the AVI_PHASE_CLOCKS build over ``launches``
    200-step chunks, each phase's share in microseconds of ``chunk_ms``' step
    (the build without counters); G chains a block beside it."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        chains_phase_cycles, fused_chains_run_chunk_cuda,
    )

    def run():
        return chains_run(fused_chains_run_chunk_cuda, eng, rows, seeds, 0, 200,
                          instrumented=True)

    run()
    torch.cuda.synchronize()
    chains_phase_cycles()  # the counters restart at zero
    inst_ms = cuda_ms(run, launches)
    cycles = list(chains_phase_cycles().values())
    total = sum(cycles)
    step_us = 1e3 * chunk_ms / 200
    say(phase, chains_phase_split=name, chains=eng.n_chains, G=eng.chains_per_block(),
        step_us=f"{step_us:.3f}", instrumented_chunk_ms=inst_ms,
        cycles_per_step=f"{total / ((launches + 1) * 200):.0f}",
        **{f"{p}_us": f"{step_us * c / total:.3f}" for p, c in zip(MF_PHASES, cycles)})


def phase_v(dev):
    """K6 against its plain version at C = 8 on the flagship logreg: 50
    injected-noise steps (norm-wise rtol 1e-5, traced equal to untraced),
    then 200 Philox steps (rtol 1e-4, a 3 + rest split bit-exact), for
    STL x Adam x clip, a per-chain lr sweep, a mixed sweep with COCOB and
    DoWG chains, prox-DoWG, VarGrad-DoWG-clip (those three after WARM
    steps) and the staged minibatch spec; chain c against the single-chain
    kernel keyed by chain_seed_words(seed, c); a chain given lr 1e7 named by
    first_chain_divergence.  Returns the largest parameter error after the
    injected-noise steps."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedBranch, fused_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        first_chain_divergence, fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words

    t0 = time.perf_counter()
    prob = flagship(dev)
    spec = avt.logreg_spec(prob.X, prob.y)
    big = large_logreg(dev)
    mb = mb_specs(big.X, big.y)["staged"]
    lrs = [1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 2e-3, 5e-4, 1e-3]
    cases = {
        "stl-adam-clip": (spec, {}),
        "lr-sweep": (spec, dict(lr=lrs)),
        "mixed": (spec, dict(optimizer=MIXED_RULES)),
        "prox-dowg": (spec, dict(optimizer="dowg", entropy="closed_form_zero_grad",
                                 operator="prox")),
        "vargrad-dowg-clip": (spec, dict(optimizer="dowg", grad_est="scoregrad",
                                         operator="clip")),
        "staged-minibatch": (mb, {}),
    }
    kern, plain = fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference
    worst = 0.0
    for name, (sp, kw) in cases.items():
        eng, st = chains_engine(dev, sp, CHAINS_C, **kw)
        rules = kw.get("optimizer", "adam")
        warm = WARM if any(r in ("dowg", "dog") for r in
                           ([rules] if isinstance(rules, str) else rules)) else 0
        if warm:
            st = eng.run_chunk(st, SEED, warm)
        rows, seeds = st.stacked(with_ext=eng.n_rows == 14), eng.chain_seeds(SEED)
        noise = torch.randn((50, CHAINS_C, N_SAMPLES, sp.dim),
                            generator=torch.Generator().manual_seed(5)).to(dev)
        k = chains_run(kern, eng, rows, seeds, warm, 50, noise, 10)
        ku = chains_run(kern, eng, rows, seeds, warm, 50, noise)
        r = chains_run(plain, eng, rows, seeds, warm, 50, noise, 10)
        one = chains_run(kern, eng, rows, seeds, warm, 200)
        a = chains_run(kern, eng, rows, seeds, warm, 3)
        b = chains_run(kern, eng, a[0], seeds, warm + 3, 197)
        ref = chains_run(plain, eng, rows, seeds, warm, 200)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(one[0]).all()), f"chains {name}: not finite")
        rel = compare_tensors(f"chains {name}, injected noise", list(k[0].flatten(0, 1)),
                              list(r[0].flatten(0, 1)), 1e-5)
        err = max_err(k[0][:, [0, 1, 6, 7]], r[0][:, [0, 1, 6, 7]])
        worst = max(worst, err)
        check(torch.allclose(k[1], r[1], rtol=1e-5, atol=1e-4), f"chains {name}: ELBO differs")
        check(k[2].shape == (5, CHAINS_C) and torch.allclose(k[2], r[2], rtol=1e-5, atol=1e-4),
              f"chains {name}: trace rows differ")
        check(torch.equal(k[0], ku[0]) and torch.equal(k[1], ku[1]),
              f"chains {name}: traced and untraced launches differ")
        check(torch.equal(one[0], b[0]) and torch.equal(one[1], b[1]),
              f"chains {name}: a 3 + 197 split differs from one launch")
        compare_tensors(f"chains {name}, Philox, 200 steps", list(one[0].flatten(0, 1)),
                        list(ref[0].flatten(0, 1)), 1e-4)
        check(torch.allclose(one[1], ref[1], rtol=1e-4, atol=1e-3),
              f"chains {name}: ELBO after 200 Philox steps differs")
        # chain c is the single-chain kernel keyed by chain c's words
        per = rules if isinstance(rules, list) else [rules] * CHAINS_C
        bitwise, rel1 = True, 0.0
        for c in range(CHAINS_C):
            br = eng.branch()
            branch = FusedBranch(per[c], br.entropy, br.grad_est, br.operator, br.cocob_alpha)
            nrow = 14 if per[c] == "cocob" else 8
            hyp = eng.hyp if eng.lrs is None else type(eng.hyp)(
                lrs[c], *(getattr(eng.hyp, f) for f in ("b1", "b2", "eps", "avg_eta",
                                                         "clip_eps")))
            single, e1, _ = fused_run_chunk_cuda(sp.model, sp.consts, sp.scalars,
                                                 rows[c, :nrow].contiguous(),
                                                 chain_seed_words(SEED, c), warm, 200,
                                                 N_SAMPLES, hyp, branch=branch)
            bitwise &= torch.equal(single, one[0][c, :nrow]) and torch.equal(e1, one[1][c])
            rel1 = max(rel1, compare_tensors(f"chains {name}: chain {c} vs single-chain kernel",
                                             list(one[0][c, :nrow]), list(single), 1e-6))
        say("v", case=name, warm=warm, steps="50,200", parameter_max_abs_err=f"{err:.3e}",
            state_max_rel_err=f"{rel:.3e}", chain_vs_single_rel_err=f"{rel1:.3e}",
            chain_vs_single_bitwise=bitwise, elbo_kernel_chain0=float(k[1][0]),
            elbo_plain_chain0=float(r[1][0]))
    # the divergence channel
    div_lrs = [1e-3] * CHAINS_C
    div_lrs[5] = 1e7
    eng, st = chains_engine(dev, spec, CHAINS_C, lr=div_lrs, optimizer="descent")
    _, trace = eng.run_chunk_traced(st, SEED, 6, log_every=2)
    hit = first_chain_divergence(trace, log_every=2)
    healthy = torch.cat([trace[:, :5], trace[:, 6:]], dim=1)
    say("v", divergence=hit, healthy_finite=bool(torch.isfinite(healthy).all()))
    check(hit is not None and hit[0] == 5, f"first_chain_divergence gave {hit}, not chain 5")
    check(bool(torch.isfinite(healthy).all()), "a healthy chain went non-finite")
    say("v", cases=len(cases), seconds=f"{time.perf_counter() - t0:.2f}")
    return worst


def jittered_run(eng, dev, C, seed):
    """``CHAINS_MAIN_STEPS`` steps of ``C`` jittered chains (locations 0.5
    N(0, 1) from ``seed``, scales 0.1) through ``run_chunk_traced`` in
    5,000-step chunks: (seconds, trace, tail ELBO of each chain)."""
    g = torch.Generator().manual_seed(seed)
    locs = (0.5 * torch.randn(C, eng.dim, generator=g)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.init(locs, 0.1 * torch.ones(C, eng.dim, device=dev))
    traces = []
    for _ in range(CHAINS_MAIN_STEPS // 5_000):
        st, tr = eng.run_chunk_traced(st, SEED, 5_000, log_every=LOG_EVERY)
        traces.append(tr)
    trace = torch.cat(traces)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, trace, trace[-TAIL_ROWS:].mean(dim=0)


def phase_w(dev, card):
    """The chains paths at full width, counted: 64 jittered chains of the
    flagship (locations 0.5 N(0, 1), scales 0.1) for 20,000 steps through
    FusedChainsADVI (every chain finite and above -150 at its tail, bench.py's
    ``converged``), and optimize_chains at C = 4 for 500 steps (chain c equal
    to ``optimize`` keyed by chain_seed_words(seed, c), bit for bit); then
    1,024 jittered chains for 20,000 steps (several chains a block), counted
    apart, with the same checks.  Then 200-step chunks at C in CHAINS_SWEEP
    (CUDA events, aggregate chain-steps/s, the chains a block G beside each)
    and the plain version at C = 64 and 1,024, each held against the other
    on the timed rows (rtol 1e-4 norm-wise after the 200 Philox steps);
    chains 0, G - 1, G and C - 1 of C = 1,024 against the single-chain
    kernel on their seed words, bit for bit; 50 injected-noise steps at
    C = 64 and 1,024 against the plain version (rtol 1e-5); the step's
    phase split at C = 64 and 1,024.  Returns the launch counts of the two
    counted runs, the times at C = 64 and 1,024 and the largest parameter
    error after the injected-noise steps."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import fused_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference,
    )
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words
    from advancedvi_jl_tpu_torch.parallel.chains import optimize_chains

    prob = flagship(dev)
    spec = avt.logreg_spec(prob.X, prob.y)
    d = spec.dim
    eng = avt.FusedChainsADVI(spec, n_chains=CHAINS_MAIN_C, n_samples=N_SAMPLES, lr=LR)
    target = prob.unconstrained()
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                  optimizer=avt.adam(LR), operator=avt.ClipScale())
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    torch.cuda.synchronize()
    reset_launches()
    fused_s, trace, tail = jittered_run(eng, dev, CHAINS_MAIN_C, 7)
    say("w", path="fused_chains", chains=CHAINS_MAIN_C, G=eng.chains_per_block(),
        steps=CHAINS_MAIN_STEPS, seconds=f"{fused_s:.2f}", tail_elbo_min=float(tail.min()),
        tail_elbo_max=float(tail.max()),
        chain_steps_per_s=f"{CHAINS_MAIN_C * CHAINS_MAIN_STEPS / fused_s:.1f}")
    check(bool(torch.isfinite(trace).all()), "a fused chain's ELBO trace is not finite")
    check(bool((tail > -150.0).all()), f"a fused chain's tail ELBO {float(tail.min())} <= -150")
    t0 = time.perf_counter()
    outs, info, states, _ = optimize_chains(SEED, alg, CHAINS_GENERAL_STEPS, target, q0,
                                            n_chains=CHAINS_GENERAL_C)
    torch.cuda.synchronize()
    general_s = time.perf_counter() - t0
    counts = read_launches()
    say("w", path="optimize_chains", chains=CHAINS_GENERAL_C, steps=CHAINS_GENERAL_STEPS,
        seconds=f"{general_s:.2f}",
        chain_steps_per_s=f"{CHAINS_GENERAL_C * CHAINS_GENERAL_STEPS / general_s:.1f}",
        elbo_last=[round(float(e), 3) for e in info["elbo"]],
        fused_chains_launches=counts["fused_chains"],
        sampler_launches=counts["meanfield_sample"])
    check(counts["fused_chains"] > 0, "the fused chains engine launched no kernel")
    check(counts["meanfield_sample"] > 0, "the general chains path launched no sampler kernel")
    for c in range(CHAINS_GENERAL_C):
        _, _, sc = avt.optimize(chain_seed_words(SEED, c), alg, CHAINS_GENERAL_STEPS, target,
                                q0)
        same = (torch.equal(sc.q.location, states.chains[c].q.location)
                and torch.equal(sc.q.scale_diag, states.chains[c].q.scale_diag))
        check(same, f"optimize_chains chain {c} differs from optimize on its seed words")
    say("w", optimize_chains_equals_optimize_bitwise=True)
    # several chains a block: 1,024 jittered chains, counted on their own
    wide = avt.FusedChainsADVI(spec, n_chains=CHAINS_WIDE_C, n_samples=N_SAMPLES, lr=LR)
    G = wide.chains_per_block()
    torch.cuda.synchronize()
    reset_launches()
    wide_s, trace, tail = jittered_run(wide, dev, CHAINS_WIDE_C, 8)
    wide_counts = read_launches()
    say("w", path="fused_chains", chains=CHAINS_WIDE_C, G=G, steps=CHAINS_MAIN_STEPS,
        seconds=f"{wide_s:.2f}", tail_elbo_min=float(tail.min()),
        tail_elbo_max=float(tail.max()), fused_chains_launches=wide_counts["fused_chains"],
        chain_steps_per_s=f"{CHAINS_WIDE_C * CHAINS_MAIN_STEPS / wide_s:.1f}")
    check(G >= 2, f"{CHAINS_WIDE_C} chains took {G} chain a block")
    check(wide_counts["fused_chains"] > 0, "the 1,024-chain run launched no chains kernel")
    check(bool(torch.isfinite(trace).all()), "a wide run's ELBO trace is not finite")
    check(bool((tail > -150.0).all()), f"a wide run's tail ELBO {float(tail.min())} <= -150")
    # times: 200-step chunks over the chain counts, the sweep run up and then
    # down (the card's clocks beside it)
    cases = {C: chains_case(dev, spec, C) for C in CHAINS_SWEEP + (CHAINS_MAIN_C,)}
    times = {C: [] for C in CHAINS_SWEEP}
    say("w", clocks_before=smi_clocks())
    for C in CHAINS_SWEEP + CHAINS_SWEEP[::-1]:
        e, rows, seeds = cases[C]
        times[C].append(cuda_ms(
            lambda: chains_run(fused_chains_run_chunk_cuda, e, rows, seeds, 0, 200), 10))
    say("w", clocks_after=smi_clocks())
    for C in CHAINS_SWEEP:
        ms = min(times[C])
        say("w", card=f"'{card}'", chains=C, G=cases[C][0].chains_per_block(), chunk_steps=200,
            kernel_ms=",".join(f"{t:.4f}" for t in times[C]),
            chain_steps_per_s=f"{C * 200 / (ms / 1e3):.1f}")
    # a mixed rule sweep at the main width: its launches read the rule codes
    # kept on the host, so they follow each other with no host sync
    e, s0 = chains_engine(dev, spec, CHAINS_MAIN_C,
                          optimizer=MIXED_RULES * (CHAINS_MAIN_C // len(MIXED_RULES)))
    rows_m, seeds_m = s0.stacked(with_ext=True), e.chain_seeds(SEED)
    mixed_ms = cuda_ms(lambda: chains_run(fused_chains_run_chunk_cuda, e, rows_m, seeds_m, 0,
                                          200), 10)
    say("w", card=f"'{card}'", chains=CHAINS_MAIN_C, sweep="mixed", chunk_steps=200,
        kernel_ms=mixed_ms)
    kern, plain = fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference
    timed_ms = {}
    for C in (CHAINS_MAIN_C, CHAINS_WIDE_C):
        e, rows, seeds = cases[C]
        out = {}  # the last timed launch of each, compared below

        def timed(fn):
            out[fn] = chains_run(fn, e, rows, seeds, 0, 200)

        k_ms = cuda_ms(lambda: timed(kern), 5)
        p_ms = cuda_ms(lambda: timed(plain), 1)
        timed_ms[C] = (k_ms, p_ms)
        k, r = out[kern], out[plain]
        rel = compare_tensors(f"chains C = {C}, Philox, 200 steps",
                              list(k[0].flatten(0, 1)), list(r[0].flatten(0, 1)), 1e-4)
        check(torch.allclose(k[1], r[1], rtol=1e-4, atol=1e-3),
              f"chains C = {C}: ELBO after 200 Philox steps differs")
        err = max_err(k[0][:, [0, 1, 6, 7]], r[0][:, [0, 1, 6, 7]])
        g = e.chains_per_block()
        bitwise = {}
        for c in sorted({0, g - 1, g, C - 1}):  # chain c: the single-chain kernel's bits
            one, e1, _ = fused_run_chunk_cuda(spec.model, spec.consts, spec.scalars,
                                              rows[c].contiguous(), chain_seed_words(SEED, c),
                                              0, 200, N_SAMPLES, e.hyp)
            bitwise[c] = bool(torch.equal(one, k[0][c]) and torch.equal(e1, k[1][c]))
        say("w", card=f"'{card}'", chains=C, G=g, kernel_ms=k_ms, plain_ms=p_ms,
            philox_200_state_max_rel_err=f"{rel:.3e}",
            philox_200_parameter_max_abs_err=f"{err:.3e}",
            chain_vs_single_bitwise=",".join(f"{c}:{b}" for c, b in bitwise.items()))
        check(all(bitwise.values()), f"chains C = {C}: a chain differs from the single-chain "
              f"kernel on its words ({bitwise})")
        chains_split("w", f"C{C}", e, rows, seeds, min(times[C]) if C in times else k_ms)
    worst = 0.0
    for C in (CHAINS_MAIN_C, CHAINS_WIDE_C):
        e, rows, seeds = cases[C]
        gen = torch.Generator(device=dev).manual_seed(5)
        noise = torch.randn((50, C, N_SAMPLES, d), generator=gen, device=dev)
        k = chains_run(kern, e, rows, seeds, 0, 50, noise)
        r = chains_run(plain, e, rows, seeds, 0, 50, noise)
        torch.cuda.synchronize()
        rel = compare_tensors(f"chains C = {C}, injected noise", list(k[0].flatten(0, 1)),
                              list(r[0].flatten(0, 1)), 1e-5)
        err = max_err(k[0][:, [0, 1, 6, 7]], r[0][:, [0, 1, 6, 7]])
        check(torch.allclose(k[1], r[1], rtol=1e-5, atol=1e-4),
              f"chains C = {C}: ELBO after the injected-noise steps differs")
        say("w", chains=C, G=e.chains_per_block(), steps=50, noise="injected",
            parameter_max_abs_err=f"{err:.3e}", state_max_rel_err=f"{rel:.3e}")
        worst = max(worst, err)
    return counts, wide_counts, timed_ms, worst


SM_ISSUE = 4  # warp-instructions an SM issues a clock: four schedulers, one each


def sass_instructions(text: str) -> list:
    """(address, predicate, opcode, branch target) of each SASS instruction."""
    import re

    out = []
    for ln in text.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if not m:
            continue
        body, pred = m.group(2).strip(), None
        if body.startswith("@"):
            pred, body = body.split(None, 1)
        op = body.split()[0]
        t = re.search(r"0x([0-9a-f]+)$", body) if op.startswith("BRA") else None
        out.append((int(m.group(1), 16), pred, op, int(t.group(1), 16) if t else None))
    return out


def fast_path(ins) -> int:
    """Instructions on the shortest path from a kernel's entry to an EXIT:
    the path a thread takes when no slow path runs (cosf's Payne-Hanek
    reduction, sqrtf's special cases), found breadth-first."""
    from collections import deque

    index = {a: k for k, (a, *_) in enumerate(ins)}
    dist, todo = {0: 1}, deque([0])
    while todo:
        k = todo.popleft()
        _, pred, op, t = ins[k]
        always = pred in (None, "@PT")
        if op == "EXIT" and always:
            return dist[k]
        ends = always and (op.startswith("BRA") or op == "RET")
        for j in ([] if ends else [k + 1]) + ([index[t]] if t in index else []):
            if j < len(ins) and j not in dist:
                dist[j] = dist[k] + 1
                todo.append(j)
    fail("no path to an EXIT in the generator probe's SASS")


# One lane group of csrc/philox.cuh's draws a thread (two Philox4x32-10
# blocks, four Box-Mullers with accurate logf, cosf and sqrtf), and the same
# kernel storing its inputs instead: the difference of their fast paths is
# what one lane group of draws costs.
GENERATOR_PROBE = r"""
#include "philox.cuh"
extern "C" __global__ void draw_group(float4* out, uint32_t k0, uint32_t k1, uint32_t it) {
  float w[4];
  avi::normals4(k0, k1, it, blockIdx.x, threadIdx.x, w);
  out[blockIdx.x * blockDim.x + threadIdx.x] = make_float4(w[0], w[1], w[2], w[3]);
}
extern "C" __global__ void store_group(float4* out, uint32_t k0, uint32_t k1, uint32_t it) {
  out[blockIdx.x * blockDim.x + threadIdx.x] = make_float4(
      __uint_as_float(k0), __uint_as_float(k1), __uint_as_float(it),
      __uint_as_float(threadIdx.x));
}
"""


def generator_instructions(card) -> dict:
    """Thread instructions each sampler's function needs at its timed shape,
    and the time they take at the issue rate: SMs x SM_ISSUE
    warp-instructions a clock at the card's largest SM clock.  A lane group
    of four normals costs the fast path of ``GENERATOR_PROBE``'s draw
    (compiled with the kernels' flags, counted by ``cuobjdump -sass``);
    the function draws n ceil(d / 4) groups (K7c: u1's and u2's, n
    ceil(r / 4)) whatever a kernel redraws, and adds one instruction a
    multiply-add (z = u s + m; K7b's triangle product, K7c's r terms).
    Returns {name: issue_ms}."""
    import tempfile

    from advancedvi_jl_tpu_torch.ops.cuda import _build

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=120).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        src, cubin = Path(tmp) / "generator_probe.cu", Path(tmp) / "generator_probe.cubin"
        src.write_text(GENERATOR_PROBE)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([_build.nvcc(), *flags, "-cubin", "-I", str(_build.CSRC), "-o",
                        str(cubin), str(src)], capture_output=True, text=True, timeout=300,
                       check=True)
        paths = {name: fast_path(sass_instructions(text))
                 for name, text in sass_functions(cubin).items()}
    group = paths["draw_group"] - paths["store_group"]
    n, d = N_SAMPLES, N_FEATURES + 2
    k7a = n * -(-d // 4) * group + n * d
    n, d = FR_SHAPE
    k7b = n * -(-d // 4) * group + n * d * (d + 1) // 2 + n * d
    n, d = FR_WIDE_SHAPE
    k7b_wide = n * -(-d // 4) * group + n * d * (d + 1) // 2 + n * d
    n, d, r = LR_SHAPE
    k7c = n * (-(-d // 4) + -(-r // 4)) * group + n * d * r + n * d
    out = {}
    for name, shape, instr in (("meanfield_sample", f"{N_SAMPLES}x{N_FEATURES + 2}", k7a),
                               ("fullrank_sample", f"{FR_SHAPE[0]}x{FR_SHAPE[1]}", k7b),
                               ("fullrank_sample_wide", "x".join(map(str, FR_WIDE_SHAPE)),
                                k7b_wide),
                               ("lowrank_sample", "x".join(map(str, LR_SHAPE)), k7c)):
        out[name] = instr / 32 / (sms * SM_ISSUE * mhz * 1e6) * 1e3
        say("x", card=f"'{card}'", instructions=name, shape=shape, lane_group=group,
            probe_draw=paths["draw_group"], probe_store=paths["store_group"],
            thread_instructions=f"{instr:.4g}", sm_clock_mhz=mhz, sms=sms,
            issue_ms=f"{out[name]:.4g}")
    return out


def lowrank_flops_bytes(n, d, r):
    """Operations and bytes of one low-rank draw: r multiply-adds and one
    multiply-add (u1 D + m) an element; loc, D and U read, z, u1 and u2
    written."""
    return 2.0 * n * d * (r + 1), 4.0 * (2 * d + d * r + 2 * n * d + n * r)


def phase_x(dev, card):
    """K7c against its plain version at the sampler shape and at the two
    low-rank ADVI runs' shapes (u1 equal to K7a's u and to the plain
    version's, u2 bit-exact, z within 1e-6 norm-wise), timed at the sampler
    shape with its bound; then low-rank ADVI through ``optimize``, counted:
    tests/test_lowrank_advi.py's convergence case (d = 12, r = 2) and the
    flagship logreg with a rank-8 family."""
    import numpy as np

    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.models.normal import NormalTarget
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        lowrank_sample_cuda, lowrank_sample_reference, meanfield_sample_cuda, seed_words,
    )

    seed = seed_words(SEED)
    err = 0.0
    # the sampler shape, then the shapes of the two low-rank ADVI runs below
    # (d = 62 takes the scalar store path, d % 4 != 0)
    for n, d, r in (LR_SHAPE, (N_SAMPLES, N_FEATURES + 2, LR_FLAGSHIP_R), (32, LR_D, LR_R)):
        g = torch.Generator().manual_seed(3)
        loc = torch.randn(d, generator=g).to(dev)
        D = (0.5 + torch.rand(d, generator=g)).to(dev)
        U = (0.3 * torch.randn(d, r, generator=g)).to(dev)
        z, u1, u2 = lowrank_sample_cuda(seed, 5, loc, D, U, n)
        zr, u1r, u2r = lowrank_sample_reference(seed, 5, loc, D, U, n)
        _, um = meanfield_sample_cuda(seed, 5, loc, D, n)
        torch.cuda.synchronize()
        rel = rel_err(z, zr)
        err = max(err, max_err(z, zr))
        say("x", shape=f"{n}x{d}x{r}", u1_bitwise_plain=bool(torch.equal(u1, u1r)),
            u1_bitwise_meanfield=bool(torch.equal(u1, um)),
            u2_bitwise_plain=bool(torch.equal(u2, u2r)), z_rel_err=rel,
            z_max_abs_err=max_err(z, zr))
        check(torch.equal(u1, u1r) and torch.equal(u2, u2r),
              f"low-rank draws at {n}x{d}x{r} differ from the plain version")
        check(torch.equal(u1, um), f"low-rank u1 at {n}x{d}x{r} differs from the mean-field u")
        check(rel <= 1e-6, f"low-rank sampler z at {n}x{d}x{r}: norm-wise error {rel} > 1e-6")
    n, d, r = LR_SHAPE
    g = torch.Generator().manual_seed(3)
    loc = torch.randn(d, generator=g).to(dev)
    D = (0.5 + torch.rand(d, generator=g)).to(dev)
    U = (0.3 * torch.randn(d, r, generator=g)).to(dev)
    k_ms = cuda_ms(lambda: lowrank_sample_cuda(seed, 5, loc, D, U, n), 20)
    p_ms = cuda_ms(lambda: lowrank_sample_reference(seed, 5, loc, D, U, n), 2)
    k_ms2 = cuda_ms(lambda: lowrank_sample_cuda(seed, 5, loc, D, U, n), 20)
    issue = generator_instructions(card)
    b_ms, b_by = bound(*lowrank_flops_bytes(n, d, r), issue["lowrank_sample"])
    say("x", card=f"'{card}'", lowrank_sample_ms=f"{k_ms},{k_ms2}", plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by,
        bytes_ms=f"{lowrank_flops_bytes(n, d, r)[1] / HBM_BYTES * 1e3:.5f}",
        share=f"{b_ms / min(k_ms, k_ms2):.3f}")
    # low-rank ADVI on the general path, counted
    rng = np.random.default_rng(21)
    Dv = 0.6 + 0.4 * rng.uniform(0, 1, LR_D)
    Uv = 0.5 * rng.normal(0, 1, (LR_D, LR_R))
    cov = np.diag(Dv ** 2) + Uv @ Uv.T
    mu = rng.normal(0, 1, LR_D)
    target = NormalTarget(mu=torch.tensor(mu, dtype=torch.float32, device=dev),
                          scale_tril=torch.tensor(np.linalg.cholesky(cov), dtype=torch.float32,
                                                  device=dev))
    q0 = avt.LowRankGaussian(torch.zeros(LR_D, device=dev), torch.ones(LR_D, device=dev),
                             0.1 * torch.ones(LR_D, LR_R, device=dev))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=32, optimizer=avt.adam(2e-2),
                                  operator=avt.ClipScale())
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, _, _ = avt.optimize(SEED, alg, LR_STEPS, target, q0, log_every=100)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nelbo = float(avt.estimate_objective(SEED + 5, alg, out, target, n_samples=20_000))
    mean_err = float(np.abs(out.mean().cpu().numpy() - mu).max())
    cov_err = float(np.abs(out.cov().cpu().numpy() - cov).max())
    say("x", path="lowrank_advi", d=LR_D, r=LR_R, steps=LR_STEPS, mean_max_abs_err=mean_err,
        cov_max_abs_err=cov_err, neg_elbo=nelbo, steps_per_s=f"{LR_STEPS / secs:.1f}")
    check(mean_err < 0.1 and cov_err < 0.15 and abs(nelbo) < 0.1,
          f"low-rank ADVI: mean {mean_err}, cov {cov_err}, -ELBO {nelbo}")
    prob = flagship(dev)
    qf = avt.LowRankGaussian(torch.zeros(prob.dim, device=dev),
                             0.1 * torch.ones(prob.dim, device=dev),
                             torch.zeros(prob.dim, LR_FLAGSHIP_R, device=dev))
    falg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES, optimizer=avt.adam(LR),
                                   operator=avt.ClipScale())
    t0 = time.perf_counter()
    _, infos, _ = avt.optimize(SEED, falg, LR_FLAGSHIP_STEPS, prob.unconstrained(), qf,
                               log_every=LOG_EVERY)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_launches()
    say("x", path="lowrank_flagship", d=prob.dim, r=LR_FLAGSHIP_R, steps=LR_FLAGSHIP_STEPS,
        elbo_last=infos[-1]["elbo"], steps_per_s=f"{LR_FLAGSHIP_STEPS / secs:.1f}",
        lowrank_sample_launches=counts["lowrank_sample"])
    check(all(math.isfinite(row["elbo"]) for row in infos), "low-rank flagship ELBO not finite")
    check(counts["lowrank_sample"] > 0, "low-rank ADVI launched no low-rank sampler kernel")
    return counts, err, (min(k_ms, k_ms2), p_ms, b_ms, b_by), issue


def kernel_bounds():
    """(flops, bytes) of each timed launch of the earlier slices, from the
    shapes this run times them at: each input read once, each output written
    once; flops count the float multiply-adds (2 each); the samplers' Philox
    and Box-Muller instructions enter their bounds apart
    (``generator_instructions``).  The logreg design: 208 x 61."""
    n, db, d = N_SAMPLES, N_FEATURES + 1, N_FEATURES + 2
    logreg = n * N_DATA * db  # multiply-adds of one (n, 208, 61) product
    x_bytes = 4 * (N_DATA * db + N_DATA)
    fr_n, fr_d = FR_SHAPE
    tri = fr_n * fr_d * (fr_d + 1) // 2  # multiply-adds of a (n, d) x triangle
    dg = NLN_DIMS + 1
    # full-rank prox on normal-lognormal: z and dC, no whitening
    nln = (2.0 * 200 * (2 * n * dg * (dg + 1) // 2 + n * dg),
           4.0 * (2 * dg + 8 * dg + 8 * dg * dg))
    return {
        "meanfield_sample": (2.0 * n * d, 4.0 * (2 * d + 2 * n * d)),
        "fused_advi_meanfield": (2.0 * 200 * 2 * logreg, x_bytes + 4.0 * 16 * d),
        "fullrank_sample": (2.0 * tri, 4.0 * (fr_d * (fr_d + 1) // 2 + fr_d + 2 * fr_n * fr_d)),
        "trisolve": (2.0 * tri, 4.0 * (fr_d * (fr_d + 1) // 2 + 2 * fr_n * fr_d)),
        # the single-block kernel at its counted path's shape, (p)'s
        "fused_advi_fullrank": nln,
        "fused_k3_rules": (2.0 * 200 * 2 * logreg, x_bytes + 4.0 * 16 * d),
        "fused_k3_vargrad": (2.0 * 200 * logreg, x_bytes + 4.0 * 16 * d),
        "fused_k4_gaussian": nln,
        # CHAINS_MAIN_C and CHAINS_WIDE_C chains of the flagship step: the
        # design read once, each chain's state in and out
        "fused_chains": (2.0 * 200 * CHAINS_MAIN_C * 2 * logreg,
                         x_bytes + 4.0 * CHAINS_MAIN_C * 16 * d),
        "fused_chains_g": (2.0 * 200 * CHAINS_WIDE_C * 2 * logreg,
                           x_bytes + 4.0 * CHAINS_WIDE_C * 16 * d),
    }


# ---------------------------------------------------------------------------
# K5: the AD-derived model body
# ---------------------------------------------------------------------------

AD_CHAINS_C = 64
AD_MAIN_STEPS = 20_000    # the flagship through ad_spec, as phase (g)
AD_SIDE_STEPS = 2_000     # the full-rank, proximal and score-gradient engines on it
RNG_DRAWS, RNG_D, RNG_R = 65_536, 64, 8       # _rng_validation.py:92-122
SPREAD_CHAINS, SPREAD_STEPS = 64, 120_000     # _rng_validation.py:301-317


def quartic_spec(dev):
    """tests/test_fused_ad_spec.py:156's anisotropic quartic well (d = 5)
    through ``FusedModelSpec.from_log_density``: no hand spec exists."""
    import advancedvi_jl_tpu_torch as avt

    d = 5
    data = {"anchor": torch.linspace(-1.0, 1.0, d, device=dev),
            "w": torch.arange(1.0, d + 1.0, device=dev)}

    def logp(theta, dat):
        r = theta - dat["anchor"]
        return -(r * r * dat["w"]).sum(-1) - 0.1 * (r ** 4).sum(-1)

    return avt.FusedModelSpec.from_log_density(logp, d, data=data)


def ad_cases(dev):
    """Phase (y)'s ad specs: the flagship logreg, normal-lognormal, quartic."""
    import advancedvi_jl_tpu_torch as avt

    return {"logreg": avt.ad_spec(flagship(dev).unconstrained()),
            "nln": avt.ad_spec(nln_target(dev)[0].unconstrained()),
            "quartic": quartic_spec(dev)}


def ad_build(dev, cases):
    """Every generated library phase (y) runs, one nvcc each, all started
    together: each K5 program's loops, barriers, block products and whether
    its constants are staged in shared memory (per family: the engines'
    ad_program), nvcc seconds, registers and spills; the Python layout of
    each kernel's shared memory equal to the kernel's own.  Returns each
    target's program per family."""
    import ctypes

    from advancedvi_jl_tpu_torch.ops.cuda import _build
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import _fullrank_extras, ad_program, \
        ad_smem_bytes

    progs = {name: {"meanfield": ad_program(spec, N_SAMPLES, "meanfield", 8),
                    "fullrank": ad_program(spec, N_SAMPLES, "fullrank", 4)}
             for name, spec in cases.items()}
    kernels = (("fused_advi_meanfield", "meanfield", 8), ("fused_chains", "meanfield", 8),
               ("fused_advi_fullrank", "fullrank", 4))
    t0 = time.perf_counter()
    paths = _build.build_generated_all([(k, progs[name][fam].source) for name in progs
                                        for k, fam, _ in kernels])
    say("y", libraries=len(paths), build_s=f"{time.perf_counter() - t0:.2f}")
    for name, by_family in progs.items():
        for family, prog in by_family.items():
            say("y", target=name, family=family, d=prog.d, graph_nodes=len(prog.gm.graph.nodes),
                loops=prog.loops, barriers=prog.barriers, block_products=prog.products,
                scratch_floats=prog.scratch, madds=prog.madds, staged=prog.staged,
                staged_floats=prog.stage)
        for kern, family, rows in kernels:
            prog = by_family[family]
            path = paths[(kern, prog.source)]
            ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            say("y", target=name, kernel=kern, lib=path.name,
                nvcc_s=f"{_build.BUILD_SECONDS.get(path, 0.0):.2f}")
            for ln in ptxas:
                print(f"    {ln}", flush=True)
            per_block = (1,) if kern == "fused_chains" else ()  # K5 runs one chain a block
            got = _build.function(kern, f"{kern}_smem_bytes", [ctypes.c_int] * (7 + len(per_block)),
                                  restype=ctypes.c_size_t, body=prog.source)(
                6, 0, 0, 0, N_SAMPLES, prog.d, rows, *per_block)
            want = ad_smem_bytes(family, N_SAMPLES, prog.d, prog.scratch, rows, prog.stage)
            if family == "fullrank":  # the scale matrices, then the panel operators, where they fit
                want += _fullrank_extras(want, rows, prog.d)
            check(got == want, f"{kern} on {name}: the kernel's layout is {got} bytes, "
                               f"ad_smem_bytes says {want}")
    return progs


def ad_rows(d, dev, family):
    """The initial state of phase (y)'s comparisons: location 0, scale 0.1."""
    if family == "meanfield":
        return (initial_rows(d, dev),)
    z, eye = torch.zeros(d, device=dev), 0.1 * torch.eye(d, device=dev)
    zz = torch.zeros(d, d, device=dev)
    return torch.stack([z, z, z, z]), torch.stack([eye, zz, zz, eye])


def ad_compare(dev, name, spec, progs, family):
    """K5 in one kernel against its plain version: 50 injected-noise steps
    (norm-wise rtol 1e-5) and 200 Philox steps (1e-4).  Returns the largest
    parameter error after the injected-noise steps."""
    from advancedvi_jl_tpu_torch.ops.cuda import fused_advi as fa
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    d, hyp, seed = spec.dim, fa.FusedHyper(lr=LR), seed_words(SEED)
    prog = progs[family]
    rows = ad_rows(d, dev, family)
    kern, plain = ((fa.fused_run_chunk_cuda, fa.fused_run_chunk_reference) if family == "meanfield"
                   else (fa.fused_fullrank_run_chunk_cuda, fa.fused_fullrank_run_chunk_reference))
    nr = len(rows)
    noise = torch.randn((50, N_SAMPLES, d), generator=torch.Generator().manual_seed(5)).to(dev)
    err = 0.0
    for steps, nz, rtol in ((50, noise, 1e-5), (200, None, 1e-4)):
        args = ("ad", prog.consts, (), *rows, seed, 0, steps, N_SAMPLES, hyp, nz)
        k = kern(*args, ad=prog)
        r = plain(*args, ad=prog)
        torch.cuda.synchronize()
        rel = compare_tensors(f"K5 {name} {family}, {steps} steps", state_tensors(k, nr),
                              state_tensors(r, nr), rtol)
        check(torch.allclose(k[nr], r[nr], rtol=rtol, atol=10 * rtol),
              f"K5 {name} {family}: ELBO {float(k[nr])} vs {float(r[nr])}")
        if steps == 50:
            err = parameter_err([(k[0],) if nr == 1 else k[:2], (r[0],) if nr == 1 else r[:2]],
                                nr)
        say("y", target=name, family=family, steps=steps, noise="injected" if nz is not None
            else "philox", state_max_rel_err=f"{rel:.3e}", elbo_kernel=float(k[nr]),
            elbo_plain=float(r[nr]))
    return err


def ad_chains_compare(dev, spec, prog):
    """K5 in the chains kernel at C = 64 against its plain version: 50
    injected-noise steps (1e-5) and 200 Philox steps (1e-4)."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference,
    )

    eng, st = chains_engine(dev, spec, AD_CHAINS_C, lr=LR)
    rows, seeds = st.stacked(), eng.chain_seeds(SEED)
    gen = torch.Generator(device=dev).manual_seed(5)
    noise = torch.randn((50, AD_CHAINS_C, N_SAMPLES, spec.dim), generator=gen, device=dev)
    err = 0.0
    for steps, nz, rtol in ((50, noise, 1e-5), (200, None, 1e-4)):
        k = chains_run(fused_chains_run_chunk_cuda, eng, rows, seeds, 0, steps, nz)
        r = chains_run(fused_chains_run_chunk_reference, eng, rows, seeds, 0, steps, nz)
        torch.cuda.synchronize()
        rel = compare_tensors(f"K5 chains C = {AD_CHAINS_C}, {steps} steps",
                              list(k[0].flatten(0, 1)), list(r[0].flatten(0, 1)), rtol)
        check(torch.allclose(k[1], r[1], rtol=rtol, atol=10 * rtol), "K5 chains: ELBO differs")
        if steps == 50:
            err = max_err(k[0][:, [0, 1, 6, 7]], r[0][:, [0, 1, 6, 7]])
        say("y", target="logreg", family="chains", chains=AD_CHAINS_C, steps=steps,
            state_max_rel_err=f"{rel:.3e}")
    return err


def ad_vs_hand(dev, progs):
    """The ad logreg chunk against the hand logreg_spec chunk on one injected
    noise, 50 steps, both families: norm-wise within 1e-6 (the two bodies
    sum the same terms in another order)."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda import fused_advi as fa
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import seed_words

    prob = flagship(dev)
    hand = avt.logreg_spec(prob.X, prob.y)
    d, hyp, seed = hand.dim, fa.FusedHyper(lr=LR), seed_words(SEED)
    noise = torch.randn((50, N_SAMPLES, d), generator=torch.Generator().manual_seed(6)).to(dev)
    for family in ("meanfield", "fullrank"):
        ad = progs[family]
        rows = ad_rows(d, dev, family)
        kern = fa.fused_run_chunk_cuda if family == "meanfield" else fa.fused_fullrank_run_chunk_cuda
        k = kern("ad", ad.consts, (), *rows, seed, 0, 50, N_SAMPLES, hyp, noise, ad=ad)
        h = kern("logreg", hand.consts, hand.scalars, *rows, seed, 0, 50, N_SAMPLES, hyp, noise)
        torch.cuda.synchronize()
        nr = len(rows)
        rel = compare_tensors(f"K5 vs the hand logreg body, {family}", state_tensors(k, nr),
                              state_tensors(h, nr), 1e-6)
        say("y", ad_vs_hand=family, steps=50, state_max_rel_err=f"{rel:.3e}",
            elbo_ad=float(k[nr]), elbo_hand=float(h[nr]))


def ad_main_path(dev):
    """The slice's path, counted: the flagship logreg as a plain function
    (no hand spec) through fused_spec_for -> ad_spec, then FusedADVI.optimize
    mean-field for 20,000 steps (converged, and within 2.0 of the hand
    engine's tail on the same key), the full-rank, proximal and
    score-gradient engines for 2,000 steps, and 64 chains for 20,000."""
    import advancedvi_jl_tpu_torch as avt

    prob = flagship(dev)
    target = prob.unconstrained()
    d = prob.dim
    fn = avt.fn_target(lambda theta, _: target.log_density(theta), d)
    q0 = avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))
    qf = avt.FullRankGaussian(torch.zeros(d, device=dev), 0.1 * torch.eye(d, device=dev))
    hand = avt.FusedLogRegADVI(prob.X, prob.y, n_samples=N_SAMPLES, lr=LR)
    _, infos_h, _ = hand.optimize(SEED, AD_MAIN_STEPS, q0, log_every=LOG_EVERY)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    spec = avt.fused_spec_for(fn)
    check(spec.model == "ad", f"fused_spec_for(fn_target) gave {spec.model!r}, not 'ad'")
    eng = avt.FusedADVI(spec, n_samples=N_SAMPLES, lr=LR)
    _, infos, _ = eng.optimize(SEED, AD_MAIN_STEPS, q0, log_every=LOG_EVERY)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tail, tail_h = tail_elbo(infos), tail_elbo(infos_h)
    say("y", path="fused_spec_for(fn_target) -> FusedADVI", steps=AD_MAIN_STEPS,
        elbo_tail_mean=tail, hand_elbo_tail_mean=tail_h, seconds=f"{secs:.2f}")
    check(all(math.isfinite(r["elbo"]) for r in infos), "the ad engine's ELBO is not finite")
    check(tail > -150.0, f"the ad engine's tail ELBO {tail} <= -150 (not converged)")
    check(abs(tail - tail_h) <= 2.0, f"ad {tail} vs hand {tail_h}: over 2.0 apart")
    side = {
        "fullrank": (avt.FusedADVI(spec, family="fullrank", n_samples=N_SAMPLES, lr=LR), qf),
        "prox": (avt.FusedProxADVI(spec, n_samples=N_SAMPLES), q0),
        "scoregrad": (avt.FusedScoreGradVI(spec, n_samples=N_SAMPLES, operator="clip"), q0),
    }
    for name, (e, q) in side.items():
        _, rows, _ = e.optimize(SEED, AD_SIDE_STEPS, q, log_every=LOG_EVERY)
        torch.cuda.synchronize()
        say("y", path=f"ad {name}", steps=AD_SIDE_STEPS, elbo_last=rows[-1]["elbo"])
        check(all(math.isfinite(r["elbo"]) for r in rows), f"ad {name}: ELBO not finite")
    ceng = avt.FusedChainsADVI(spec, n_chains=AD_CHAINS_C, n_samples=N_SAMPLES, lr=LR)
    g = torch.Generator().manual_seed(7)
    st = ceng.init((0.5 * torch.randn(AD_CHAINS_C, d, generator=g)).to(dev),
                   0.1 * torch.ones(AD_CHAINS_C, d, device=dev))
    traces = []
    for _ in range(AD_MAIN_STEPS // 5_000):
        st, tr = ceng.run_chunk_traced(st, SEED, 5_000, log_every=LOG_EVERY)
        traces.append(tr)
    trace = torch.cat(traces)
    torch.cuda.synchronize()
    ctail = trace[-TAIL_ROWS:].mean(dim=0)
    counts = read_launches()
    say("y", path="ad FusedChainsADVI", chains=AD_CHAINS_C, steps=AD_MAIN_STEPS,
        tail_elbo_min=float(ctail.min()), tail_elbo_max=float(ctail.max()),
        k5_launches=counts["k5_ad"], meanfield_launches=counts["fused_advi_meanfield"],
        fullrank_launches=counts["fused_advi_fullrank"], chains_launches=counts["fused_chains"])
    check(bool(torch.isfinite(trace).all()) and bool((ctail > -150.0).all()),
          f"an ad chain's tail ELBO {float(ctail.min())} <= -150 or not finite")
    for kern in ("fused_advi_meanfield", "fused_advi_fullrank", "fused_chains"):
        check(counts[kern] > 0, f"the ad path launched no {kern} kernel")
    check(counts["k5_ad"] > 0, "the ad path launched no K5 body")
    return counts, eng.ad


def ad_times(dev, card, progs):
    """The 200-step ad chunk (mean-field, flagship) beside the hand chunk of
    phase (h), in turns, and its plain version; the full-rank and 64-chain ad
    chunks; the ad chunk's mean-field phase split."""
    from advancedvi_jl_tpu_torch.ops.cuda import fused_advi as fa
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import fused_chains_run_chunk_cuda

    prog = progs["meanfield"]
    hand_args = flagship_chunk_args(dev)
    ad_args = ("ad", prog.consts, ()) + hand_args[3:]
    say("y", clocks_before=smi_clocks())
    ad_ms, hand_ms = [], []
    for _ in range(2):
        hand_ms.append(cuda_ms(lambda: fa.fused_run_chunk_cuda(*hand_args), 20))
        ad_ms.append(cuda_ms(lambda: fa.fused_run_chunk_cuda(*ad_args, ad=prog), 20))
    plain_ms = cuda_ms(lambda: fa.fused_run_chunk_reference(*ad_args, ad=prog), 1)
    d = prog.d
    vec, mat = ad_rows(d, dev, "fullrank")
    fr = progs["fullrank"]
    fr_ms = cuda_ms(lambda: fa.fused_fullrank_run_chunk_cuda(
        "ad", fr.consts, (), vec, mat, *hand_args[4:], ad=fr), 10)
    import advancedvi_jl_tpu_torch as avt

    spec = avt.ad_spec(flagship(dev).unconstrained())
    eng, st = chains_engine(dev, spec, AD_CHAINS_C, lr=LR)
    rows, seeds = st.stacked(), eng.chain_seeds(SEED)
    ch_ms = cuda_ms(lambda: chains_run(fused_chains_run_chunk_cuda, eng, rows, seeds, 0, 200), 5)
    say("y", clocks_after=smi_clocks())
    say("y", card=f"'{card}'", chunk_steps=200, ad_chunk_ms=",".join(f"{t:.4f}" for t in ad_ms),
        hand_chunk_ms=",".join(f"{t:.4f}" for t in hand_ms), ad_plain_ms=plain_ms,
        ratio=f"{min(ad_ms) / min(hand_ms):.3f}", fullrank_ad_chunk_ms=fr_ms,
        chains64_ad_chunk_ms=ch_ms)
    mf_split("y", "flagship_ad", ad_args, min(ad_ms), ad=prog)
    return min(ad_ms), plain_ms


def rng_checks(dev):
    """The RNG checks of _rng_validation.py the port still owed: K7c's u2
    moments (5 sigma); the sample mean and covariance of K7b's and K7c's z
    at 65,536 draws against each family's exact covariance (6 standard
    errors); 64 chains of the flagship agreeing on its optimum, the largest
    per-dimension spread of their averaged locations under 0.02 after
    120,000 steps."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        fullrank_sample_cuda, lowrank_sample_cuda, normal_moments_ok, seed_words,
    )

    n, d, r = RNG_DRAWS, RNG_D, RNG_R
    g = torch.Generator().manual_seed(42)
    loc = torch.linspace(-1.0, 1.0, d).to(dev)
    sd = torch.linspace(0.5, 2.0, d).to(dev)
    C = (0.3 * torch.eye(d) + 0.1 * torch.tril(torch.randn(d, d, generator=g), -1)).to(dev)
    U = (0.2 * torch.randn(d, r, generator=g)).to(dev)
    z_fr, _ = fullrank_sample_cuda(seed_words(43), 0, loc, C, n)
    z_lr, _, u2 = lowrank_sample_cuda(seed_words(44), 0, loc, sd, U, n)
    torch.cuda.synchronize()
    check(normal_moments_ok(u2), "K7c's u2 moments outside 5 sigma")
    u2d = u2.double()
    kurt = float(((u2d - u2d.mean()) ** 4).mean() / u2d.var() ** 2)
    check(abs(kurt - 3.0) < 6 * math.sqrt(24.0 / u2.numel()), f"K7c's u2 kurtosis {kurt}")
    Cd, Ud = C.double(), U.double()
    for tag, z, cov in (("fullrank", z_fr, Cd @ Cd.T),
                        ("lowrank", z_lr, torch.diag(sd.double() ** 2) + Ud @ Ud.T)):
        zd = z.double()
        s = torch.sqrt(torch.diagonal(cov))
        merr = float(((zd.mean(0) - loc.double()).abs() / (s / math.sqrt(n))).max())
        cerr = float(((torch.cov(zd.T) - cov).abs() / torch.outer(s, s)).max())
        band = 6 * math.sqrt(2.0 / n)
        say("y", rng=tag, draws=n, d=d, mean_max_err_se=f"{merr:.3f}", cov_max_rel_err=
            f"{cerr:.5f}", cov_band=f"{band:.5f}")
        check(merr < 6.0 and cerr < band, f"{tag} sampler: mean {merr} se, cov {cerr} > {band}")
    say("y", rng="lowrank_u2", mean=float(u2d.mean()), var=float(u2d.var()), kurtosis=kurt)
    prob = flagship(dev)
    eng = avt.FusedChainsADVI(avt.logreg_spec(prob.X, prob.y), n_chains=SPREAD_CHAINS,
                              n_samples=N_SAMPLES, lr=LR)
    st = eng.init((0.5 * torch.randn(SPREAD_CHAINS, prob.dim,
                                     generator=torch.Generator().manual_seed(2))).to(dev),
                  0.1 * torch.ones(SPREAD_CHAINS, prob.dim, device=dev))
    for _ in range(SPREAD_STEPS // 30_000):
        st = eng.run_chunk(st, SEED, 30_000)
    spread = float(eng.q(st).location.std(dim=0).max())
    say("y", rng="chains", chains=SPREAD_CHAINS, steps=SPREAD_STEPS,
        elbo_min=float(st.elbo.min()), elbo_max=float(st.elbo.max()), loc_spread_max=spread)
    check(spread < 0.02, f"64 chains' averaged locations spread {spread} >= 0.02")


def phase_y(dev, card):
    """K5: build, hold against the plain version and the hand body, the
    counted main path, the times; then the RNG checks."""
    cases = ad_cases(dev)
    progs = ad_build(dev, cases)
    err = 0.0
    for name, spec in cases.items():
        for family in ("meanfield", "fullrank"):
            err = max(err, ad_compare(dev, name, spec, progs[name], family))
    err = max(err, ad_chains_compare(dev, cases["logreg"], progs["logreg"]["meanfield"]))
    ad_vs_hand(dev, progs["logreg"])
    counts, prog = ad_main_path(dev)
    check(prog.digest == progs["logreg"]["meanfield"].digest,
          "fused_spec_for(fn_target) and ad_spec of the flagship emitted different bodies")
    ms, plain_ms = ad_times(dev, card, progs["logreg"])
    rng_checks(dev)
    # the flagship chunk's work: its two products, n x 208 x 61 each, a step;
    # the design, labels and state in and out
    flops = 2.0 * 200 * prog.madds
    nbytes = 4.0 * (prog.consts[0].numel() + 16 * prog.d)
    return counts["k5_ad"], err, ms, plain_ms, bound(flops, nbytes)


# ---------------------------------------------------------------------------
# The measure-space slice: K7b at its shapes, the measure-space algorithms,
# the stop channel and Pathfinder
# ---------------------------------------------------------------------------

MS_PATHS, MS_PATH_DRAWS = 8, 1_000   # multi-path Pathfinder on the flagship
MS_EVAL_SAMPLES = 20_000             # the warm-start check's ELBOs
# the algorithms' draws, then Pathfinder's pooled draws a path and the ELBOs
MS_SAMPLE_SHAPES = [(n, d) for n in (16, 32, 64) for d in (62, 256, 512)] + [
    ((2 * MS_PATH_DRAWS) // MS_PATHS, N_FEATURES + 2), (MS_EVAL_SAMPLES, N_FEATURES + 2)]
MS_STEPS = 2_000         # tests/test_cross_algorithm.py's NGD run on the logreg
MS_LOG_EVERY = 10        # the tail ELBO: the mean of the last 20 rows, 200 steps
MS_GAUSS_D = 256         # tests/test_measure_space.py:265's width
MS_GAUSS_STEPS = 400     # tests/test_measure_space.py:105's horizon
MS_BAM_STEPS = 150       # tests/test_measure_space.py:265's run
MS_TIMED_STEPS = 20
MS_TIMED_DIMS = (62, 256, 512)
MS_TERM_STEPS = 400
MS_WARM_STEPS = 20


def ms_flagship_algs():
    """(name, algorithm, minimises KL) of (z)'s flagship runs."""
    import advancedvi_jl_tpu_torch as avt

    return [
        ("ngd", avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=32), True),
        ("ngd_noposdef", avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=32,
                                                     ensure_posdef=False), True),
        ("sqrt_ngd", avt.KLMinSqrtNaturalGradDescent(stepsize=0.05, n_samples=16), True),
        # the forward step M = I + eta H needs eta < 2 / lam_max(-H), and
        # lam_max is about 103 near this posterior: 0.05 diverges by step 3,
        # in the JAX package too (tests/test_torch_measure_space.py)
        ("wass", avt.KLMinWassFwdBwd(stepsize=0.01, n_samples=16), True),
        ("wass_ns", avt.KLMinWassFwdBwd(stepsize=0.01, n_samples=16, sqrtm="newton_schulz"),
         True),
        ("bam", avt.FisherMinBatchMatch(n_samples=32), False),
        ("ngd_stein", avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=64,
                                                  hessian="stein"), True),
    ]


def ms_gauss_algs():
    """tests/test_measure_space.py:90's settings."""
    import advancedvi_jl_tpu_torch as avt

    return [
        ("ngd", avt.KLMinNaturalGradDescent(stepsize=0.1, n_samples=16)),
        ("ngd_noposdef", avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=16,
                                                     ensure_posdef=False)),
        ("sqrt_ngd", avt.KLMinSqrtNaturalGradDescent(stepsize=0.05, n_samples=16)),
        ("wass", avt.KLMinWassFwdBwd(stepsize=0.05, n_samples=16)),
        ("wass_ns", avt.KLMinWassFwdBwd(stepsize=0.05, n_samples=16, sqrtm="newton_schulz")),
        ("bam", avt.FisherMinBatchMatch(n_samples=32)),
    ]


def ms_target(d, dev):
    """(target, q0) at width d: the flagship logreg at 62 from scale 0.1,
    else the well-conditioned dense Gaussian (matmul-only log density) from
    the identity."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond

    if d == N_FEATURES + 2:
        return (flagship(dev).unconstrained(),
                avt.FullRankGaussian(torch.zeros(d, device=dev), 0.1 * torch.eye(d, device=dev)))
    target, _, _ = normal_fullrank_wellcond(3, d, device=dev)
    return target.solve_free(), avt.FullRankGaussian(torch.zeros(d, device=dev))


def ms_flagship(dev, fr_ref):
    """(z) Each measure-space algorithm through ``optimize`` on the flagship
    logreg from FullRankGaussian(0, 0.1 I), MS_STEPS steps, counted: finite;
    the KL minimisers' tail ELBO within 2.0 of (l)'s fused full-rank logreg
    tail and their locations within 0.15 of its averaged location
    (tests/test_cross_algorithm.py's bound); BaM, which minimises another
    divergence, above -150 (bench.py's ``converged``).  Each step launches
    K7b once.  Returns the K7b launches."""
    import advancedvi_jl_tpu_torch as avt

    fr_tail, fr_loc = fr_ref
    target, q0 = ms_target(N_FEATURES + 2, dev)
    launches = 0
    for name, alg, kl in ms_flagship_algs():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        q, infos, _ = avt.optimize(SEED, alg, MS_STEPS, target, q0, log_every=MS_LOG_EVERY)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k7b = read_launches()["fullrank_sample"]
        tail = tail_elbo(infos)
        loc = max_err(q.location, fr_loc)
        say("z", flagship=name, d=q.dim, steps=MS_STEPS, elbo_tail_mean=tail,
            fused_fullrank_tail_mean=fr_tail, location_max_abs_diff_vs_fused=loc,
            seconds=f"{secs:.2f}", steps_per_s=f"{MS_STEPS / secs:.1f}",
            fullrank_sample_launches=k7b)
        check(all(math.isfinite(r["elbo"]) for r in infos), f"(z) {name}: ELBO not finite")
        check(bool(torch.isfinite(q.scale).all()), f"(z) {name}: scale not finite")
        check(k7b == MS_STEPS, f"(z) {name}: {k7b} K7b launches in {MS_STEPS} steps")
        if kl:
            check(abs(tail - fr_tail) <= 2.0, f"(z) {name}: tail {tail} vs fused {fr_tail}")
            check(loc <= 0.15, f"(z) {name}: location {loc} from the fused run's")
        else:
            check(tail > -150.0, f"(z) {name}: tail ELBO {tail} <= -150")
        launches += k7b
    return launches


def ms_gaussians(dev):
    """(z) The d = 256 dense Gaussian: each algorithm at least halves its
    parameter error ||m - mu||^2 + ||C - L||^2 within MS_GAUSS_STEPS steps
    (tests/test_measure_space.py:105's bar), and BaM stays finite for
    MS_BAM_STEPS steps with Sigma's least eigenvalue above 1e-4 (:265).
    Returns the K7b launches."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond

    target, mu, L = normal_fullrank_wellcond(3, MS_GAUSS_D, device=dev)
    target = target.solve_free()
    q0 = avt.FullRankGaussian(torch.zeros(MS_GAUSS_D, device=dev))

    def err(q):
        return float(torch.sum((q.location - mu) ** 2) + torch.sum((torch.tril(q.scale) - L) ** 2))

    err0 = err(q0)
    launches = 0
    for name, alg in ms_gauss_algs():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        q, infos, _ = avt.optimize(SEED, alg, MS_GAUSS_STEPS, target, q0, log_every=100)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches += read_launches()["fullrank_sample"]
        e = err(q)
        say("z", gaussian=name, d=MS_GAUSS_D, steps=MS_GAUSS_STEPS, param_err=e, param_err0=err0,
            elbo_last=infos[-1]["elbo"], seconds=f"{secs:.2f}")
        check(all(math.isfinite(r["elbo"]) for r in infos), f"(z) {name} at d = 256: not finite")
        check(e <= err0 / 2, f"(z) {name} at d = 256: error {e} not half of {err0}")
    alg = avt.FisherMinBatchMatch(n_samples=32)
    reset_launches()
    state = alg.init(SEED, q0, target)
    finite = True
    for _ in range(MS_BAM_STEPS):
        state, info = alg.step(state)
        finite = finite and bool(torch.isfinite(info["elbo"]))
    launches += read_launches()["fullrank_sample"]
    C = state.q.scale.double()
    least = float(torch.linalg.eigvalsh(C @ C.T)[0])
    say("z", bam_no_collapse=f"d={MS_GAUSS_D}", steps=MS_BAM_STEPS, finite=finite,
        sigma_least_eigenvalue=least)
    check(finite and least > 1e-4, f"(z) BaM at d = 256: finite {finite}, least eig {least}")
    return launches


def state_leaves(obj):
    """Every tensor and host value of an algorithm's state, depth first
    through dataclass fields (but the target), tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj) if f.name != "prob"
                for x in state_leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in state_leaves(o)]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in state_leaves(obj[k])]
    return [obj]


def ms_termination(dev):
    """(z) WithTermination(alg, elbo_at_least(x)) through chunked
    ``optimize`` (64-step chunks) for flagship ADVI (phase (f)'s algorithm)
    and NGD, x the largest ELBO of the last half of a dense run's log: it
    stops at the dense run's first step at or above x, and the whole state
    there (every tensor and host value but the target) is bitwise that of
    the dense run cut at that step.  Also the stop
    channel's cost: steps/s with a criterion that never fires beside the
    plain algorithm.  Returns the K7b launches."""
    import advancedvi_jl_tpu_torch as avt
    prob = flagship(dev)
    target, d = prob.unconstrained(), prob.dim
    cases = (
        ("advi", lambda: avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                                 optimizer=avt.adam(LR),
                                                 operator=avt.ClipScale()),
         avt.MeanFieldGaussian(torch.zeros(d, device=dev), 0.1 * torch.ones(d, device=dev))),
        ("ngd", lambda: avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=32),
         ms_target(d, dev)[1]),
    )
    launches = 0
    for name, make, q0 in cases:
        reset_launches()
        _, dense, _ = avt.optimize(SEED, make(), MS_TERM_STEPS, target, q0)
        x = max(r["elbo"] for r in dense[MS_TERM_STEPS // 2:])
        first = next(r["iteration"] for r in dense if r["elbo"] >= x)
        _, rows, st = avt.optimize(SEED, avt.WithTermination(make(), avt.elbo_at_least(x)),
                                   MS_TERM_STEPS, target, q0, chunk_size=64)
        _, _, ref = avt.optimize(SEED, make(), first, target, q0)
        launches += read_launches()["fullrank_sample"]
        a, b = state_leaves(st), state_leaves(ref)
        bitwise = len(a) == len(b) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))
        rates = {}
        for tag, alg in (("plain", make()),
                         ("never_fires", avt.WithTermination(make(), avt.elbo_at_least(math.inf)))):
            avt.optimize(SEED, alg, 10, target, q0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            avt.optimize(SEED, alg, 200, target, q0, chunk_size=200)
            torch.cuda.synchronize()
            rates[tag] = 200 / (time.perf_counter() - t0)
        say("z", termination=name, target_elbo=x, dense_first_step=first,
            stopped_at=rows[-1]["iteration"], state_iteration=st.iteration,
            state_bitwise_dense=bitwise, steps_per_s_plain=f"{rates['plain']:.1f}",
            steps_per_s_with_stop_channel=f"{rates['never_fires']:.1f}")
        check(rows[-1]["iteration"] == first == st.iteration,
              f"(z) {name}: stopped at {rows[-1]['iteration']}, dense first {first}")
        check(bitwise, f"(z) {name}: the stopped state is not the dense run's")
    return launches


def ms_pathfinder(dev):
    """(z) Pathfinder on the flagship: a finite best ELBO; NGD from its q
    beats NGD from FullRankGaussian(0, 0.1 I) after MS_WARM_STEPS steps by
    0.5 nats (tests/test_pathfinder.py:64's bar; MS_EVAL_SAMPLES-sample
    ELBOs); multi-path with MS_PATHS paths reports k-hat and ESS.  Returns the K7b
    launches."""
    import advancedvi_jl_tpu_torch as avt

    target, q_cold = ms_target(N_FEATURES + 2, dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = avt.pathfinder(SEED, target, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ev = avt.RepGradELBO(n_samples=MS_EVAL_SAMPLES, entropy=avt.MONTE_CARLO)
    elbo = {}
    for tag, q0 in (("warm", res.q), ("cold", q_cold)):
        q, _, _ = avt.optimize(SEED, avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=32),
                               MS_WARM_STEPS, target, q0)
        elbo[tag] = -float(ev.estimate_objective(5, q, target))
    t0 = time.perf_counter()
    draws, diag, results = avt.multipath_pathfinder(SEED, target, n_paths=MS_PATHS,
                                                    n_draws=MS_PATH_DRAWS, device=dev)
    torch.cuda.synchronize()
    multi_secs = time.perf_counter() - t0
    launches = read_launches()["fullrank_sample"]
    say("z", pathfinder="flagship", best_elbo=float(res.elbo), best_iter=int(res.best_iter),
        seconds=f"{secs:.2f}", ngd_warm_elbo=elbo["warm"], ngd_cold_elbo=elbo["cold"],
        warm_steps=MS_WARM_STEPS, multipath_paths=MS_PATHS, multipath_khat=diag["khat"],
        multipath_ess=diag["ess"], multipath_seconds=f"{multi_secs:.2f}",
        path_elbos=",".join(f"{float(r.elbo):.2f}" for r in results))
    check(math.isfinite(float(res.elbo)), "(z) Pathfinder's best ELBO is not finite")
    check(elbo["warm"] > elbo["cold"] + 0.5, f"(z) NGD warm {elbo['warm']} vs cold {elbo['cold']}")
    check(bool(torch.isfinite(draws).all()) and math.isfinite(diag["ess"]),
          "(z) multi-path draws or ESS not finite")
    return launches


def ms_rates(dev, card):
    """(z) Steps/s of each algorithm at d = 62, 256 and 512 (host clock over
    MS_TIMED_STEPS steps ending in a sync, after 3 warm-up steps)."""
    for d in MS_TIMED_DIMS:
        target, q0 = ms_target(d, dev)
        for name, alg, _ in ms_flagship_algs():
            state = alg.init(SEED, q0, target)
            for _ in range(3):
                state, _ = alg.step(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MS_TIMED_STEPS):
                state, _ = alg.step(state)
            torch.cuda.synchronize()
            say("z", rate=name, d=d, steps_per_s=f"{MS_TIMED_STEPS / (time.perf_counter() - t0):.1f}",
                card=card)


# the ops that run cuSOLVER (and the triangular solves, cuBLAS trsm)
LINALG_OPS = ("aten::linalg_eigh", "aten::linalg_svd", "aten::linalg_cholesky_ex",
              "aten::linalg_solve_triangular")


def ms_step_split(dev, card):
    """(z) One NGD, Wass and BaM step at d = 62 and 512, split: kernels a
    step and the device busy share (torch.profiler over 5 steps, each
    kernel's device time over the host clock's), the linear-algebra ops'
    device time (cuSOLVER's eigh, SVD and Cholesky; trsm), host syncs a step
    (``torch.cuda.set_sync_debug_mode``'s warnings over one step), and K7b's
    card time (graph replay) and host time a call at the step's shape."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        fullrank_sample_cuda, seed_words,
    )

    algs = {name: alg for name, alg, _ in ms_flagship_algs()}
    for d in (62, 512):
        target, q0 = ms_target(d, dev)
        for name in ("ngd", "wass", "bam"):
            alg = algs[name]
            state = alg.init(SEED, q0, target)
            for _ in range(3):
                state, _ = alg.step(state)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state, _ = alg.step(state)
            torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            steps = 5
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    state, _ = alg.step(state)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            avg = prof.key_averages()
            kern = [e for e in avg if e.device_type == DeviceType.CUDA]
            n_kernels = sum(e.count for e in kern) / steps
            busy_us = sum(e.device_time_total for e in kern) / steps
            k7b_us = sum(e.device_time_total for e in kern if "fullrank" in e.key) / steps
            linalg = {e.key.split("::")[1]: e.device_time_total / steps for e in avg
                      if e.key in LINALG_OPS}
            n = alg.n_samples
            C = state.q.scale.contiguous()
            k7b = lambda: fullrank_sample_cuda(seed_words(SEED), 1, state.q.location, C, n)  # noqa: E731
            say("z", split=name, d=d, n=n, step_us=f"{wall_us / steps:.1f}",
                kernels_a_step=f"{n_kernels:.1f}", device_busy_us=f"{busy_us:.1f}",
                device_busy_share=f"{busy_us / (wall_us / steps):.3f}", host_syncs_a_step=syncs,
                **{f"{k}_device_us": f"{v:.1f}" for k, v in linalg.items()},
                k7b_profiled_device_us=f"{k7b_us:.2f}",
                k7b_graph_us=f"{1e3 * graph_ms(k7b):.2f}", k7b_host_us=f"{host_us(k7b, 300):.1f}",
                card=card)
            check(n_kernels > 0, f"(z) the profiler saw no kernel in a {name} step")


def phase_z(dev, card, fr_ref):
    """(z) The measure-space slice.  K7b against its plain version at the
    slice's shapes; then its main path, counted, with every K7b shape it
    launched held to those checked here or in (i): each algorithm on the
    flagship and the d = 256 Gaussian, the stop channel and Pathfinder; then
    steps/s and the step splits.  Returns K7b's main-path launches and its
    largest error."""
    err = phase_i(dev, MS_SAMPLE_SHAPES, "z", MS_SAMPLE_SHAPES)
    with k7b_shapes() as shapes:
        launches = (ms_flagship(dev, fr_ref) + ms_gaussians(dev) + ms_termination(dev)
                    + ms_pathfinder(dev))
    say("z", fullrank_sample_main_path_launches=launches)
    check_k7b_shapes("z", shapes, FR_SAMPLE_SHAPES + MS_SAMPLE_SHAPES)
    ms_rates(dev, card)
    ms_step_split(dev, card)
    return launches, err


def main() -> int:
    parent = None  # --parent DIR: the A/B of the chunks against that checkout
    argv = sys.argv[1:]
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = Path(argv[1]).resolve()
        if not (parent / "advancedvi_jl_tpu_torch" / "__init__.py").is_file():
            fail(f"--parent {parent}: no advancedvi_jl_tpu_torch/ there")
    elif argv:
        fail(f"usage: python3 chip_smoke.py [--parent CHECKOUT], got {sys.argv[1:]}")
    seconds = {}  # wall seconds of each phase, printed before the kernels line
    last = [time.perf_counter()]

    def lap(phases: str) -> None:
        now = time.perf_counter()
        seconds[phases] = round(now - last[0], 1)
        last[0] = now

    card = phase_a()
    # full float32 matmuls for every comparison and both entry points
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase_b()
    lap("ab")
    samp_err = phase_c(dev)
    fused_err = phase_d(dev)
    phase_e(dev)
    counts = main_path(dev)
    times = phase_h(dev, card)
    lap("c-h")
    fr_samp_err = phase_i(dev)
    tri_err = phase_j(dev)
    fr_fused_err, fr_cluster_err = phase_k(dev)
    fr_counts, fr_ref = fullrank_paths(dev)
    fr_times = phase_m(dev, card)
    lap("i-m")
    slice_err = phase_n(dev)
    general, _ = slice_general(dev)
    slice_counts = slice_fused(dev, general)
    slice_times = phase_q(dev, card)
    lap("n-q")
    mb_err = phase_r(dev)
    lap("r")
    probes = phase_s(dev)
    lap("s")
    lr_state = phase_t(dev)
    lap("t")
    mb_counts, mb_times = phase_u(dev, card, lr_state)
    lap("u")
    chains_err = phase_v(dev)
    lap("v")
    chains_counts, wide_counts, chains_times, chains_main_err = phase_w(dev, card)
    lap("w")
    lowrank_counts, lowrank_err, lowrank_times, issue = phase_x(dev, card)
    lap("x")
    k5_launches, k5_err, k5_ms, k5_plain_ms, k5_bound = phase_y(dev, card)
    lap("y")
    ms_launches, ms_samp_err = phase_z(dev, card, fr_ref)
    lap("z")
    if parent is not None:
        ab_parent(parent)
        lap("ab")
    say("time", total=round(sum(seconds.values()), 1), **seconds)
    bounds = {name: bound(*fb, issue.get(name, 0.0)) for name, fb in kernel_bounds().items()}
    src = "advancedvi_jl_tpu_torch/csrc/"
    fused = "advancedvi_jl_tpu/ops/pallas/fused_advi.py:"

    def entry(name, source, replaces, launches, err, ms, plain_ms, library_ms=None,
              bound_=None):
        b_ms, b_by = bounds[name] if bound_ is None else bound_
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}

    kernels = [
        entry("meanfield_sample", "meanfield_sample.cu",
              "advancedvi_jl_tpu/ops/pallas/location_scale_kernels.py:72",
              counts["meanfield_sample"], samp_err, *times["meanfield_sample"]),
        entry("fused_advi_meanfield", "fused_advi_meanfield.cu", f"{fused}672",
              counts["fused_advi_meanfield"], fused_err, *times["fused_advi_meanfield"]),
        # the general full-rank path of (l) and the measure-space path of (z)
        entry("fullrank_sample", "fullrank_sample.cu",
              "advancedvi_jl_tpu/ops/pallas/location_scale_kernels.py:110",
              fr_counts["fullrank_sample"] + ms_launches, max(fr_samp_err, ms_samp_err),
              *fr_times["fullrank_sample"]),
        entry("trisolve", "trisolve.cu", "advancedvi_jl_tpu/ops/pallas/trisolve_kernels.py:115",
              fr_counts["trisolve"], tri_err, *fr_times["trisolve_C"]),
        # mode CT: the same kernel source and launch counter, timed apart
        entry("trisolve_CT", "trisolve.cu",
              "advancedvi_jl_tpu/ops/pallas/trisolve_kernels.py:115", fr_counts["trisolve"],
              tri_err, *fr_times["trisolve_CT"], bound_=bounds["trisolve"]),
        # the single-block kernel on the main paths of (l) and (p) (full-rank
        # prox, d = 11: one panel), timed and bounded at (p)'s shape; its
        # error from (k) at d = 62 and 512 (forced to one block)
        entry("fused_advi_fullrank", "fused_advi_fullrank.cu", f"{fused}681",
              fr_counts["fused_advi_fullrank"] + slice_counts["fused_advi_fullrank"],
              fr_fused_err, *slice_times["prox_fullrank_nln"]),
    ]
    # the cluster kernel on (l)'s main path, timed at d = 512 (cluster_blocks' size)
    ms, plain_ms, b_ms, b_by = fr_times["fused_advi_fullrank_cluster_mvnormal"]
    kernels.append(entry("fused_advi_fullrank_cluster", "fused_advi_fullrank.cu", f"{fused}681",
                         fr_counts["fused_advi_fullrank_cluster"], fr_cluster_err, ms, plain_ms,
                         bound_=(b_ms, b_by)))
    for name, group, source, line, timed in (
            ("fused_k3_rules", "k3_rules", "fused_common.cuh", 556, "prox"),
            ("fused_k3_vargrad", "k3_vargrad", "fused_advi_meanfield.cu", 489, "bbvi"),
            ("fused_k4_gaussian", "k4_gaussian", "fused_common.cuh", 1204,
             "prox_fullrank_nln")):
        kernels.append(entry(name, source, f"{fused}{line}", slice_counts[group],
                             slice_err[group], *slice_times[timed]))
    for tr, line in (("inplace", 987), ("staged", 997), ("prefetch", 1029)):
        ms, plain_ms, b_ms, b_by = mb_times[tr]
        kernels.append(entry(f"fused_k4_minibatch_{tr}", "fused_common.cuh", f"{fused}{line}",
                             mb_counts[f"k4_minibatch_{tr}"], mb_err[tr], ms, plain_ms,
                             bound_=(b_ms, b_by)))
    kernels.append(entry("probes", "probes.cu", "_pallas_probe.py:25", probes["launches"],
                         probes["max_abs_err"], probes["ms"], probes["plain_ms"],
                         bound_=probes["bound"]))
    # K6 at one chain a block (C = 64) and at several (C = 1,024), each
    # counted in its own main-path run
    for name, launches, C in (("fused_chains", chains_counts, CHAINS_MAIN_C),
                              ("fused_chains_g", wide_counts, CHAINS_WIDE_C)):
        kernels.append(entry(name, "fused_chains.cu",
                             "advancedvi_jl_tpu/ops/pallas/fused_chains.py:525",
                             launches["fused_chains"], max(chains_err, chains_main_err),
                             *chains_times[C]))
    ms, plain_ms, b_ms, b_by = lowrank_times
    kernels.append(entry("lowrank_sample", "lowrank_sample.cu",
                         "advancedvi_jl_tpu/ops/pallas/location_scale_kernels.py:155",
                         lowrank_counts["lowrank_sample"], lowrank_err, ms, plain_ms,
                         bound_=(b_ms, b_by)))
    k5 = entry("fused_k5_ad", "", f"{fused}1504", k5_launches, k5_err, k5_ms, k5_plain_ms,
               bound_=k5_bound)
    k5["source"] = "advancedvi_jl_tpu_torch/ops/cuda/ad_body.py"  # emits the CUDA body
    kernels.append(k5)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
