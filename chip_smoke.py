#!/usr/bin/env python3
"""Smoke run of the PyTorch port (advancedvi_jl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from advancedvi_jl_tpu_torch/csrc with
nvcc, holds each kernel against its plain PyTorch version on the card, and
drives the flagship path (mean-field ADVI + STL, 10 samples, Adam(1e-3),
ClipScale, polynomial averaging on the 208 x 61 hierarchical logistic
regression, d = 62) through both entry points a user calls: ``optimize``
with ``KLMinRepGradDescent`` and ``FusedLogRegADVI.optimize``.  Phases:

  (a) the card (nvidia-smi name and power limit);  (b) kernel builds;
  (c) the mean-field sampler against its plain version, normal statistics;
  (d) the fused kernel against its plain version with injected noise;
  (e) the fused kernel with in-kernel Philox: chunking, tracing, plain version;
  (f) the general path on the card;  (g) the fused engine on the card;
  (h) steps/s of both paths and each kernel's time beside its plain version.

Every failed check raises and the script exits non-zero; it also exits
non-zero without a CUDA device, or when the package is not beside it.  The
line before the last is a JSON object of the kernels (launch counts from the
main-path run of (f) and (g), errors, times); the last line is
``{"ok": true, "device": {...}}``.  It imports no JAX.
"""

from __future__ import annotations

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


def phase_b():
    from advancedvi_jl_tpu_torch.ops.cuda import _build

    for name in _build.KERNELS:
        t0 = time.perf_counter()
        path = _build.build(name)
        secs = time.perf_counter() - t0
        ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        say("b", kernel=name, build_s=f"{secs:.2f}", lib=path.name)
        for ln in ptxas:
            print(f"    {ln}", flush=True)


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
    return worst


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
    args = (prob.X, prob.y, sc, s0, seed_words(SEED), 0, steps, N_SAMPLES, hyp, noise)
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
    base = (prob.X, prob.y, sc)
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


def reset_launches():
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import fused_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import meanfield_sample_cuda

    meanfield_sample_cuda.launches = 0
    fused_run_chunk_cuda.launches = 0


def read_launches():
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import fused_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import meanfield_sample_cuda

    return {"meanfield_sample": meanfield_sample_cuda.launches,
            "fused_advi_meanfield": fused_run_chunk_cuda.launches}


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


def phase_h(dev, card):
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        FusedHyper, fused_run_chunk_cuda, fused_run_chunk_reference,
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
    samp_ms = cuda_ms(lambda: meanfield_sample_cuda(seed, 1, loc, sc, N_SAMPLES), 1000)
    samp_plain = cuda_ms(lambda: meanfield_sample_reference(seed, 1, loc, sc, N_SAMPLES), 50)
    rows = initial_rows(d, dev)
    chunk = 200
    args = (prob.X, prob.y, (1.0, 3.0), rows, seed, 0, chunk, N_SAMPLES, FusedHyper(lr=LR))
    fk_ms = cuda_ms(lambda: fused_run_chunk_cuda(*args), 20)
    fr_ms = cuda_ms(lambda: fused_run_chunk_reference(*args), 1)
    say("h", meanfield_sample_ms=samp_ms, meanfield_sample_plain_ms=samp_plain,
        shape=f"{N_SAMPLES}x{d}")
    say("h", fused_chunk_ms=fk_ms, fused_chunk_plain_ms=fr_ms, chunk_steps=chunk)
    return {"meanfield_sample": (samp_ms, samp_plain),
            "fused_advi_meanfield": (fk_ms, fr_ms)}


def main() -> int:
    card = phase_a()
    # full float32 matmuls for every comparison and both entry points
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase_b()
    samp_err = phase_c(dev)
    fused_err = phase_d(dev)
    phase_e(dev)
    counts = main_path(dev)
    times = phase_h(dev, card)
    src = "advancedvi_jl_tpu_torch/csrc/"
    kernels = [
        {"name": "meanfield_sample", "route": "cuda", "source": src + "meanfield_sample.cu",
         "replaces": "advancedvi_jl_tpu/ops/pallas/location_scale_kernels.py:72",
         "launches": counts["meanfield_sample"], "max_abs_err": samp_err,
         "ms": times["meanfield_sample"][0], "plain_ms": times["meanfield_sample"][1]},
        {"name": "fused_advi_meanfield", "route": "cuda",
         "source": src + "fused_advi_meanfield.cu",
         "replaces": "advancedvi_jl_tpu/ops/pallas/fused_advi.py:672",
         "launches": counts["fused_advi_meanfield"], "max_abs_err": fused_err,
         "ms": times["fused_advi_meanfield"][0],
         "plain_ms": times["fused_advi_meanfield"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
