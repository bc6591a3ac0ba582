#!/usr/bin/env python3
"""Time the mean-field flagship chunk in this checkout and in another one.

    python3 ab_fused_chunk.py OTHER_CHECKOUT [ROUNDS]

Times chip_smoke.py phase (h)'s flagship chunk (``flagship_chunk_args``: one
200-step chunk of ``fused_run_chunk_cuda``, flagship logreg, 10 samples,
Adam(1e-3), in-kernel Philox; ``cuda_ms``: CUDA events, 20 launches after
one warm-up) with each checkout's package, in a fresh process per
measurement, alternating OTHER, THIS, THIS, OTHER for ROUNDS rounds (default
2), and prints each build's registers and spills as ptxas reported them.
The measurement is this checkout's chip_smoke.py in both; each checkout
builds its own kernels under its own build/kernels.  It needs one CUDA card
and imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parent

# run with the checkout under test as the working directory, so that its
# package is the one imported; chip_smoke.py is this checkout's
CHILD = r"""
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from advancedvi_jl_tpu_torch.ops.cuda import _build
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import fused_run_chunk_cuda

args = smoke.flagship_chunk_args(torch.device("cuda:0"))
ms = smoke.cuda_ms(lambda: fused_run_chunk_cuda(*args), 20)
out = fused_run_chunk_cuda(*args)
log = _build.build("fused_advi_meanfield").with_suffix(".log").read_text()
ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
print(json.dumps({"ms": ms, "ptxas": ptxas, "elbo": float(out[1])}))
"""


def measure(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(THIS / "chip_smoke.py")],
                          cwd=checkout, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"ab_fused_chunk: FAILED in {checkout}:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    other = Path(sys.argv[1]).resolve()
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=120)
    print(smi.stdout.strip(), flush=True)
    times = {"other": [], "this": []}
    for _ in range(rounds):
        for tag, path in (("other", other), ("this", THIS), ("this", THIS), ("other", other)):
            r = measure(path)
            times[tag].append(r["ms"])
            print(f"[ab] {tag} ms={r['ms']:.4f} elbo={r['elbo']}", flush=True)
    for tag, path in (("other", other), ("this", THIS)):
        for ln in measure(path)["ptxas"]:
            print(f"[ab] {tag} {ln}", flush=True)
    print(json.dumps({k: {"min": min(v), "mean": sum(v) / len(v), "all": v}
                      for k, v in times.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
