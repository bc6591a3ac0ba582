"""K9: the four lowering probes (port of _pallas_probe.py probe1-probe4).

Each probe is one access pattern the fused kernels are built from, run as a
16-step loop over 128 lanes: (1) dynamic row loads, (2) dynamic row stores,
(3) a store guarded every other step, (4) a ``rem``-scheduled row load (the
minibatch window).  ``probe_cuda`` launches csrc/probes.cu
on ``probe_plan``'s block; ``probe_reference`` is its plain PyTorch
version; ``probe`` takes the kernel for CUDA tensors and the plain version
for CPU tensors.
``run_probes`` runs all four with ``_pallas_probe.py``'s inputs and checks
the values that script asserts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from . import _build
from .location_scale_kernels import check_f32

STEPS = 16
LANES = 128
ROWS = 8   # rows a step loads
NB = 3     # probe 4's window count (lax.rem(i, 3))
MAX_WARPS = 32  # a block's 1,024 threads


def _shapes(probe: int, steps: int, lanes: int, nb: int):
    """(x shape or None, out shape) of a probe."""
    if probe == 1:
        return (steps * ROWS, lanes), (1, lanes)
    if probe == 4:
        return (nb * ROWS, lanes), (1, lanes)
    if probe == 2:
        return None, (steps, lanes)
    if probe == 3:
        return None, (steps // 2, lanes)
    raise ValueError(f"probe must be 1, 2, 3 or 4, got {probe}")


def probe_reference(probe: int, x: Optional[torch.Tensor] = None, steps: int = STEPS,
                    lanes: int = LANES, nb: int = NB, device="cuda") -> torch.Tensor:
    """Plain version of the kernel: the probe's loop in PyTorch."""
    xs, os = _shapes(probe, steps, lanes, nb)
    dev = x.device if x is not None else torch.device(device)
    out = torch.zeros(os, dtype=torch.float32, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(steps):
        if probe in (1, 4):
            k = i % nb if probe == 4 else i
            acc = acc + torch.sum(x[k * ROWS:(k + 1) * ROWS])
        else:
            acc = acc + 1.0
            if probe == 2:
                out[i] = acc
            elif i % 2 == 1:
                out[i // 2] = acc
    if probe in (1, 4):
        out[0] = acc
    return out


class ProbePlan(NamedTuple):
    """A probe's launch: one block of ``threads`` threads.  Probes 1 and 4
    read ``units`` blocks of 8 rows (probe 1: one a step; probe 4: one a
    window, read once however many steps take it); warp w takes units w,
    w + warps, ... (``warp_units``), and the units' totals meet in
    ``smem_bytes`` of shared memory.  Probes 2 and 3: one thread a lane,
    no units."""

    threads: int
    units: int
    smem_bytes: int

    @property
    def warps(self) -> int:
        return self.threads // 32

    def warp_units(self, w: int) -> range:
        return range(w, self.units, self.warps)


def unit_of_step(probe: int, i: int, nb: int = NB) -> int:
    """The unit (8-row block) that step ``i`` of load probe 1 or 4 adds."""
    return i % nb if probe == 4 else i


@functools.lru_cache(maxsize=64)  # the wrapper asks at every launch
def probe_plan(probe: int, steps: int = STEPS, lanes: int = LANES, nb: int = NB) -> ProbePlan:
    """The launch of csrc/probes.cu for a probe: a warp a unit, up to
    MAX_WARPS warps (more units go round the warps again)."""
    _shapes(probe, steps, lanes, nb)
    if steps < 0 or not 32 <= lanes <= 1024 or lanes % 32 or (probe == 4 and nb < 1):
        raise ValueError(f"probe {probe} takes steps >= 0, lanes a multiple of 32 up to "
                         f"1024 and nb >= 1, got steps={steps}, lanes={lanes}, nb={nb}")
    if probe in (2, 3):
        return ProbePlan(lanes, 0, 0)
    units = steps if probe == 1 else min(nb, steps)
    plan = ProbePlan(32 * min(MAX_WARPS, max(1, units)), units, 4 * max(1, units))
    if plan.smem_bytes > _build.SMEM_LIMIT:
        raise ValueError(f"probe {probe} keeps one float a unit in shared memory: {units} "
                         f"units is over the {_build.SMEM_LIMIT}-byte limit of one block")
    return plan


_PROBE_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p]


def probe_cuda(probe: int, x: Optional[torch.Tensor] = None, steps: int = STEPS,
               lanes: int = LANES, nb: int = NB, device="cuda") -> torch.Tensor:
    """Launch csrc/probes.cu on the current stream; same results as
    ``probe_reference``.  Adds one to ``probe_cuda.launches`` per launch."""
    xs, os = _shapes(probe, steps, lanes, nb)
    dev = x.device if x is not None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"probe_cuda needs a CUDA device, got {dev}")
    if xs is not None:
        if x is None:
            raise ValueError(f"probe {probe} needs an input x of shape {xs}")
        check_f32("x", x, xs, dev)
    plan = probe_plan(probe, steps, lanes, nb)
    fn = probe_cuda.fn
    if fn is None:
        fn = probe_cuda.fn = _build.function("probes", "probes", _PROBE_ARGTYPES)
    out = torch.empty(os, dtype=torch.float32, device=dev)  # the kernel writes all of it
    err = _build.launch(fn, dev, probe, x.data_ptr() if xs is not None else None,
                        out.data_ptr(), steps, lanes, nb, plan.units, plan.threads,
                        plan.smem_bytes)
    _build.check(err, "probes launch")
    probe_cuda.launches += 1
    return out


probe_cuda.launches = 0
probe_cuda.fn = None  # the C entry, fetched (and built) at the first launch


def probe(probe_id: int, x: Optional[torch.Tensor] = None, steps: int = STEPS,
          lanes: int = LANES, nb: int = NB, device="cuda") -> torch.Tensor:
    """The kernel on the card, the plain version on the CPU (the device of
    ``x``, else ``device``)."""
    dev = x.device if x is not None else torch.device(device)
    if dev.type == "cuda":
        return probe_cuda(probe_id, x, steps, lanes, nb, dev)
    if dev.type == "cpu":
        return probe_reference(probe_id, x, steps, lanes, nb, dev)
    raise ValueError(f"no probe kernel for device {dev}")


def probe_inputs(device="cuda") -> Dict[int, Optional[torch.Tensor]]:
    """``_pallas_probe.py``'s inputs: ones of (128, 128) for probe 1 and of
    (24, 128) for probe 4."""
    return {1: torch.ones(STEPS * ROWS, LANES, device=device), 2: None, 3: None,
            4: torch.ones(NB * ROWS, LANES, device=device)}


def run_probes(device="cuda") -> Dict[int, torch.Tensor]:
    """The four probes at ``_pallas_probe.py``'s shapes on ``device``, each
    checked for the value that script asserts; returns their outputs."""
    outs = {i: probe(i, x, device=device) for i, x in probe_inputs(device).items()}
    want = {1: STEPS * ROWS * LANES, 2: STEPS, 3: STEPS, 4: STEPS * ROWS * LANES}
    for i, out in outs.items():
        got = float(out[-1, 0])
        if got != want[i]:
            raise RuntimeError(f"probe {i}: {got}, expected {want[i]}")
    return outs
