"""K9: the four lowering probes (port of _pallas_probe.py probe1-probe4).

Each probe is one access pattern the fused kernels are built from, run as a
16-step loop over 128 lanes: (1) dynamic row loads, (2) dynamic row stores,
(3) a store guarded every other step, (4) a ``rem``-scheduled row load (the
minibatch window).  ``probe_cuda`` launches csrc/probes.cu;
``probe_reference`` is its plain PyTorch version; ``probe`` takes the
kernel for CUDA tensors and the plain version for CPU tensors.
``run_probes`` runs all four with ``_pallas_probe.py``'s inputs and checks
the values that script asserts.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from .location_scale_kernels import check_f32

STEPS = 16
LANES = 128
ROWS = 8   # rows a step loads
NB = 3     # probe 4's window count (lax.rem(i, 3))


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
    fn = _build.function("probes", "probes",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.zeros(os, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(probe, x.data_ptr() if xs is not None else None, out.data_ptr(), steps,
                 lanes, nb, stream)
    _build.check(err, "probes launch")
    probe_cuda.launches += 1
    return out


probe_cuda.launches = 0


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
