"""Port parity: K9's four lowering probes (``ops/cuda/probe_kernels.py``),
run here through their plain PyTorch versions, against ``_pallas_probe.py``'s
Pallas kernels in TPU interpret mode on the same inputs, exactly (the probes
sum ones and store counters).  The CUDA kernel itself is held to the plain
version on a card (tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import _pallas_probe
from advancedvi_jl_tpu_torch.ops.cuda import probe_kernels
from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import (
    probe, probe_cuda, probe_inputs, probe_reference, run_probes,
)

CPU = "cpu"


def _jax_probe_output(monkeypatch, i):
    """Run ``_pallas_probe.probe{i}`` in interpret mode (its own asserts
    included) and return what its ``pallas_call`` produced."""
    outs = []
    real = pl.pallas_call

    def recording(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*xs):
            out = call(*xs)
            outs.append(np.asarray(out))
            return out

        return run

    monkeypatch.setattr(_pallas_probe.pl, "pallas_call", recording)
    with pltpu.force_tpu_interpret_mode():
        getattr(_pallas_probe, f"probe{i}")()
    assert len(outs) == 1
    return outs[0]


@pytest.mark.parametrize("i", [1, 2, 3, 4])
def test_probe_matches_jax_pallas_probe(monkeypatch, i):
    want = _jax_probe_output(monkeypatch, i)
    got = probe(i, probe_inputs(CPU)[i], device=CPU)
    assert got.device.type == "cpu"
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_shapes_match_jax_pallas_probe():
    assert (probe_kernels.STEPS, probe_kernels.LANES) == (_pallas_probe.STEPS, 128)


def test_run_probes_on_the_cpu_gives_the_asserted_values():
    outs = run_probes(CPU)
    assert [float(outs[i][-1, 0]) for i in (1, 2, 3, 4)] == [16 * 8 * 128, 16, 16, 16 * 8 * 128]
    assert all(o.device.type == "cpu" for o in outs.values())


@pytest.mark.parametrize("i", [1, 4])
def test_load_probes_sum_the_scheduled_rows(i):
    """On data other than ones: probe 1 sums rows 8s .. 8s+7 of step s,
    probe 4 rows 8k .. 8k+7 with k = s mod nb (nb = 3 and 5)."""
    rng = np.random.default_rng(i)
    for nb in (3, 5):
        rows = 16 * 8 if i == 1 else nb * 8
        x = rng.integers(-4, 5, size=(rows, 32)).astype(np.float32)
        k = np.arange(16) % nb if i == 4 else np.arange(16)
        want = sum(x[8 * j:8 * j + 8].sum() for j in k)
        got = probe_reference(i, torch.from_numpy(x), lanes=32, nb=nb)
        np.testing.assert_array_equal(got.numpy(), np.full((1, 32), want, np.float32))


def test_probe_kernel_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel's launch: the wrapper raises,
    and ``probe`` takes the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        probe_cuda(1, probe_inputs(CPU)[1])
    with pytest.raises(ValueError, match="probe must be"):
        probe(5, device=CPU)
