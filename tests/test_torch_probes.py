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
from advancedvi_jl_tpu_torch.ops.cuda import _build, probe_kernels
from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import (
    probe, probe_cuda, probe_inputs, probe_plan, probe_reference, run_probes, unit_of_step,
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


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("lanes", [32, 128, 1024])
@pytest.mark.parametrize("steps", [0, 1, 15, 16, 17])
def test_probe_plan_assigns_every_step_once(steps, lanes, nb):
    """The load probes' launch plan: each 8-row unit goes to exactly one
    warp, every step's unit is one of them, probe 4 reads each of its
    windows once (min(nb, steps) units), and the block and its shared
    memory fit one block."""
    for i in (1, 4):
        plan = probe_plan(i, steps, lanes, nb)
        taken = [k for w in range(plan.warps) for k in plan.warp_units(w)]
        assert sorted(taken) == list(range(plan.units)), (i, plan)
        assert {unit_of_step(i, s, nb) for s in range(steps)} == set(range(plan.units))
        assert plan.units == (steps if i == 1 else min(nb, steps))
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        assert plan.warps <= max(1, plan.units)
        assert 4 * plan.units <= plan.smem_bytes <= _build.SMEM_LIMIT
    for i in (2, 3):  # the store loops: one thread a lane
        assert probe_plan(i, steps, lanes, nb) == (lanes, 0, 0)


def test_probe_plan_refuses_what_the_kernel_cannot_take():
    for kwargs in (dict(lanes=48), dict(lanes=2048), dict(steps=-1)):
        with pytest.raises(ValueError, match="lanes a multiple of 32"):
            probe_plan(1, **kwargs)
    with pytest.raises(ValueError, match="nb >= 1"):
        probe_plan(4, nb=0)
    with pytest.raises(ValueError, match="shared memory"):
        probe_plan(1, steps=_build.SMEM_LIMIT // 4 + 1)
    assert probe_plan(1, steps=100).warps == 32  # more units than warps go round again
