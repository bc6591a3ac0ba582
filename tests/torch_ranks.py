"""What the port's multi-rank tests share (not a pytest module): the
scenario helpers every rank and the one-process reference call, the
launcher of the gloo CPU ranks, and the comparisons of their results.

A test file that uses it is also the ranks' program: ``run_ranks`` runs it
as ``python FILE RANK WORLD PORT OUTDIR``, and each rank writes
OUTDIR/rank<R>.pt.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def under(mesh):
    """``use_mesh(mesh)``, or no context where ``mesh`` is None."""
    from contextlib import nullcontext

    from advancedvi_jl_tpu_torch.parallel.mesh import use_mesh

    return nullcontext() if mesh is None else use_mesh(mesh)


def leaves(tree):
    """Detached copies of a pytree's tensor leaves."""
    from advancedvi_jl_tpu_torch.core.pytree import tree_leaves

    return [t.detach().clone() for t in tree_leaves(tree)]


def run_ranks(script, world, outdir, timeout):
    """Run ``script`` as ``world`` gloo CPU ranks writing into ``outdir``;
    their results (``rank<R>.pt``), in rank order.  Fails the test where a
    rank exits with another code than 0 or the ranks outlast ``timeout``
    seconds."""
    from advancedvi_jl_tpu_torch.parallel.distributed import free_port

    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT",
                                                            "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), str(r), str(world),
                               str(port), outdir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {world} ranks did not finish in {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed (rc {p.returncode}):\n{out[-4000:]}"
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def close(got, want, rtol, atol=0.0):
    """Each of ``got`` equals its entry of ``want`` within rtol and atol."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def equal(a, b):
    """``a`` and ``b`` (nested dicts, lists and tensors) bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b
