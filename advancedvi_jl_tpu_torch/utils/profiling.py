"""Tracing, profiling and a correctness guard (port of utils/profiling.py).

- ``trace(logdir)``: ``torch.profiler`` around a block (the card's kernels
  and the host's ops), written as a Chrome trace, ``<logdir>/trace.json``.
- ``retrace_guard``: fails when a block brings up more new compiled code
  than allowed.  The port has no jit cache; its costly, silent "recompile"
  is a new trace of a target into K5's generated body (ops/cuda/ad_body.py
  ``trace``: a new sample count or a new target) or a kernel library built or
  loaded for the first time (ops/cuda/_build.py), so the guard counts those
  two inside the block, whatever function runs there.
- ``nan_debugging``: ``torch.autograd.set_detect_anomaly`` for the block, so
  a NaN raises at the backward op that made it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block on the host and the card: ``with trace('/tmp/tb'):
    run_steps()`` writes ``/tmp/tb/trace.json``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class RetraceError(RuntimeError):
    pass


def _compiled_count() -> int:
    from ..ops.cuda import _build, ad_body

    return ad_body.TRACES[0] + len(_build._libs)


@contextlib.contextmanager
def retrace_guard(jitted_fn: Optional[Callable] = None, allowed: int = 0):
    """Fail if the block makes more than ``allowed`` new K5 traces and
    kernel-library loads (see the module's docstring)::

        state, _ = alg.step(state)              # warm-up: traces, builds
        with retrace_guard():
            for _ in range(100):
                state, _ = alg.step(state)      # must reuse what exists

    ``jitted_fn`` is the reference's argument: the port counts the whole
    process's traces and builds, so it is not read."""
    before = _compiled_count()
    yield
    new = _compiled_count() - before
    if new > allowed:
        raise RetraceError(
            f"{new} new K5 traces or kernel libraries (allowed {allowed}). A "
            "target, a sample count or a shape is changing between steps."
        )


@contextlib.contextmanager
def nan_debugging():
    import torch

    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)
