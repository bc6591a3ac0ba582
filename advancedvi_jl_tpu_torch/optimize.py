"""The ``optimize`` loop (port of optimize.py).

Steps run eagerly; their info entries stay on the device, and the host
reads them once per chunk of ``chunk_size`` steps (default: the whole run):
every scalar tensor entry of every step (``elbo``, ``diverged``, an
algorithm's own such as BaM's ``covweighted_fisher``), one copy a dtype.
That read names the exact first non-finite step in the ``DivergenceError``.
Info rows are kept on the ``log_every`` grid as in the reference: within
each chunk (a multiple of ``log_every``) every ``log_every``-th step, plus
the last step of the run.  A row also carries the step's host-side info
entries (a subsampled objective's ``epoch`` and ``step``).

An algorithm whose info carries ``terminate`` (``WithTermination``) stops
the run at the first step that sets it: the host reads that flag after
each of its steps (one sync a step, for those algorithms only), and the
returned state, output and last row are the terminating step's, the row's
``iteration`` that step.  Divergence wins over a simultaneous terminate.

With a ``callback`` the loop syncs every step and calls
``callback(iteration=, state=, info=, gradient=, averaged_params=)`` with
the keywords it declares; returning ``{"terminate": True}`` stops the run,
as does the algorithm's own ``terminate``.
Warm start: pass the returned ``state`` back as ``state=``.

``mesh`` (``parallel.make_vi_mesh``): the run happens under the mesh
(``parallel.mesh.use_mesh``), its state initialised on every rank and
broadcast from the first; the objective's ``mc_axis`` splits the draws and
the target's ``data_axis`` the data (where both are one axis, each rank
evaluates its draws on every row).  The reduced ELBO is the same on every
rank, so every rank raises a divergence at the same step and returns the
same output.

``show_progress`` / ``progress`` (a ``utils.progress.ProgressMeter``, which
implies ``show_progress``): one updating line of the merged info.  The meter
moves at each chunk's host read, so with no ``chunk_size`` (and no
callback) a run of 40 steps or more is cut into about 20 chunks; it adds no
wait for the device.  With a callback it moves every step.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Callable, Optional

import torch


class DivergenceError(RuntimeError):
    """Raised when the objective became non-finite (reference common.jl:83-89)."""


def optimize(
    seed,
    algorithm,
    max_iter: int,
    prob,
    q_init,
    *,
    state: Optional[Any] = None,
    callback: Optional[Callable] = None,
    chunk_size: Optional[int] = None,
    show_progress: bool = False,
    progress: Optional[Any] = None,
    check_divergence: bool = True,
    mesh: Optional[Any] = None,
    log_every: int = 1,
):
    """Run a variational inference algorithm.

    Returns ``(output, infos, state)``: the averaged family, the list of info
    dicts (``elbo``, ``diverged``, ``iteration``), and the warm-start state.
    ``seed`` (int, ``torch.Generator`` or two words) is used only when no
    ``state`` is given.
    """
    if log_every < 1:
        raise ValueError(f"log_every must be >= 1, got {log_every}")
    if mesh is not None:
        from .parallel.mesh import replicate_state, use_mesh

        with use_mesh(mesh):
            if state is None:
                state = algorithm.init(seed, q_init, prob)
            return optimize(seed, algorithm, max_iter, prob, q_init,
                            state=replicate_state(state, mesh), callback=callback,
                            chunk_size=chunk_size, show_progress=show_progress,
                            progress=progress, check_divergence=check_divergence,
                            log_every=log_every)
    if show_progress and progress is None:
        from .utils.progress import ProgressMeter

        progress = ProgressMeter(max_iter)
    if progress is not None and callback is None and chunk_size is None and max_iter >= 40:
        chunk_size = -(-max_iter // 20)  # the meter moves once a chunk
    if state is None:
        state = algorithm.init(seed, q_init, prob)
    if callback is not None:
        return _callback_loop(
            algorithm, max_iter, state, callback, check_divergence, log_every, progress
        )
    infos: list = []
    chunk = chunk_size or max_iter
    chunk = max(log_every, (chunk // log_every) * log_every)
    done = 0
    while done < max_iter:
        n = min(chunk, max_iter - done)
        steps = []
        for _ in range(n):
            state, info = algorithm.step(state)
            steps.append(info)
            if "terminate" in info and _halts(info, check_divergence):
                break
        rows = _read_rows(steps)  # the chunk's one wait for the device
        first = next((t for t, r in enumerate(rows) if r.get("diverged")), None)
        if check_divergence and first is not None:
            raise DivergenceError(
                f"The objective became non-finite at iteration {done + first + 1}. "
                "This indicates that the optimization diverged."
            )
        stop = bool(rows[-1].get("terminate", False))
        for t, row in enumerate(rows):
            if (t + 1) % log_every == 0 or t + 1 == n or (stop and t + 1 == len(rows)):
                row["iteration"] = done + t + 1
                infos.append(row)
        done += len(rows)
        if progress is not None:
            progress.update(min(done, max_iter), rows[-1], force=stop)
        if stop:
            break
    if progress is not None:
        progress.close()
    return algorithm.output(state), infos, state


def _halts(info: dict, check_divergence: bool) -> bool:
    """Whether the run stops after this step: it set ``terminate``, or
    diverged while divergence is checked (one host read)."""
    flag = torch.as_tensor(info["terminate"])
    if check_divergence and "diverged" in info:
        flag = flag | torch.as_tensor(info["diverged"]).to(flag.device)
    return bool(flag)


def _read_rows(steps: list) -> list:
    """Each step's info as a dict of host values: every 0-dim tensor entry,
    stacked by device and dtype and copied once a group after the chunk
    (the first copy waits for the device), as its Python value; the host
    entries as they are.  A row without ``diverged`` gets it from its
    ``elbo``."""
    groups: dict = {}
    for info in steps:
        for v in info.values():
            if isinstance(v, torch.Tensor) and v.dim() == 0:
                groups.setdefault((v.device, v.dtype), []).append(v)
    values = {key: iter(torch.stack(g).tolist()) for key, g in groups.items()}
    rows = []
    for info in steps:
        row = {k: next(values[v.device, v.dtype]) if isinstance(v, torch.Tensor) else v
               for k, v in info.items() if not isinstance(v, torch.Tensor) or v.dim() == 0}
        if "diverged" not in row and "elbo" in row:
            row["diverged"] = not math.isfinite(row["elbo"])
        rows.append(row)
    return rows


def _accepted_kwargs(callback: Callable) -> Optional[set]:
    """Parameter names a callback accepts, or None if it takes **kwargs."""
    try:
        sig = inspect.signature(callback)
    except (TypeError, ValueError):
        return None
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            return None
    return set(sig.parameters)


def _callback_loop(algorithm, max_iter, state, callback, check_divergence, log_every,
                   progress):
    accepted = _accepted_kwargs(callback)

    def wants(name: str) -> bool:
        return accepted is None or name in accepted

    with_grad = wants("gradient") and getattr(algorithm, "supports_grad", False)
    infos: list = []
    for t in range(max_iter):
        state, info = (algorithm.step(state, with_grad=True) if with_grad
                       else algorithm.step(state))
        gradient = info.pop("gradient", None)
        info = {
            k: (v.item() if isinstance(v, torch.Tensor) else v)
            for k, v in info.items()
        }
        if check_divergence and info.get("diverged", False):
            raise DivergenceError(
                f"The objective value is {info.get('elbo')} at iteration "
                f"{t + 1}. This indicates that the optimization diverged."
            )
        kw = dict(iteration=state.iteration, state=state, info=info)
        if with_grad:
            kw["gradient"] = gradient
        if wants("averaged_params"):
            kw["averaged_params"] = algorithm.output(state)
        if accepted is not None:
            kw = {k: v for k, v in kw.items() if k in accepted}
        extra = callback(**kw)
        stop = bool(info.get("terminate", False))
        if extra:
            stop = bool(extra.pop("terminate", False)) or stop
            info.update(extra)
        info["iteration"] = t + 1
        if (t + 1) % log_every == 0 or t + 1 == max_iter or stop:
            infos.append(info)
        if progress is not None:
            progress.update(t + 1, info, force=stop)
        if stop:
            break
    if progress is not None:
        progress.close()
    return algorithm.output(state), infos, state
