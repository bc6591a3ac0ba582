"""The ``optimize`` loop (port of optimize.py).

Steps run eagerly; their ELBO estimates stay on the device, and the host
reads them once per chunk of ``chunk_size`` steps (default: the whole run).
That read names the exact first non-finite step in the ``DivergenceError``.
Info rows are kept on the ``log_every`` grid as in the reference: within
each chunk (a multiple of ``log_every``) every ``log_every``-th step, plus
the last step of the run.  A row also carries the step's host-side info
entries (a subsampled objective's ``epoch`` and ``step``).

With a ``callback`` the loop syncs every step and calls
``callback(iteration=, state=, info=, gradient=, averaged_params=)`` with
the keywords it declares; returning ``{"terminate": True}`` stops the run.
Warm start: pass the returned ``state`` back as ``state=``.
"""

from __future__ import annotations

import inspect
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
    check_divergence: bool = True,
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
    if state is None:
        state = algorithm.init(seed, q_init, prob)
    if callback is not None:
        return _callback_loop(
            algorithm, max_iter, state, callback, check_divergence, log_every
        )
    infos: list = []
    chunk = chunk_size or max_iter
    chunk = max(log_every, (chunk // log_every) * log_every)
    done = 0
    while done < max_iter:
        n = min(chunk, max_iter - done)
        elbos, extras = [], []
        for _ in range(n):
            state, info = algorithm.step(state)
            elbos.append(info["elbo"])
            extras.append({k: v for k, v in info.items()
                           if k not in ("elbo", "diverged") and not isinstance(v, torch.Tensor)})
        host = torch.stack(elbos).cpu()  # the chunk's one sync
        bad = ~torch.isfinite(host)
        if check_divergence and bool(bad.any()):
            first = done + int(bad.nonzero()[0, 0]) + 1
            raise DivergenceError(
                f"The objective became non-finite at iteration {first}. "
                "This indicates that the optimization diverged."
            )
        for t in range(n):
            if (t + 1) % log_every == 0 or t + 1 == n:
                infos.append({
                    **extras[t],
                    "elbo": float(host[t]),
                    "diverged": bool(bad[t]),
                    "iteration": done + t + 1,
                })
        done += n
    return algorithm.output(state), infos, state


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


def _callback_loop(algorithm, max_iter, state, callback, check_divergence, log_every):
    accepted = _accepted_kwargs(callback)

    def wants(name: str) -> bool:
        return accepted is None or name in accepted

    with_grad = wants("gradient") and getattr(algorithm, "supports_grad", False)
    infos: list = []
    for t in range(max_iter):
        state, info = algorithm.step(state, with_grad=with_grad)
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
        stop = False
        if extra:
            stop = bool(extra.pop("terminate", False))
            info.update(extra)
        info["iteration"] = t + 1
        if (t + 1) % log_every == 0 or t + 1 == max_iter or stop:
            infos.append(info)
        if stop:
            break
    return algorithm.output(state), infos, state
