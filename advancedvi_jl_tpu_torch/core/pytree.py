"""Dataclass-of-tensors convention (the port's counterpart of core/pytree.py).

Families, optimizer states and averager states are frozen dataclasses whose
tensor fields are the parameters.  ``tree_map`` maps a function over those
fields and rebuilds the same class, so optimizers, operators and averagers
work on any family without flattening it into one vector.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def tensor_fields(obj: Any) -> List[str]:
    """Names of the tensor-valued fields of a dataclass, in declaration order."""
    return [
        f.name
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    ]


def tree_map(fn: Callable, obj: Any, *rest: Any) -> Any:
    """Apply ``fn`` field-wise to the tensor fields of ``obj`` (and ``rest``)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    names = tensor_fields(obj)
    return dataclasses.replace(
        obj,
        **{n: fn(getattr(obj, n), *(getattr(r, n) for r in rest)) for n in names},
    )


def tree_leaves(obj: Any) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [getattr(obj, n) for n in tensor_fields(obj)]


def tree_stop_gradient(obj: Any) -> Any:
    """Detached copy: the ``q_stop`` of the STL estimator."""
    return tree_map(torch.Tensor.detach, obj)


def tree_global_norm_sq(obj: Any) -> torch.Tensor:
    return sum(torch.sum(t * t) for t in tree_leaves(obj))


def value_and_grad(loss_and_aux: Callable, q: Any):
    """``(grad, aux)`` of ``loss, aux = loss_and_aux(q)`` in the tensor
    fields of the family ``q``; ``grad`` is a family of the same class (the
    counterpart of ``jax.value_and_grad(..., has_aux=True)``)."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(True), q)
        loss, aux = loss_and_aux(live)
        names = tensor_fields(live)
        grads = torch.autograd.grad(loss, [getattr(live, n) for n in names])
    return dataclasses.replace(q, **dict(zip(names, grads))), aux
