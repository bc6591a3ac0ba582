"""Dataclass-of-tensors convention (the port's counterpart of core/pytree.py).

Families, optimizer states and averager states are frozen dataclasses whose
tensor fields are the parameters.  ``tree_map`` maps a function over those
fields and rebuilds the same class, so optimizers, operators and averagers
work on any family without flattening it into one vector.  A field that
holds another such dataclass with tensors in it (``GlobalLocalFamily``'s
``global_q`` and ``local_q``) is a subtree: ``tree_map`` and
``tree_leaves`` walk into it, leaves in declaration order, depth first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def _is_node(v: Any) -> bool:
    return dataclasses.is_dataclass(v) and not isinstance(v, type) and bool(tensor_fields(v))


def tensor_fields(obj: Any) -> List[str]:
    """Names of the fields of a dataclass that hold tensors (a tensor, or a
    dataclass with tensors in it), in declaration order."""
    return [
        f.name
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor) or _is_node(getattr(obj, f.name))
    ]


def tree_map(fn: Callable, obj: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise to the tensors of ``obj`` (and ``rest``)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    names = tensor_fields(obj)
    return dataclasses.replace(
        obj,
        **{n: tree_map(fn, getattr(obj, n), *(getattr(r, n) for r in rest)) for n in names},
    )


def tree_leaves(obj: Any) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [leaf for n in tensor_fields(obj) for leaf in tree_leaves(getattr(obj, n))]


def tree_stop_gradient(obj: Any) -> Any:
    """Detached copy: the ``q_stop`` of the STL estimator."""
    return tree_map(torch.Tensor.detach, obj)


def tree_global_norm_sq(obj: Any) -> torch.Tensor:
    return sum(torch.sum(t * t) for t in tree_leaves(obj))


def value_and_grad(loss_and_aux: Callable, q: Any, mc_axis=None):
    """``(grad, aux)`` of ``loss, aux = loss_and_aux(q)`` in the tensor
    fields of the family ``q``; ``grad`` is a family of the same class (the
    counterpart of ``jax.value_and_grad(..., has_aux=True)``).  Under a
    device mesh (parallel/mesh.py) ``loss`` and aux's scalars are this
    rank's shares: the gradient and those scalars come back summed over
    ``mc_axis`` and averaged over the mesh's other axes; the ranks of
    ``mc_axis`` evaluate different terms (``terms_split``)."""
    from ..parallel.mesh import reduce_tree, terms_split

    with torch.enable_grad(), terms_split(mc_axis):
        live = tree_map(lambda t: t.detach().requires_grad_(True), q)
        loss, aux = loss_and_aux(live)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return reduce_tree(tree_map(lambda _: next(grads), q), aux, mc_axis)
