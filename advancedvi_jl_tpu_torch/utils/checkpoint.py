"""Checkpoint and resume of an optimization state (port of
utils/checkpoint.py).

Every state of the port is a tree of dataclasses, tuples (NamedTuples
included), lists and dicts over tensors and host integers; the Philox seed
words and the iteration counters are host integers in the state, so a
durable checkpoint is the leaves on disk and the same warm start:
``optimize(..., state=restore_state(path, template))`` repeats an
uninterrupted run bit for bit.

Format: one ``.npz`` of positionally indexed leaves, ``leaf_0`` ... in the
order of a depth-first walk (dataclass fields in declaration order, tuple
and list elements in order, dict entries by sorted key; the order of
``core/pytree.tree_leaves`` for the tensors of a family), and a structure
fingerprint.  A leaf is a tensor, or a host integer held by a state
dataclass (a class named ``...State``: counters, epochs, seed words), as a
field or inside a tuple, list or dict field (Adam's count, the averaging's
step).  Everything else is static configuration: node types, field names,
strings, floats, bools, the other integers (a target's ``dim``, a Stacked
transform's sizes), and each leaf's shape and dtype enter the fingerprint, so
a changed configuration refuses to restore.  Callables enter only as "fn":
the same program saved by one process restores in another (no pickled code).
``restore_state`` rebuilds the template's structure with the file's leaves,
each tensor on the device and in the dtype of the template's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Any, Callable, List

import numpy as np
import torch


def _is_state_class(obj: Any) -> bool:
    return type(obj).__name__.endswith("State")


def _describe_static(v) -> str:
    if isinstance(v, (str, bytes, int, float, bool, type(None))):
        return repr(v)
    if isinstance(v, type):
        return f"type:{v.__module__}.{v.__qualname__}"
    if isinstance(v, torch.dtype):
        return str(v)
    if callable(v):
        return "fn"
    return re.sub(r"0x[0-9a-f]+", "0x0", f"{type(v).__qualname__}:{v!r}")


def _walk(obj: Any, leaves: List[Any], tokens: List[str], int_leaf: bool = True) -> None:
    """Append ``obj``'s leaves and its structure's tokens, depth first."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        tokens.append(f"T{tuple(obj.shape)}:{obj.dtype}")
    elif isinstance(obj, int) and not isinstance(obj, bool) and int_leaf:
        leaves.append(obj)
        tokens.append("int")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        tokens.append(f"dc:{type(obj).__module__}.{type(obj).__qualname__}")
        counters = _is_state_class(obj)
        for f in dataclasses.fields(obj):
            tokens.append(f.name)
            _walk(getattr(obj, f.name), leaves, tokens, counters)
    elif isinstance(obj, (tuple, list)):
        tokens.append(f"{type(obj).__qualname__}({len(obj)})")
        for v in obj:
            _walk(v, leaves, tokens, int_leaf)
    elif isinstance(obj, dict):
        tokens.append(f"dict({len(obj)})")
        for k in sorted(obj, key=repr):
            tokens.append(repr(k))
            _walk(obj[k], leaves, tokens, int_leaf)
    else:
        tokens.append(_describe_static(obj))


def state_leaves(state: Any) -> List[Any]:
    """The leaves of a state in the checkpoint's order."""
    leaves: List[Any] = []
    _walk(state, leaves, [])
    return leaves


def fingerprint(state: Any) -> str:
    leaves: List[Any] = []
    tokens: List[str] = []
    _walk(state, leaves, tokens)
    return hashlib.sha256("|".join(tokens).encode()).hexdigest()[:16]


def rebuild(template: Any, new_leaf: Callable[[Any], Any], int_leaf: bool = True) -> Any:
    """The template's structure with each leaf replaced by ``new_leaf(leaf)``,
    in the walk's order."""
    if isinstance(template, torch.Tensor):
        return new_leaf(template)
    if isinstance(template, int) and not isinstance(template, bool) and int_leaf:
        return new_leaf(template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        counters = _is_state_class(template)
        return dataclasses.replace(template, **{
            f.name: rebuild(getattr(template, f.name), new_leaf, counters)
            for f in dataclasses.fields(template)})
    if isinstance(template, (tuple, list)):
        items = [rebuild(v, new_leaf, int_leaf) for v in template]
        if hasattr(template, "_fields"):  # a NamedTuple
            return type(template)(*items)
        return type(template)(items)
    if isinstance(template, dict):  # leaves by sorted key, the entries in their order
        done = {k: rebuild(template[k], new_leaf, int_leaf) for k in sorted(template, key=repr)}
        return {k: done[k] for k in template}
    return template


def _norm_path(path: str) -> str:
    # np.savez appends ".npz" to a path without it: save and restore agree
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: Any) -> None:
    """Write ``state``'s leaves and structure fingerprint to ``path`` (.npz)."""
    arrays = {}
    for i, leaf in enumerate(state_leaves(state)):
        arrays[f"leaf_{i}"] = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                               else np.asarray(leaf, dtype=np.int64))
    arrays["__fingerprint__"] = np.asarray(fingerprint(state))
    np.savez(_norm_path(path), **arrays)


def restore_state(path: str, template_state: Any) -> Any:
    """A state of ``template_state``'s structure with the leaves saved at
    ``path``, each tensor on the template's device and in its dtype."""
    with np.load(_norm_path(path), allow_pickle=False) as data:
        got, want = str(data["__fingerprint__"]), fingerprint(template_state)
        if got != want:
            raise ValueError(
                f"checkpoint structure mismatch: file={got} template={want}. "
                "Construct the template with the same algorithm/model "
                "configuration that produced the checkpoint."
            )
        arrays = iter([data[f"leaf_{i}"] for i in range(len(state_leaves(template_state)))])

    def new_leaf(leaf):
        arr = next(arrays)
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)
        return int(arr)

    return rebuild(template_state, new_leaf)
