"""Device mesh and sharded execution for VI workloads (port of
parallel/mesh.py).

Two mesh axes map the two embarrassingly parallel axes of VI:

- ``"mc"``   the Monte-Carlo sample axis: rank j of the axis draws rows
  [row0, row0 + n_j) of the (n, d) draw (the samplers' row offset, so the
  rows are bit for bit those of the one-process draw) and evaluates them;
- ``"data"`` the data axis: rank i evaluates the likelihood on its row
  block of the data (or of the step's minibatch), and the blocks' sums are
  summed over the axis (``data_psum``).

A target's data axis may be the axis that splits the estimate's terms (an
objective's ``mc_axis``, a mixture's ``ep_axis``; ``terms_split``).  Its
ranks then hold different draws, and each evaluates its own draws on every
row of the data: ``shard_axis0`` keeps the whole data and ``data_psum`` is
the identity over that axis.  That is the same work as the blocks (n_j
draws on n rows against n draws on n_j rows), the data are whole on every
rank already (a row block is a view of them), no draw and no gradient
crosses the axis, and each draw's log density has the one-process value.

Everything else (the variational parameters, the optimizer and averager
states) is replicated.  The mesh is a ``torch.distributed`` ``DeviceMesh``
of shape (n_data, n_mc) named ("data", "mc") over the default process
group (``parallel.distributed.initialize``).

Where the JAX package annotates shardings and lets GSPMD insert the
collectives, the port is explicit.  Under ``use_mesh(mesh)`` (the
counterpart of ``jax.set_mesh``) an objective takes this rank's share of the
loss, every term counted once over the mesh: its rows' mean weighted by
n_j / n, so the shares of a replicated term (the prior, the entropy) sum to
it too.  It backpropagates the share locally and then sums values and
gradients over "mc" and averages them over the other axes
(``reduce_shares``).  No collective but ``gather_share``'s runs inside the
autograd graph's backward: ``torch.distributed.nn``'s all-reduce would
all-reduce the upstream gradient there, which multiplies a replicated
parameter's gradient by the group size.  ``data_psum`` sums in the forward
only; its backward scales the gradient by the axis size, which the average
over the axis in ``reduce_shares`` undoes for the replicated terms.

A family's parameters over an axis (``tp_axis``, ``block_axis``,
``ep_axis``), where JAX annotates a layout and lets GSPMD keep the numbers,
split the work in the port: each rank forms its share (its columns of z,
its blocks, its components) and ``gather_share`` copies the shares into
the whole tensor; its backward sums the upstream gradient over the axis
and hands each rank its share (the axis size times the exact gradient,
which the average in ``reduce_shares`` makes exact, whether the computation
after the gather is replicated or takes a data block a rank).  A mixture's
components split the ELBO's terms, so ``reduce_shares`` sums over
``ep_axis`` as over "mc".

Outside a mesh, or for an axis the active mesh lacks, every helper is a
no-op (JAX's ``shard_axis0`` rule), so an object configured with
``mc_axis``, ``data_axis`` or a family axis still evaluates on one device.

Collectives run on the tensors' device.  NCCL takes CUDA tensors; gloo takes
CPU tensors, and CUDA tensors only for ``all_reduce`` and ``broadcast``: the
row gathers of gloo and CUDA tensors go through the host explicitly
(``all_gather_rows``).  Nothing computes on the host in their place.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.checkpoint import rebuild

MC_AXIS = "mc"
DATA_AXIS = "data"


def make_vi_mesh(
    n_mc: Optional[int] = None,
    n_data: int = 1,
    devices: Optional[Sequence[int]] = None,
):
    """Mesh with axes ("data", "mc") over the ranks ``devices`` (default:
    every rank of the default group, in order); by default all of them on
    "mc".  Needs an initialised process group, which may have one rank.  A
    rank's coordinates are its position in ``devices`` read row-major."""
    from torch.distributed.device_mesh import DeviceMesh

    if devices is None:
        _check_group()
        devices = range(dist.get_world_size())
    ranks = [int(r) for r in devices]
    n = len(ranks)
    if n_mc is None:
        if n % n_data != 0:
            raise ValueError(
                f"{n} devices not divisible by data axis size {n_data}"
            )
        n_mc = n // n_data
    if n_mc * n_data != n:
        raise ValueError(
            f"mesh ({n_data} x {n_mc}) != device count {n}"
        )
    _check_group()
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n_data, n_mc),
                      mesh_dim_names=(DATA_AXIS, MC_AXIS))


def _check_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "make_vi_mesh needs a process group: call "
            "parallel.distributed.initialize() first"
        )


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------

class _Axes:
    """A mesh's axes, read once (a ``DeviceMesh`` lookup costs host time
    every step): each axis's size, this rank's index on it and its group."""

    def __init__(self, mesh):
        self.names = tuple(mesh.mesh_dim_names)
        self.size = {a: mesh.size(i) for i, a in enumerate(self.names)}
        self.index = {a: mesh.get_local_rank(a) for a in self.names}
        self.group = {a: mesh.get_group(a) for a in self.names}


# the meshes of the enclosing use_mesh blocks, innermost last: process-wide,
# as jax.set_mesh's
_ACTIVE: List[_Axes] = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the block under ``mesh`` (the counterpart of ``jax.set_mesh``)."""
    _ACTIVE.append(_Axes(mesh))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def mesh_of(axis: Optional[str]) -> Optional[_Axes]:
    """The active mesh's axes if it has ``axis``, else None (the helpers'
    no-op)."""
    if axis is None or not _ACTIVE or axis not in _ACTIVE[-1].size:
        return None
    return _ACTIVE[-1]


def axis_size(axis: Optional[str]) -> int:
    axes = mesh_of(axis)
    return 1 if axes is None else axes.size[axis]


def axis_index(axis: Optional[str]) -> int:
    axes = mesh_of(axis)
    return 0 if axes is None else axes.index[axis]


def block(n: int, parts: int, i: int) -> Tuple[int, int]:
    """(first row, rows) of part i of n rows cut into ``parts``, by
    ``torch.tensor_split``'s boundaries: the first n % parts parts take one
    row more, so uneven sizes work as GSPMD's do."""
    q, r = divmod(n, parts)
    return i * q + min(i, r), q + (i < r)


def rows_of(n: int, axis: Optional[str]) -> Optional[Tuple[int, int]]:
    """(row0, rows) of this rank's block of n rows over ``axis``, or None
    outside a mesh with that axis."""
    if mesh_of(axis) is None:
        return None
    return block(n, axis_size(axis), axis_index(axis))


def mc_rows(n: int, axis: Optional[str]) -> Optional[Tuple[int, int]]:
    """``rows_of`` for n Monte-Carlo draws, None on an axis of one rank too
    (its rank holds every row, and the estimate takes the path without a
    mesh, bit for bit); raises where a rank would draw none (its share's
    mean would be empty)."""
    if axis_size(axis) == 1:
        return None
    rows = rows_of(n, axis)
    if rows is not None and rows[1] == 0:
        raise ValueError(
            f"{n} samples over the {axis!r} axis of {axis_size(axis)} ranks: "
            "every rank needs at least one"
        )
    return rows


def data_split(axis: Optional[str]) -> Optional[str]:
    """The axis over which a target's data rows split here: ``axis``, or
    None outside a mesh with that axis and while the axis splits the
    running estimate's terms (``terms_split``), where each rank evaluates
    the draws it holds on every row."""
    if mesh_of(axis) is None or axis in _SPLIT:
        return None
    return axis


def shard_axis0(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """This rank's row block of axis 0 of a target's data ``x`` over the data
    axis ``axis`` (a view); ``x`` where ``data_split`` finds no split."""
    rows = rows_of(x.shape[0], data_split(axis))
    if rows is None:
        return x
    return x.narrow(0, rows[0], rows[1])


def own(axis: Optional[str]) -> bool:
    """Whether this rank is the first of ``axis`` (always, outside a mesh):
    the rank that carries a replicated value into a sum over the axis."""
    return axis_index(axis) == 0


# ---------------------------------------------------------------------------
# Collectives (values only: none but gather_share's runs in a backward)
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, axes: _Axes, axis: str, op) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=axes.group[axis])
    return t


def psum(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (a new tensor, no gradient path); ``x``
    outside a mesh with that axis."""
    axes = mesh_of(axis)
    if axes is None:
        return x
    return _all_reduce(x.detach().clone(), axes, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """Elementwise maximum of ``x`` over ``axis`` (no gradient path)."""
    axes = mesh_of(axis)
    if axes is None:
        return x
    return _all_reduce(x.detach().clone(), axes, axis, dist.ReduceOp.MAX)


class _DataPsum(torch.autograd.Function):
    """Forward: the sum over the axis.  Backward: the upstream gradient (the
    same on every rank of the axis, whose computation after the sum is
    replicated) times the axis size, with no collective."""

    @staticmethod
    def forward(ctx, x, axes, axis):
        ctx.size = axes.size[axis]
        return _all_reduce(x.detach().clone(), axes, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.size == 1 else g * ctx.size), None, None


# the axes whose ranks evaluate different terms of the running estimate
# (``terms_split``)
_SPLIT: List[Optional[str]] = []


@contextlib.contextmanager
def terms_split(axis: Optional[str]):
    """While the body runs, the ranks of ``axis`` evaluate different terms
    of the estimate (the draws' rows over an objective's ``mc_axis``, a
    mixture's components over ``ep_axis``): a target whose data axis is
    that same axis evaluates each rank's draws on every row of its data
    (``data_split``)."""
    _SPLIT.append(axis)
    try:
        yield
    finally:
        _SPLIT.pop()


def data_psum(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """Sum over the data axis of a partial log-likelihood (one value a
    draw): every rank gets the full sum, and the gradient reaches this
    rank's block scaled by the axis size; ``reduce_shares``' average over
    the axis makes the gradient the sum of the blocks'.  ``x`` where
    ``data_split`` finds no split (outside a mesh with that axis, and over
    an axis that splits the estimate's terms, whose ranks evaluated their
    own draws on every row)."""
    axes = mesh_of(data_split(axis))
    if axes is None:
        return x
    return _DataPsum.apply(x, axes, axis)


def _reduce_flat(tensors: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    """``fn`` of one flat buffer a dtype and device (one collective each),
    split back into the tensors' shapes."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = fn(torch.cat([tensors[i].detach().reshape(-1) for i in idx]))
        at = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = flat[at:at + k].view(tensors[i].shape)
            at += k
    return out


def reduce_shares(tensors: Sequence[torch.Tensor], mc_axis: Optional[str],
                  sum_mc: bool = True) -> List[torch.Tensor]:
    """Each rank's shares (values and gradients) summed over ``mc_axis``
    (the axis that splits the estimate's terms: the draws, or a mixture's
    components under ``MixtureELBO(ep_axis=)``) and averaged over every
    other axis of the active mesh: over the axes
    that do not split the draws, the ranks hold the same value (or, under
    ``data_psum``, the data blocks' gradients scaled by the axis size).
    ``sum_mc=False`` takes the average alone (per-draw values of this
    rank's rows).  The tensors as they are outside a mesh."""
    if not _ACTIVE or not tensors:
        return list(tensors)
    axes = _ACTIVE[-1]
    sharded = mc_axis if mc_axis in axes.size else None
    names = [n for n in axes.names if sum_mc or n != sharded]
    other = 1
    for name in names:
        if name != sharded:
            other *= axes.size[name]

    def reduce(flat):
        flat = flat.clone()
        for name in names:
            _all_reduce(flat, axes, name, dist.ReduceOp.SUM)
        return flat if other == 1 else flat / other

    return _reduce_flat(tensors, reduce)


def reduce_tree(obj, info: dict, mc_axis: Optional[str]):
    """``reduce_shares`` of a family-shaped gradient's leaves and of the
    0-dim tensor entries of ``info``; (gradient, info) as they are outside
    a mesh."""
    if not _ACTIVE:
        return obj, info
    from ..core.pytree import tree_leaves, tree_map

    keys = [k for k, v in info.items() if isinstance(v, torch.Tensor) and v.dim() == 0]
    leaves = tree_leaves(obj)
    out = reduce_shares(leaves + [info[k] for k in keys], mc_axis)
    it = iter(out[:len(leaves)])
    return tree_map(lambda _: next(it), obj), {**info, **dict(zip(keys, out[len(leaves):]))}


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


def all_gather_rows(x: torch.Tensor, n: int, axis: Optional[str], dim: int = 0) -> torch.Tensor:
    """Every rank's block of the n rows along ``dim`` (its ``block`` over
    ``axis``), concatenated in the axis's order: each element is copied, not
    summed, so the bits (-0.0 too) are the ranks' own.  Gloo gathers no CUDA
    tensor, so there the blocks go through the host and back.  ``x``
    outside a mesh with that axis."""
    axes = mesh_of(axis)
    if axes is None:
        return x
    group, parts = axes.group[axis], axes.size[axis]
    sizes = [block(n, parts, i)[1] for i in range(parts)]
    width = max(sizes)
    src = x.movedim(dim, 0)
    host = _gloo_cuda(src, group)
    if host:  # gloo has no CUDA all_gather: through the host, explicitly
        src = src.cpu()
    pad = src.new_zeros((width,) + tuple(src.shape[1:]))
    pad[:src.shape[0]] = src
    bufs = [torch.empty_like(pad) for _ in range(parts)]
    dist.all_gather(bufs, pad.contiguous(), group=group)
    out = torch.cat([b[:k] for b, k in zip(bufs, sizes)], dim=0)
    if host:
        out = out.to(x.device)
    return out.movedim(0, dim)


class _GatherShare(torch.autograd.Function):
    """Forward: every rank's block along ``dim``, gathered (exact copies).
    Backward: this rank's block of the upstream gradient summed over the
    axis (a reduce-scatter).  Where the computation after the gather is
    replicated that is the block times the axis size; where it is not (a
    target whose data axis is this axis: rank r's upstream gradient is the
    replicated terms' plus its data block's times the axis size) the sum
    still holds every rank's part."""

    @staticmethod
    def forward(ctx, x, n, axes, axis, dim):
        ctx.span, ctx.axes, ctx.axis, ctx.dim = rows_of(n, axis), axes, axis, dim
        # contiguous: what follows sees the layout it sees outside a mesh
        return all_gather_rows(x.detach(), n, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.axes.size[ctx.axis] > 1:
            g = _all_reduce(g.contiguous().clone(), ctx.axes, ctx.axis, dist.ReduceOp.SUM)
        return g.narrow(ctx.dim, *ctx.span), None, None, None, None


def gather_share(x: torch.Tensor, n: int, axis: Optional[str], dim: int = 0) -> torch.Tensor:
    """The whole tensor from each rank's share along ``dim``: this rank holds
    its ``block`` of the n columns (of a family's output columns, blocks or
    components) over ``axis``.  The gradient reaches the share summed over
    the axis's ranks (the axis size times the exact gradient), which
    ``reduce_shares``' average over the axis makes exact: each rank's
    parameters outside its share get none.  ``x``
    outside a mesh with that axis."""
    axes = mesh_of(axis)
    if axes is None:
        return x
    return _GatherShare.apply(x, n, axes, axis, dim)


# ---------------------------------------------------------------------------
# Replicated state
# ---------------------------------------------------------------------------


def replicate_state(state, mesh):
    """The state with every tensor broadcast from the mesh's first rank
    (along "mc" within each "data" row, then along "data"), so every rank
    starts from the same bits.  Each tensor keeps its layout (a transposed
    factor stays transposed: a product reads it as it would without the
    mesh, and sums in the same order)."""
    groups = [mesh.get_group(name) for name in reversed(mesh.mesh_dim_names)]

    def bcast(t: torch.Tensor) -> torch.Tensor:
        buf = t.detach().clone()  # the same strides where t is dense
        wire = buf.contiguous()
        if wire.dtype == torch.bool:
            wire = wire.view(torch.uint8)
        for group in groups:
            dist.broadcast(wire, src=dist.get_global_rank(group, 0), group=group)
        if wire.data_ptr() != buf.data_ptr():
            buf.copy_(wire.view(buf.dtype))
        return buf

    return rebuild(state, lambda t: bcast(t) if isinstance(t, torch.Tensor) else t,
                   int_leaf=False)
