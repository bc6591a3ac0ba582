"""K5: the AD-derived model body of the fused engines, generated as CUDA.

Port of ops/pallas/fused_advi.py::_ad_step_factory (:1504), the body of the
spec ``ad_spec`` builds (:1548).  The JAX engine traces
``vmap(value_and_grad(log_density))`` inside its Pallas kernel.  Here the
target's value and gradient at the engine's static (n, d) sample block are
traced once on the host into an aten graph: ``make_fx`` (fake tensors, so
data-dependent control flow is refused) of ``torch.func.grad_and_value`` of
the SUMMED log density.  The targets are batched over leading dimensions and
rows are independent, so the gradient of the row sum is each row's
gradient.  The graph is

- checked: every op must be on ``ALLOWED`` (elementwise math, sums, mm/mv,
  views, cat and the slice/select backwards), every value float32 or bool;
  anything else raises ``ValueError`` naming it, as the JAX engine fails at
  lowering (:1555-1557), not silently;
- packed: its tensor constants (the target's leaves, which ``make_fx`` lifts
  to ``_tensor_constant*`` attributes) go into one float32 buffer ``cf`` and
  one int32 buffer ``ci``; bool and complex leaves raise, float64 leaves are
  cast to float32 (the engines are float32) and the graph traced again;
- planned and emitted as ONE ``__device__ __forceinline__`` function,
  ``avi::ad::ad_body(cf, ci, zs, n, d, logpi, gs, scratch, tid)``, that the
  mean-field, full-rank and chains kernels call in their model phase
  (csrc/fused_meanfield_body.cuh, csrc/fused_advi_fullrank.cu, under
  ``AVI_AD_BODY``; ``_build.build_generated`` compiles it).

The emitted body: one strided loop over the block's THREADS threads for each
node that needs storage, every shape and stride a literal.  Views (slice,
select, permute, t, expand, unsqueeze, squeeze, view) are strided aliases of
their base, from the fake tensor's strides and storage offset, never copies
(a reshape that cannot be one is the graph's own ``clone``).
A pointwise or gather node read once, by a pointwise node of its shape, a
sum or a gather, is inlined into that consumer's expression; a pointwise
node of at most REMAT_OPS ops (or of the constants alone) read by several
is recomputed at each read (the same ops, so the same bits).  A node read
through a view or by a product keeps its storage.  ``ones_like``,
``new_zeros`` and ``scalar_tensor`` are literals (so is ``_to_copy`` of a
Python number, rewritten as its ``scalar_tensor``), and pointwise nodes of
literals fold on the host with torch's own op.  ``mm`` and ``mv`` are one
call of the block product (csrc/block_mm.cuh) with the operands' literal
shapes and strides: register tiles, k split over lanes (``_tile``: the hand
logreg body's tiles at the flagship), float4 loads where an operand's
k-stride is 1 and its rows 16-byte aligned; a stored (R, C) node that feeds
a product four k at a time gets rows of round4(C) floats.  ``sum`` is one
reduction for each output element (a warp's, over 32 terms or more).
``cat``, ``slice_backward`` and ``select_backward`` read the element or give
0.  The arithmetic rounds as torch's ops do: ``__fadd_rn`` and
``__fmul_rn``, so no two ops contract into an FMA; ``logf``, ``expf`` and
``log1pf`` without fast math; ``sgn(0) = sgn(NaN) = 0`` and ``clamp_min``
keeps a NaN, as torch.

Barriers come from a model of every access: for each loop, which thread
reads and writes which element of which storage (a pointwise loop's element
e on thread e, or, for at most WARPS elements, on lane 0 of warp e; a warp
reduction's terms on its lanes; the block product's tiles as
csrc/block_mm.cuh maps them).  A loop needs no ``__syncthreads()`` before it
when nothing it touches was written since the last barrier by another
thread, and nothing it writes was read there by another thread; such loops
of one shape run as one loop.  The intermediates live in the body's scratch,
first fit at 16-byte offsets, a node's floats handed to another only across
a barrier after their last read: ``scratch`` floats in all.  The scratch
base is a generic pointer, 16-byte aligned: the block's shared memory where
it fits beside the engine's arrays, else the launch's device workspace (the
kernels' tiered layouts); the loops, the barriers and the race model are the
same on either, and so are the bits.
``race_check`` runs the same model over the finished plan with the scratch
offsets and asserts that no element is shared between threads with no
barrier between them; ``emit`` runs it on every body.  The float constants
are read from device memory, or, in a ``staged`` program, from a copy that
``ad_stage`` puts in shared memory once a launch (``fused_advi.ad_program``
stages them where they fit beside the engine's arrays).

What bounds it on an H100: latency, as the hand bodies.  At the flagship
(n = 10, d = 62, 208 x 61 design) the graph's two products are 2 x 126,880
multiply-adds a step, a few microseconds of one SM through the block
product; the body's sequential depth is its loops and its barriers (5).

``replay`` runs the same graph on tensors, its constants bound to their
slots of the packed buffers: it is the kernel's plain version, which the
CPU runs and the card's checks compare against.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

aten = torch.ops.aten
THREADS = 512  # the fused kernels' block (csrc kThreads)

POINTWISE = {
    aten.add.Tensor, aten.add.Scalar, aten.sub.Tensor, aten.mul.Tensor, aten.mul.Scalar,
    aten.div.Tensor, aten.neg.default, aten.exp.default, aten.log.default, aten.log1p.default,
    aten.abs.default, aten.sgn.default, aten.clamp_min.default, aten.ge.Scalar,
    aten.where.self, aten.pow.Tensor_Scalar, aten.clone.default,
}
LITERALS = {aten.ones_like.default, aten.new_zeros.default, aten.scalar_tensor.default}
VIEWS = {
    aten.slice.Tensor, aten.select.int, aten.permute.default, aten.t.default,
    aten.expand.default, aten.unsqueeze.default, aten.squeeze.default, aten.squeeze.dim,
    aten.squeeze.dims, aten.view.default, aten._unsafe_view.default,
}
GATHERS = {aten.cat.default, aten.slice_backward.default, aten.select_backward.default}
REDUCTIONS = {aten.sum.default, aten.sum.dim_IntList}
PRODUCTS = {aten.mm.default, aten.mv.default}
ALLOWED = POINTWISE | LITERALS | VIEWS | GATHERS | REDUCTIONS | PRODUCTS

# storages a body reads and writes besides its scratch
ZS, CF, CI, GS, LOGPI = "zs", "cf", "ci", "gs", "logpi"


def _op_name(target) -> str:
    return str(target).replace("aten.", "", 1)


# ---------------------------------------------------------------------------
# Trace, check and pack
# ---------------------------------------------------------------------------


def _fake_trace(fn: Callable, z: torch.Tensor) -> torch.fx.GraphModule:
    return make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(z)


# traces made by this process (utils/profiling.retrace_guard counts them)
TRACES = [0]


def trace(log_density: Callable, n: int, d: int, device) -> torch.fx.GraphModule:
    """The aten graph of ``z -> (grad, (sum, log pi))`` of ``log_density``
    at a float32 (n, d) block, its constants float32 or integer and
    contiguous.  Raises ValueError where ``make_fx`` cannot trace it
    (data-dependent control flow) or a constant is bool or complex."""
    TRACES[0] += 1

    def summed(z):
        lp = log_density(z)
        return lp.sum(), lp

    z = torch.zeros(n, d, dtype=torch.float32, device=device)
    try:
        gm = _fake_trace(torch.func.grad_and_value(summed, has_aux=True), z)
    except Exception as e:  # noqa: BLE001 - the tracer's own errors, renamed
        raise ValueError(
            f"K5 cannot trace the target's log density at ({n}, {d}) (data-dependent "
            f"control flow or an untraceable op): {type(e).__name__}: {e}"
        ) from e
    changed = False
    for name in _constant_names(gm):
        t = getattr(gm, name)
        if t.dtype == torch.bool or t.is_complex():
            raise ValueError(
                f"the target has a {t.dtype} leaf ({tuple(t.shape)}); only float and "
                "integer tensors can be the kernel's constants: cast it in the target"
            )
        new = t.to(torch.float32) if t.is_floating_point() and t.dtype != torch.float32 else t
        new = new.contiguous()
        if new is not t:
            setattr(gm, name, new)
            changed = True
    if changed:  # float64 leaves cast, strided leaves copied: trace the graph again
        gm = _fake_trace(gm, z)
    _literal_copies(gm)
    return gm


def _literal_copies(gm: torch.fx.GraphModule) -> None:
    """Rewrite ``_to_copy`` of a Python number as the ``scalar_tensor`` of
    that number, the same value and dtype.  ``torch.func.vmap`` (the replay
    of an ingested model, ppl/model.py) wraps each Python scalar that meets
    a batched 0-dim value this way; the node is a literal."""
    for node in list(gm.graph.nodes):
        if node.op != "call_function" or node.target != aten._to_copy.default:
            continue
        if len(node.args) != 1 or not isinstance(node.args[0], (int, float)) \
                or set(node.kwargs) - {"dtype", "layout", "device"}:
            continue
        val = node.meta["val"]
        with gm.graph.inserting_before(node):
            lit = gm.graph.call_function(
                aten.scalar_tensor.default, (node.args[0],),
                {"dtype": val.dtype, "layout": torch.strided, "device": val.device})
        lit.meta.update(node.meta)
        node.replace_all_uses_with(lit)
        gm.graph.erase_node(node)
    gm.recompile()


def _constant_names(gm: torch.fx.GraphModule) -> List[str]:
    names: List[str] = []
    for node in gm.graph.nodes:
        if node.op == "get_attr" and node.target not in names:
            names.append(node.target)
    return names


def check_graph(gm: torch.fx.GraphModule, n: int, d: int) -> None:
    """Raise ValueError for an op off ``ALLOWED`` (naming it), a value that
    is not float32 or bool, or outputs not of shapes (n, d) and (n,)."""
    for node in gm.graph.nodes:
        if node.op == "call_function":
            if node.target not in ALLOWED:
                raise ValueError(
                    f"op {_op_name(node.target)} (node {node.name}) is not on K5's list "
                    f"of ops: {sorted(_op_name(t) for t in ALLOWED)}"
                )
            val = node.meta.get("val")
            if not isinstance(val, torch.Tensor) or val.dtype not in (torch.float32, torch.bool):
                raise ValueError(
                    f"node {node.name} ({_op_name(node.target)}) gives "
                    f"{getattr(val, 'dtype', type(val).__name__)}; K5 computes in float32"
                )
        elif node.op not in ("placeholder", "get_attr", "output"):
            raise ValueError(f"K5 cannot run graph node {node.name} ({node.op})")
    grad, lp = _outputs(gm)
    if tuple(grad.meta["val"].shape) != (n, d) or tuple(lp.meta["val"].shape) != (n,):
        raise ValueError(
            f"the target's log density must map (n, d) samples to (n,) values; at "
            f"({n}, {d}) it gives {tuple(lp.meta['val'].shape)}"
        )


def _outputs(gm: torch.fx.GraphModule):
    out = next(node for node in gm.graph.nodes if node.op == "output")
    grad, (_, lp) = out.args[0]
    return grad, lp


@dataclass(frozen=True)
class Packing:
    """The graph's constants in the kernel's two buffers: ``slots[name] =
    (buffer, offset, dtype traced)``, buffer ``"cf"`` (float32) or ``"ci"``
    (int32)."""

    cf: torch.Tensor
    ci: torch.Tensor
    slots: Dict[str, Tuple[str, int, torch.dtype]]


def pack(gm: torch.fx.GraphModule, device) -> Packing:
    floats, ints, slots = [], [], {}
    fo = io = 0
    for name in _constant_names(gm):
        t = getattr(gm, name).to(device)
        if t.is_floating_point():
            slots[name] = (CF, fo, t.dtype)
            floats.append(t.reshape(-1))
            fo += t.numel()
        else:
            big = int(t.abs().max()) if t.numel() else 0
            if big >= 2 ** 31:
                raise ValueError(f"an integer leaf holds {big}, beyond int32")
            slots[name] = (CI, io, t.dtype)
            ints.append(t.reshape(-1).to(torch.int32))
            io += t.numel()
    # one element at least, so every buffer has an address to hand the kernel
    cf = torch.cat(floats + [torch.zeros(1, device=device)]).contiguous()
    ci = torch.cat(ints + [torch.zeros(1, dtype=torch.int32, device=device)]).contiguous()
    return Packing(cf=cf, ci=ci, slots=slots)


# ---------------------------------------------------------------------------
# Replay: the plain version
# ---------------------------------------------------------------------------


def bind(gm: torch.fx.GraphModule, packing: Packing) -> None:
    """Point the graph's constants at their slots of the packed buffers, so
    the replay reads what the kernel reads."""
    for name, (buf, off, dtype) in packing.slots.items():
        shape = getattr(gm, name).shape
        size = int(np.prod(shape))
        src = packing.cf if buf == CF else packing.ci
        setattr(gm, name, src[off:off + size].reshape(shape).to(dtype))


def replay(gm: torch.fx.GraphModule, z: torch.Tensor):
    """(log pi (n,), grad (n, d)) of the graph at ``z``: the body's plain
    version, on the device the graph was traced for."""
    grad, (_, lp) = gm(z)
    return lp, grad


# ---------------------------------------------------------------------------
# Plan and emit
# ---------------------------------------------------------------------------

WARPS = THREADS // 32
REMAT_OPS = 4  # a pointwise node of at most this many ops is recomputed where it is read


@dataclass
class _Mem:
    """A strided window of a storage: ZS, CF, CI, GS, LOGPI or a node's."""

    store: Any
    offset: int
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]


@dataclass
class _Lit:
    value: float
    shape: Tuple[int, ...]


@dataclass
class _Inl:
    """A pointwise or gather node computed inside its consumers' expressions."""

    node: Any
    shape: Tuple[int, ...]


class _Ix:
    """An index of the emitted C: a loop variable (or the literal 0) through
    subtractions and divisions; printed for the source, evaluated on numpy
    arrays for the race model (where an index is negative its read sits
    under a false condition)."""

    __slots__ = ("name", "ops")

    def __init__(self, name: Optional[str] = None, ops: Tuple = ()):
        self.name, self.ops = name, ops

    def sub(self, c: int) -> "_Ix":
        return self if c == 0 or self.name is None else _Ix(self.name, self.ops + (("-", c),))

    def div(self, c: int) -> "_Ix":
        return self if c == 1 or self.name is None else _Ix(self.name, self.ops + (("/", c),))

    def __str__(self) -> str:
        if self.name is None:
            return "0"
        s = self.name
        for op, c in self.ops:
            s = f"({s} {op} {c})"
        return s

    def eval(self, env):
        if self.name is None:
            return 0
        v = env[self.name]
        for op, c in self.ops:
            v = v - c if op == "-" else v // c
        return v


ZERO = _Ix()


@dataclass
class _Acc:
    """One memory access of a loop: ``ref`` at the index ``idx``, where every
    condition (index, lo, hi, step) holds."""

    ref: _Mem
    idx: List[_Ix]
    conds: Tuple


def _lit(v: float) -> str:
    f = np.float32(v)
    if not np.isfinite(f):
        return f"__int_as_float(0x{int(f.view(np.uint32)):08x})"
    return f"{float(f)!r}f"


def _shape(node) -> Tuple[int, ...]:
    return tuple(int(s) for s in node.meta["val"].shape)


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _dense(shape, strides) -> bool:
    """Non-overlapping and dense: the strides sorted are a contiguous layout."""
    dims = sorted((st, sz) for sz, st in zip(shape, strides) if sz != 1)
    expect = 1
    for st, sz in dims:
        if st != expect:
            return False
        expect *= sz
    return True


def _unravel(var: str, shape, names) -> List[str]:
    """Lines binding ``names[k]`` to the row-major index of ``var`` over
    ``shape`` (dims of size 1 are the literal 0)."""
    lines, rem = [], var
    live = [k for k, s in enumerate(shape) if s != 1]
    for pos, k in enumerate(reversed(live)):
        if pos == len(live) - 1:
            lines.append(f"const int {names[k]} = {rem};")
        else:
            tmp = f"{names[k]}_r"
            lines.append(f"const int {names[k]} = {rem} % {shape[k]};")
            lines.append(f"const int {tmp} = {rem} / {shape[k]};")
            rem = tmp
    return lines


def _bind(env: Dict[str, np.ndarray], flat: np.ndarray, shape, names) -> None:
    """The race model's twin of ``_unravel``: ``names[k]`` over ``flat``."""
    live = [k for k, s in enumerate(shape) if s != 1]
    if not live:
        return
    coords = np.unravel_index(flat, tuple(shape[k] for k in live))
    for k, c in zip(live, coords):
        env[names[k]] = c


def _idx(names, shape) -> List[_Ix]:
    return [_Ix(nm) if s != 1 else ZERO for nm, s in zip(names, shape)]


def _tile(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """block_mm's tile of an (M, N, K) product: (rows, columns) a thread and
    one lane a sum, k in order, so that every output is the fmaf chain
    k = 0, 1, ... of the per-element loops K5 emitted before the block
    product (the same bits: the logreg graph's softplus has a kink at a
    logit of exactly 0, where another order can move a run).  Of the tiles
    up to 10 x 4, the one with the least shared-memory traffic, (rows +
    columns) / (rows x columns) words a multiply-add, counted as slower by
    the warps it leaves short of six, and at most 10 sums a thread (the
    fused kernels' registers); the flagship's logits (10, 208, 61) take
    (5, 2) and its gradient (10, 61, 208) (2, 2).  This cost model has not
    been timed against other tiles of K5 (PERF.md section 7), and a sweep
    of the hand body's tiles found latency, not bandwidth, setting them."""
    best, cost = (1, 1, 1), None
    for tm in (1, 2, 5, 10):
        for tn in (1, 2, 4):
            if tm > M or tn > N or tm * tn > 10:  # at most 10 sums in registers
                continue
            tasks = -(-M // tm) * -(-N // tn)
            warps = -(-min(tasks, THREADS) // 32)
            c = (tm + tn) / (tm * tn) * -(-tasks // THREADS) / min(1.0, warps / 6)
            if cost is None or c < cost - 1e-12:
                best, cost = (tm, tn, 1), c
    return best


@dataclass
class _Loop:
    """One loop of the body: its kind, iteration space, the storage it
    writes and its accesses (for the barrier planner and the race model)."""

    out: Any             # the storage written: a node, GS or LOGPI
    kind: str            # "pw", "warpred", "threadred", "mm"
    space: Tuple         # pw: shape; red: (kept shape, reduced shape); mm: (M, N, K)
    write: Optional[_Acc]
    reads: List[_Acc]
    lines: List[str]     # pw: the statements inside the loop; else the whole loop
    mm: Optional[Dict[str, Any]] = None
    map: str = "flat"    # pw: "flat" (element e on thread e) or "warp" (lane 0 of warp e)


class _Planner:
    def __init__(self, gm: torch.fx.GraphModule, packing: Packing, n: int, d: int,
                 staged: bool = False):
        self.gm, self.packing, self.n, self.d = gm, packing, n, d
        self.staged = staged
        self.refs: Dict[Any, Any] = {}
        self.kind: Dict[Any, str] = {}
        self.loops: List[_Loop] = []
        self.inlined: set = set()
        self.placed: Dict[Any, str] = {}  # output nodes computed straight into GS, LOGPI
        self.extent: Dict[Any, int] = {}  # floats of a node's storage (padded rows)
        self._conds: List[Tuple] = []
        self._acc: Optional[List[_Acc]] = None
        self.madds = 0

    # -- refs --------------------------------------------------------------

    def arg_ref(self, a, shape=()):
        if isinstance(a, torch.fx.Node):
            return self.refs[a]
        return _Lit(float(a), shape)

    def fold(self, node) -> Optional[_Lit]:
        """A pointwise node whose tensor operands are all literals, computed
        on the host with torch's own op (in float32)."""
        args = []
        for a in node.args:
            if isinstance(a, torch.fx.Node):
                ref = self.refs[a]
                if not isinstance(ref, _Lit):
                    return None
                args.append(torch.tensor(ref.value, dtype=a.meta["val"].dtype))
            else:
                args.append(a)
        return _Lit(float(node.target(*args, **node.kwargs)), _shape(node))

    def classify(self):
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.refs[node] = _Mem(ZS, 0, (self.n, self.d), (self.d, 1))
            elif node.op == "get_attr":
                buf, off, _ = self.packing.slots[node.target]
                val = node.meta["val"]
                self.refs[node] = _Mem(buf, off, tuple(val.shape), tuple(val.stride()))
            elif node.op == "call_function":
                t = node.target
                shape = _shape(node)
                if t in LITERALS:
                    v = {aten.ones_like.default: 1.0, aten.new_zeros.default: 0.0}.get(t)
                    self.refs[node] = _Lit(float(node.args[0]) if v is None else v, shape)
                elif t in VIEWS:
                    src = self.refs[node.args[0]]
                    if isinstance(src, _Lit):
                        self.refs[node] = _Lit(src.value, shape)
                    else:
                        base = self._root_offset(node.args[0])
                        val = node.meta["val"]
                        self.refs[node] = _Mem(src.store, base + int(val.storage_offset()),
                                               shape, tuple(val.stride()))
                else:
                    lit = self.fold(node) if t in POINTWISE else None
                    if lit is not None:
                        self.refs[node] = lit
                    else:
                        self.kind[node] = ("pw" if t in POINTWISE else "red" if t in REDUCTIONS
                                           else "mm" if t in PRODUCTS else "gather")
                        val = node.meta["val"]
                        if not _dense(shape, tuple(val.stride())):
                            raise ValueError(f"node {node.name}: a non-dense result layout")
                        self.refs[node] = _Mem(node, 0, shape, tuple(val.stride()))

    def _root_offset(self, node) -> int:
        """The element offset of the root storage a view's storage offset is
        counted from: a constant's slot in its buffer, else 0."""
        while node.op == "call_function" and node.target in VIEWS:
            node = node.args[0]
        if node.op == "get_attr":
            return self.packing.slots[node.target][1]
        return 0

    # -- liveness and inlining ------------------------------------------------

    def live_nodes(self, outs) -> set:
        live, todo = set(), list(outs)
        while todo:
            node = todo.pop()
            if node in live or isinstance(self.refs.get(node), _Lit):
                continue
            live.add(node)
            todo.extend(a for a in node.all_input_nodes)
        return live

    def _stored_inputs(self, node) -> set:
        """The storages an expression of ``node`` reads (through inlined nodes)."""
        out = set()
        for a in node.all_input_nodes:
            ref = self.refs.get(a)
            if isinstance(ref, _Inl):
                out |= self._stored_inputs(a)
            elif isinstance(ref, _Mem):
                out.add(ref.store)
        return out

    def choose_inlined(self, live, outs):
        """Nodes computed inside their consumers' expressions, never stored:
        a pointwise or gather node read by one pointwise node of its shape, a
        sum or a gather; and a pointwise node of at most REMAT_OPS ops (or of
        the constants alone) read by several, recomputed at each read (the
        same ops, so the same bits).  A node read through a view or by a
        product keeps its storage."""
        uses: Dict[Any, List[Any]] = {}
        for node in live:
            for a in node.args:
                for x in (a if isinstance(a, (list, tuple)) else (a,)):
                    if isinstance(x, torch.fx.Node) and x in live:
                        uses.setdefault(x, []).append(node)
        cost: Dict[Any, int] = {}
        for node in self.gm.graph.nodes:
            kind = self.kind.get(node)
            if node not in live or kind not in ("pw", "gather") or node in outs:
                continue
            users = uses.get(node, [])
            ukinds = [self.kind.get(u) for u in users]
            if not users or any(k not in ("pw", "red", "gather") for k in ukinds):
                continue
            c = 1 + sum(cost.get(a, 0) for a in node.all_input_nodes if a in self.inlined)
            same = all(k != "pw" or _shape(u) == _shape(node) for u, k in zip(users, ukinds))
            const = kind == "pw" and not (self._stored_inputs(node) - {CF, CI})
            if kind == "gather":
                ok = len(users) == 1 and same
            else:
                ok = (len(users) == 1 and same) or c <= REMAT_OPS or (const and c <= 2 * REMAT_OPS)
            if ok:
                self.inlined.add(node)
                self.refs[node] = _Inl(node, _shape(node))
                cost[node] = c

    def pad_operands(self, live):
        """Give a stored (R, C) node whose rows feed a product four k at a
        time (k-stride 1) rows of round4(C) floats, so block_mm reads them as
        float4s, where every view of the node stays a strided window."""
        for node in self.gm.graph.nodes:
            if node not in live or self.kind.get(node) != "mm":
                continue
            A = self.refs[node.args[0]]
            if not isinstance(A, _Mem) or not isinstance(A.store, torch.fx.Node):
                continue
            base = A.store
            own = self.refs[base]
            if (base in self.placed or base in self.extent or len(own.shape) != 2
                    or own.strides != (own.shape[1], 1) or own.shape[1] % 4 == 0
                    or A.strides[-1] != 1):
                continue
            R, C = own.shape
            P = -(-C // 4) * 4
            views = [k for k, r in self.refs.items() if isinstance(r, _Mem) and r.store is base]
            new = {k: self._remap(self.refs[k], C, P) for k in views}
            if any(v is None for v in new.values()):
                continue
            self.refs.update(new)
            self.extent[base] = R * P

    @staticmethod
    def _remap(ref: _Mem, C: int, P: int) -> Optional[_Mem]:
        """``ref`` of a row-major (R, C) storage re-laid with rows of P
        floats, or None where a stride mixes rows and columns."""
        strides, reach = [], ref.offset % C
        for sz, st in zip(ref.shape, ref.strides):
            if sz == 1 or st == 0:
                strides.append(st)
            elif st % C == 0:
                strides.append(st // C * P)
            elif st < C:
                strides.append(st)
                reach += st * (sz - 1)
            else:
                return None
        if reach >= C:
            return None
        return _Mem(ref.store, ref.offset // C * P + ref.offset % C, ref.shape, tuple(strides))

    # -- expressions ------------------------------------------------------------

    def expr(self, ref, idx: List[_Ix]) -> str:
        """C expression of ``ref`` at the index ``idx`` of an iteration space
        of rank len(idx), ``ref`` broadcast against it from the right; its
        reads are recorded in ``self._acc``."""
        if isinstance(ref, _Lit):
            return _lit(ref.value)
        if isinstance(ref, _Inl):
            return (self.pw_expr if self.kind[ref.node] == "pw" else self.gather_expr)(
                ref.node, idx)
        lead = len(idx) - len(ref.shape)
        sub = idx[lead:]
        self._acc.append(_Acc(ref, list(sub), tuple(self._conds)))
        addr = self.addr(ref, sub)
        store = self.placed.get(ref.store, ref.store)
        if store == CI:
            return f"static_cast<float>(ci[{addr}])"
        if store == CF:
            return f"{'cs' if self.staged else 'cf'}[{addr}]"
        if store in (ZS, GS, LOGPI):
            return f"{store}[{addr}]"
        return f"s[{{OFF:{store.name}}} + {addr}]"

    @staticmethod
    def addr(ref: _Mem, idx: List[_Ix]) -> str:
        terms = [str(ref.offset)] if ref.offset else []
        for ix, sz, st in zip(idx, ref.shape, ref.strides):
            if sz != 1 and st != 0 and ix.name is not None:
                terms.append(str(ix) if st == 1 else f"{ix} * {st}")
        return " + ".join(terms) or "0"

    def pw_expr(self, node, idx) -> str:
        t = node.target
        shape = _shape(node)
        a = [self.expr(self.arg_ref(x, shape), idx) if isinstance(x, torch.fx.Node)
             else _lit(float(x)) for x in node.args]
        alpha = node.kwargs.get("alpha", 1)
        if t in (aten.add.Tensor, aten.add.Scalar):
            return f"__fadd_rn({a[0]}, {a[1]})" if alpha == 1 else \
                f"fmaf({_lit(alpha)}, {a[1]}, {a[0]})"
        if t == aten.sub.Tensor:
            return f"__fsub_rn({a[0]}, {a[1]})" if alpha == 1 else \
                f"fmaf({_lit(-alpha)}, {a[1]}, {a[0]})"
        if t in (aten.mul.Tensor, aten.mul.Scalar):
            return f"__fmul_rn({a[0]}, {a[1]})"
        if t == aten.div.Tensor:
            if node.kwargs.get("rounding_mode") is not None:
                raise ValueError(f"node {node.name}: div with a rounding mode")
            return f"__fdiv_rn({a[0]}, {a[1]})"
        if t == aten.neg.default:
            return f"(-{a[0]})"
        if t == aten.clone.default:  # reshape of a strided view: a copy
            return a[0]
        unary = {aten.exp.default: "expf", aten.log.default: "logf",
                 aten.log1p.default: "log1pf", aten.abs.default: "fabsf",
                 aten.sgn.default: "sgn_"}
        if t in unary:
            return f"{unary[t]}({a[0]})"
        if t == aten.clamp_min.default:
            return f"clamp_min_({a[0]}, {a[1]})"
        if t == aten.ge.Scalar:
            return f"({a[0]} >= {a[1]} ? 1.0f : 0.0f)"
        if t == aten.where.self:
            return f"({a[0]} != 0.0f ? {a[1]} : {a[2]})"
        if t == aten.pow.Tensor_Scalar:
            p, x = float(node.args[1]), a[0]
            return {2.0: f"__fmul_rn({x}, {x})", 3.0: f"__fmul_rn(__fmul_rn({x}, {x}), {x})",
                    0.5: f"sqrtf({x})", -1.0: f"__frcp_rn({x})",
                    -0.5: f"__frcp_rn(sqrtf({x}))", 1.0: x,
                    }.get(p, f"powf({x}, {_lit(p)})")
        raise ValueError(f"op {_op_name(t)} has no pointwise form")  # pragma: no cover

    def _under(self, cond, ref, idx) -> str:
        self._conds.append(cond)
        try:
            return self.expr(ref, idx)
        finally:
            self._conds.pop()

    def gather_expr(self, node, idx) -> str:
        t = node.target
        shape = _shape(node)
        rank = len(shape)
        if t == aten.cat.default:
            dim = (node.args[1] if len(node.args) > 1 else 0) % rank
            pieces = [x for x in node.args[0] if _shape(x)[dim] > 0]
            out, start = "0.0f", sum(_shape(x)[dim] for x in pieces)
            for x in reversed(pieces):  # nested from the last piece outwards
                start -= _shape(x)[dim]
                end = start + _shape(x)[dim]
                sub = list(idx)
                sub[dim] = idx[dim].sub(start)
                val = self._under((idx[dim], start, end, 1), self.refs[x], sub)
                out = val if out == "0.0f" else f"({idx[dim]} < {end} ? {val} : {out})"
            return out
        g = self.refs[node.args[0]]
        if t == aten.select_backward.default:
            dim, index = node.args[2] % rank, node.args[3] % shape[node.args[2] % rank]
            sub = idx[:dim] + idx[dim + 1:]
            val = self._under((idx[dim], index, index + 1, 1), g, sub)
            return f"({idx[dim]} == {index} ? {val} : 0.0f)"
        dim = node.args[2] % rank
        size = shape[dim]
        start, end, step = node.args[3], node.args[4], node.args[5]
        start = min(max(start + size if start < 0 else start, 0), size)
        end = min(max(end + size if end < 0 else end, start), size)
        i = idx[dim]
        sub = list(idx)
        sub[dim] = i.sub(start).div(step)
        cond = f"{i} >= {start} && {i} < {end}"
        if step != 1:
            cond += f" && ({i} - {start}) % {step} == 0"
        val = self._under((i, start, end, step), g, sub)
        return f"({cond} ? {val} : 0.0f)"

    # -- loops ------------------------------------------------------------------

    def dst(self, node) -> str:
        return "{DST:" + node.name + "}"

    def emit_node(self, node):
        kind = self.kind[node]
        shape = _shape(node)
        if _numel(shape) == 0:
            return
        self._acc = []
        names = [f"i{k}" for k in range(len(shape))]
        idx = _idx(names, shape)
        ref = self.refs[node]
        if kind in ("pw", "gather"):
            val = (self.pw_expr if kind == "pw" else self.gather_expr)(node, idx)
            write = _Acc(ref, idx, ())
            lines = [*_unravel("e", shape, names),
                     f"{self.dst(node)}[{self.addr(ref, idx)}] = {val};"]
            self.loops.append(_Loop(node, "pw", shape, write, self._acc, lines))
        elif kind == "mm":
            self.product_loop(node, shape)
        else:
            self.reduction_loop(node)
        self._acc = None

    def product_loop(self, node, shape):
        """mm and mv: one block_mm call with the literal shapes and strides of
        the operands' views (an operand that is no memory window, a literal,
        or the int buffer takes a k-term fmaf sum per output instead)."""
        A, B = (self.refs[x] for x in node.args)
        mv = node.target == aten.mv.default
        K = A.shape[-1]
        M, N = (shape[0], 1) if mv else shape
        self.madds += _numel(shape) * K
        out = self.refs[node]
        if all(isinstance(r, _Mem) and self.placed.get(r.store, r.store) != CI for r in (A, B)):
            sam, sak = (A.strides[0] if M != 1 else 0), (A.strides[1] if K != 1 else 0)
            sbk = (B.strides[0] if K != 1 else 0)
            sbn = 0 if mv or N == 1 else B.strides[1]
            scm = out.strides[0] if M != 1 else 0
            scn = 0 if mv or N == 1 else out.strides[1]
            tm, tn, ks = _tile(M, N, K)
            va = sak == 1 and (sam % 4 == 0 or M == 1) and self._aligned(A)
            vb = sbk == 1 and (sbn % 4 == 0 or N == 1) and self._aligned(B)
            mm = dict(M=M, N=N, K=K, A=A, B=B, sam=sam, sak=sak, sbk=sbk, sbn=sbn, scm=scm,
                      scn=scn, tm=tm, tn=tn, ks=ks, va=va, vb=vb)
            write = _Acc(out, [], ())
            self.loops.append(_Loop(node, "mm", (M, N, K), write, [], [], mm))
            return
        # the fallback: a thread an output, a k-term fmaf sum in order
        self._acc = []
        i, j, k = _Ix("i"), _Ix("j"), _Ix("k")
        a = self.expr(A, [i if M != 1 else ZERO, k])
        b = self.expr(B, [k] if mv else [k, j if N != 1 else ZERO])
        oidx = [i if M != 1 else ZERO] if mv else [i if M != 1 else ZERO, j if N != 1 else ZERO]
        lines = [f"for (int o = tid; o < {M * N}; o += kThreads) {{",
                 f"  const int i = o / {N};", f"  const int j = o % {N};",
                 "  float acc = 0.0f;", "#pragma unroll 4",
                 f"  for (int k = 0; k < {K}; ++k) acc = fmaf({a}, {b}, acc);",
                 f"  {self.dst(node)}[{self.addr(out, oidx)}] = acc;", "}"]
        write = _Acc(out, oidx, ())
        space = ((M, N), (K,), ["i", "j"], ["k"])
        self.loops.append(_Loop(node, "threadred", space, write, self._acc, lines))

    def _aligned(self, ref: _Mem) -> bool:
        """Whether ``ref``'s base is 16-byte aligned: the constants (device
        memory, or the staged copy at a 16-byte offset) and the scratch (a
        16-byte offset, every node at a multiple of four floats)."""
        store = self.placed.get(ref.store, ref.store)
        return ref.offset % 4 == 0 and (store == CF or isinstance(store, torch.fx.Node))

    def reduction_loop(self, node):
        src = node.args[0]
        ishape = _shape(src)
        if node.target == aten.sum.default:
            dims, keep = list(range(len(ishape))), False
        else:
            if node.kwargs.get("dtype") not in (None, torch.float32):
                raise ValueError(f"node {node.name}: a sum to {node.kwargs['dtype']}")
            dims = sorted({int(x) % max(len(ishape), 1) for x in node.args[1]}) \
                if len(node.args) > 1 and node.args[1] else list(range(len(ishape)))
            keep = bool(node.args[2]) if len(node.args) > 2 else bool(node.kwargs.get("keepdim"))
        kept = [k for k in range(len(ishape)) if k not in dims]
        kshape = [ishape[k] for k in kept]
        rshape = [ishape[k] for k in dims]
        n_out, n_red = _numel(kshape), _numel(rshape)
        iname = [f"o{k}" if k in kept else f"r{k}" for k in range(len(ishape))]
        idx = _idx(iname, ishape)
        val = self.expr(self.refs[src], idx)
        oidx = [idx[k] for k in range(len(ishape)) if keep or k in kept]
        out_ref = self.refs[node]
        out = self.addr(out_ref, oidx)
        unr_o = _unravel("o", kshape, [iname[k] for k in kept])
        unr_r = _unravel("r", rshape, [iname[k] for k in dims])
        space = (tuple(kshape), tuple(rshape), [iname[k] for k in kept],
                 [iname[k] for k in dims])
        write = _Acc(out_ref, oidx, ())
        dst = self.dst(node)
        if n_red >= 32:  # one warp an output element
            lines = [f"for (int o = warp; o < {n_out}; o += kWarps) {{",
                     *("  " + ln for ln in unr_o), "  float acc = 0.0f;",
                     f"  for (int r = lane; r < {n_red}; r += 32) {{",
                     *("    " + ln for ln in unr_r),
                     f"    acc = __fadd_rn(acc, {val});", "  }",
                     "  acc = avi::warp_sum(acc);",
                     f"  if (lane == 0) {dst}[{out}] = acc;", "}"]
            self.loops.append(_Loop(node, "warpred", space, write, self._acc, lines))
            return
        lines = [f"for (int o = tid; o < {n_out}; o += kThreads) {{",
                 *("  " + ln for ln in unr_o), "  float acc = 0.0f;",
                 f"  for (int r = 0; r < {n_red}; ++r) {{",
                 *("    " + ln for ln in unr_r),
                 f"    acc = __fadd_rn(acc, {val});", "  }",
                 f"  {dst}[{out}] = acc;", "}"]
        self.loops.append(_Loop(node, "threadred", space, write, self._acc, lines))

    def copy_loop(self, ref, dst_store, shape):
        """dst_store (GS or LOGPI, contiguous) = ref, element for element."""
        self._acc = []
        names = [f"i{k}" for k in range(len(shape))]
        idx = _idx(names, shape)
        val = self.expr(ref, idx)
        contiguous = tuple(int(np.prod(shape[k + 1:])) for k in range(len(shape)))
        write = _Acc(_Mem(dst_store, 0, tuple(shape), contiguous), idx, ())
        lines = [*_unravel("e", shape, names), f"{dst_store}[e] = {val};"]
        self.loops.append(_Loop(dst_store, "pw", tuple(shape), write, self._acc, lines))
        self._acc = None

    # -- the race model -------------------------------------------------------

    def accesses(self, loop: _Loop, key) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, threads, is_write) of every access of ``loop`` to storage a
        body writes (nodes, GS, LOGPI; the inputs zs, cf and ci are only read),
        ``key(store, addresses)`` naming each element."""
        kl, tl, wl = [], [], []

        def add(acc: _Acc, env, threads, write=False):
            store = self.placed.get(acc.ref.store, acc.ref.store)
            if store in (ZS, CF, CI):
                return
            mask = np.ones(threads.shape, dtype=bool)
            for ix, lo, hi, step in acc.conds:
                v = ix.eval(env)
                mask &= (v >= lo) & (v < hi) & ((v - lo) % step == 0)
            addr = np.full(threads.shape, acc.ref.offset, dtype=np.int64)
            for ix, sz, st in zip(acc.idx, acc.ref.shape, acc.ref.strides):
                if sz != 1 and st != 0 and ix.name is not None:
                    addr = addr + ix.eval(env) * st
            kl.append(key(store, addr[mask]))
            tl.append(threads[mask])
            wl.append(np.full(int(mask.sum()), write))

        if loop.kind == "pw":
            shape = loop.space
            e = np.arange(_numel(shape))
            env: Dict[str, Any] = {}
            _bind(env, e, shape, [f"i{k}" for k in range(len(shape))])
            thr = e % THREADS if loop.map == "flat" else 32 * (e % WARPS)
            add(loop.write, env, thr, True)
            for acc in loop.reads:
                add(acc, env, thr)
        elif loop.kind in ("warpred", "threadred"):
            kshape, rshape, onames, rnames = loop.space
            no, nr = _numel(kshape), _numel(rshape)
            o = np.repeat(np.arange(no), nr)
            r = np.tile(np.arange(nr), no)
            env = {}
            _bind(env, o, kshape, onames)
            _bind(env, r, rshape, rnames)
            if loop.kind == "warpred":
                rthr, wthr = 32 * (o % WARPS) + r % 32, 32 * (o % WARPS)
            else:
                rthr = wthr = o % THREADS
            for acc in loop.reads:
                add(acc, env, rthr)
            env_o: Dict[str, Any] = {}
            ow = np.arange(no)
            _bind(env_o, ow, kshape, onames)
            add(loop.write, env_o, 32 * (ow % WARPS) if loop.kind == "warpred"
                else ow % THREADS, True)
        else:  # block_mm: the tile model of csrc/block_mm.cuh
            mm = loop.mm
            M, N, K, tm, tn, ks = (mm[k] for k in ("M", "N", "K", "tm", "tn", "ks"))
            nb = -(-N // tn)
            tasks = -(-M // tm) * nb
            task = np.arange(tasks)
            i0, j0 = (task // nb) * tm, (task % nb) * tn
            full = K // 4
            kk = np.arange(K)
            unit = kk // 4
            lane_s = np.where(unit < full, unit % ks, full % ks)
            # A(i, k): every task, each row of its tile below M, every k, by lane s(k)
            t3, r3, k3 = np.meshgrid(task, np.arange(tm), kk, indexing="ij")
            i3 = i0[t3] + r3
            ok = i3 < M
            thr = (t3 * ks + lane_s[k3]) % THREADS
            self._mm_read(mm["A"], i3[ok], k3[ok], mm["sam"], mm["sak"], thr[ok], key,
                          (kl, tl, wl))
            # B(k, j): the tile's columns (one past N reads the first one)
            t3, c3, k3 = np.meshgrid(task, np.arange(tn), kk, indexing="ij")
            j3 = j0[t3] + np.where(j0[t3] + c3 < N, c3, 0)
            thr = (t3 * ks + lane_s[k3]) % THREADS
            self._mm_read(mm["B"], k3, j3, mm["sbk"], mm["sbn"], thr, key, (kl, tl, wl))
            t2, r2, c2 = np.meshgrid(task, np.arange(tm), np.arange(tn), indexing="ij")
            i2, j2 = i0[t2] + r2, j0[t2] + c2
            ok = (i2 < M) & (j2 < N)
            out = loop.write.ref
            store = self.placed.get(out.store, out.store)
            addr = out.offset + i2[ok] * mm["scm"] + j2[ok] * mm["scn"]
            kl.append(key(store, addr))
            tl.append((t2[ok] * ks) % THREADS)
            wl.append(np.ones(addr.shape, dtype=bool))
        if not kl:
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0, dtype=bool)
        return np.concatenate(kl), np.concatenate(tl), np.concatenate(wl)

    def _mm_read(self, ref: _Mem, x, y, sx, sy, thr, key, out):
        store = self.placed.get(ref.store, ref.store)
        if store in (ZS, CF, CI):
            return
        addr = (ref.offset + x * sx + y * sy).reshape(-1)
        out[0].append(key(store, addr))
        out[1].append(thr.reshape(-1))
        out[2].append(np.zeros(addr.shape, dtype=bool))

    # -- barriers and scratch -----------------------------------------------------

    def _logical_key(self):
        ids: Dict[Any, int] = {}

        def key(store, addr):
            sid = ids.setdefault(store, len(ids) + 1)
            return (np.int64(sid) << np.int64(32)) + addr.astype(np.int64)

        return key

    def place_barriers(self) -> List[bool]:
        """Walk the loops in order, keeping the accesses since the last
        barrier; a loop needs none before it when no element it reads or
        writes was written there by another thread, and no element it writes
        was read there by another thread.  A pointwise loop of at most WARPS
        elements may run on lane 0 of warp e instead of thread e, where that
        map meets its producers' (a warp reduction's outputs, say)."""
        key = self._logical_key()
        need = []
        ep_w: List[Tuple[np.ndarray, np.ndarray]] = []
        ep_r: List[Tuple[np.ndarray, np.ndarray]] = []
        for loop in self.loops:
            maps = ["flat", "warp"] if loop.kind == "pw" and _numel(loop.space) <= WARPS \
                else [loop.map]
            chosen = None
            for m in maps:
                loop.map = m
                k, t, w = self.accesses(loop, key)
                if not (_clash(k, t, ep_w) or _clash(k[w], t[w], ep_r)):
                    chosen = (m, k, t, w)
                    break
            bar = chosen is None
            if bar:
                loop.map = maps[0]
                k, t, w = self.accesses(loop, key)
                ep_w, ep_r = [], []
            else:
                loop.map = chosen[0]
                k, t, w = chosen[1:]
            need.append(bar)
            ep_w.append(_summary(k[w], t[w]))
            ep_r.append(_summary(k[~w], t[~w]))
        return need

    def allocate(self, need: List[bool]):
        """Offsets of the loops' scratch outputs (multiples of four floats):
        first fit, a node's floats free for another node written after a
        barrier that follows its last read; returns ({node: offset}, peak)."""
        epoch, e = [], 0
        for bar in need:
            e += bar
            epoch.append(e)
        last: Dict[Any, int] = {}
        for k, loop in enumerate(self.loops):
            for acc in loop.reads:
                last[acc.ref.store] = epoch[k]
            if loop.kind == "mm":
                for ref in (loop.mm["A"], loop.mm["B"]):
                    last[ref.store] = epoch[k]
        offsets: Dict[Any, int] = {}
        busy: List[Tuple[int, int, int]] = []  # (start, end, epoch of the last read)
        peak = 0
        for k, loop in enumerate(self.loops):
            node = loop.out
            if not isinstance(node, torch.fx.Node) or node in self.placed:
                continue
            busy = [b for b in busy if b[2] >= epoch[k]]
            size = self.extent.get(node, _numel(_shape(node)))
            start = 0
            for b0, b1, _ in sorted(busy):
                if start + size <= b0:
                    break
                start = max(start, -(-b1 // 4) * 4)
            offsets[node] = start
            busy.append((start, start + size, last.get(node, epoch[k])))
            peak = max(peak, start + size)
        return offsets, -(-peak // 4) * 4

    def race_check(self, need: List[bool], offsets: Dict[Any, int]) -> None:
        """The static race check of the planned body, on the block's memory
        as laid out: between two barriers, every element written is touched
        by no other thread, and no scratch float belongs to two storages.
        Raises AssertionError naming the loops."""
        def key(store, addr):
            if store in offsets:
                return (np.int64(1) << np.int64(32)) + addr.astype(np.int64) + offsets[store]
            sid = {GS: 2, LOGPI: 3}[store]
            return (np.int64(sid) << np.int64(32)) + addr.astype(np.int64)

        owner: Dict[int, Any] = {}
        span: List[int] = []
        acc_k, acc_t, acc_w = [], [], []
        for k, (loop, bar) in enumerate(zip(self.loops, need)):
            if bar:
                _check_epoch(acc_k, acc_t, acc_w, span, self.loops)
                acc_k, acc_t, acc_w, span, owner = [], [], [], [], {}
            kk, tt, ww = self.accesses(loop, key)
            acc_k.append(kk)
            acc_t.append(tt)
            acc_w.append(ww)
            span.append(k)
            stores = {acc.ref.store for acc in loop.reads} | {loop.out}
            if loop.kind == "mm":
                stores |= {loop.mm["A"].store, loop.mm["B"].store}
            for st in stores:
                if st in offsets:
                    size = self.extent.get(st, _numel(_shape(st)))
                    for f in range(offsets[st], offsets[st] + size):
                        prev = owner.setdefault(f, st)
                        assert prev is st, (
                            f"scratch float {f} holds {prev.name} and {st.name} between two "
                            f"barriers (loop {k})")
        _check_epoch(acc_k, acc_t, acc_w, span, self.loops)

    # -- the whole body -----------------------------------------------------------

    def plan(self):
        self.classify()
        grad, lp = _outputs(self.gm)
        outs = {grad, lp}
        live = self.live_nodes(outs)
        self.choose_inlined(live, outs)
        placed = self.placed
        for node, store, contiguous in ((grad, GS, (self.d, 1)), (lp, LOGPI, (1,))):
            if node in self.kind and node not in self.inlined \
                    and self.refs[node].strides == contiguous:
                placed[node] = store
        self.pad_operands(live)
        for node in self.gm.graph.nodes:
            if node in live and node in self.kind and node not in self.inlined:
                self.emit_node(node)
        for node, store in ((grad, GS), (lp, LOGPI)):
            if placed.get(node) != store:
                self.copy_loop(self.refs[node], store, _shape(node))
        return placed


def _summary(k: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct keys and, for each, its one thread (-1 for several)."""
    if not len(k):
        return k, t
    order = np.lexsort((t, k))
    k, t = k[order], t[order]
    uk, first = np.unique(k, return_index=True)
    lo = np.minimum.reduceat(t, first)
    hi = np.maximum.reduceat(t, first)
    return uk, np.where(lo == hi, lo, -1)


def _clash(k: np.ndarray, t: np.ndarray, seen) -> bool:
    """Whether an access (k, t) meets an element of ``seen`` that another
    thread (or several) touched."""
    for uk, ut in seen:
        if not len(uk) or not len(k):
            continue
        pos = np.clip(np.searchsorted(uk, k), 0, len(uk) - 1)
        hit = uk[pos] == k
        if np.any(hit & (ut[pos] != t)):
            return True
    return False


def _check_epoch(ks, ts, ws, span, loops) -> None:
    if not ks:
        return
    k, t, w = np.concatenate(ks), np.concatenate(ts), np.concatenate(ws)
    uk, ut = _summary(k, t)
    written = np.unique(k[w])
    pos = np.searchsorted(uk, written)
    bad = written[ut[pos] == -1]
    assert not len(bad), (
        f"loops {span[0]}..{span[-1]} ({', '.join(str(getattr(loops[i].out, 'name', loops[i].out)) for i in span)}) "
        f"share {len(bad)} written elements between threads with no barrier between")


def _fuse(loops: List[_Loop], need: List[bool]) -> List[List[int]]:
    """Runs of consecutive pointwise loops with one shape and one map and no
    barrier between them: each is emitted as one loop."""
    groups: List[List[int]] = []
    for k, loop in enumerate(loops):
        prev = loops[groups[-1][-1]] if groups else None
        if (prev is not None and not need[k] and loop.kind == "pw" and prev.kind == "pw"
                and loop.space == prev.space and loop.map == prev.map):
            groups[-1].append(k)
        else:
            groups.append([k])
    return groups


def _mm_call(mm: Dict[str, Any], expr_a: str, expr_b: str, dst: str) -> List[str]:
    return [f"avi::block_mm<kThreads, {mm['tm']}, {mm['tn']}, {mm['ks']}, "
            f"{'true' if mm['va'] else 'false'}, {'true' if mm['vb'] else 'false'}>(",
            f"    {mm['M']}, {mm['N']}, {mm['K']}, {expr_a}, {mm['sam']}, {mm['sak']}, "
            f"{expr_b}, {mm['sbk']}, {mm['sbn']}, tid,",
            f"    [=](int i, int j, float v) {{ {dst}[i * {mm['scm']} + j * {mm['scn']}] = v; }});"]


@dataclass(frozen=True)
class ADProgram:
    """K5 at one static (n, d): the traced graph, its packed constants, the
    emitted CUDA body and what the engines need to know of it."""

    gm: torch.fx.GraphModule
    packing: Packing
    n: int
    d: int
    source: str          # the generated header (avi::ad::ad_body)
    digest: str          # sha256 of ``source``, 16 hex digits
    scratch: int         # floats of scratch the body uses (shared or device memory)
    madds: int           # multiply-adds of its products (mm, mv) a call
    loops: int           # loops emitted (a block_mm call is one)
    barriers: int
    ops: Tuple[str, ...]  # the distinct aten ops of the graph
    staged: bool = False  # the float constants read from a shared-memory copy
    stage: int = 0        # floats of that copy (0 when not staged)
    products: int = 0     # mm and mv nodes run by block_mm
    planner: Any = None   # the plan, for race_check

    @property
    def consts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.packing.cf, self.packing.ci

    def logpi_grad(self, z: torch.Tensor):
        """(log pi, grad) of ``z`` of k n rows, the plain version replayed on
        each block of n rows (the kernels call the body on one block)."""
        if z.shape[0] == self.n:
            return replay(self.gm, z)
        parts = [replay(self.gm, blk) for blk in z.split(self.n)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def race_check(self) -> None:
        """Run the static race check on this body's plan (AssertionError on a
        race); ``emit`` runs it on every body."""
        planner, need, offsets = self.planner
        planner.race_check(need, offsets)


def emit(gm: torch.fx.GraphModule, packing: Packing, n: int, d: int,
         staged: bool = False) -> ADProgram:
    """Plan the graph's loops, barriers and scratch, check the plan for races
    and emit the header; ``staged`` reads the float constants from the copy
    ``ad_stage`` puts in shared memory."""
    planner = _Planner(gm, packing, n, d, staged)
    placed = planner.plan()
    need = planner.place_barriers()
    offsets, peak = planner.allocate(need)
    planner.race_check(need, offsets)
    ops = tuple(sorted({_op_name(node.target) for node in gm.graph.nodes
                        if node.op == "call_function"}))

    def ptr(ref: _Mem) -> str:
        store = placed.get(ref.store, ref.store)
        base = {CF: "cs" if staged else "cf", ZS: "zs", GS: "gs", LOGPI: "logpi"}.get(store)
        if base is None:
            base = f"s + {{OFF:{store.name}}}"
            return f"({base} + {ref.offset})" if ref.offset else f"({base})"
        return f"({base} + {ref.offset})" if ref.offset else base

    lines: List[str] = []
    logpi_at = max(k for k, loop in enumerate(planner.loops)
                   if placed.get(loop.out, loop.out) == LOGPI)
    mark_at = next((k for k in range(logpi_at + 1, len(planner.loops)) if need[k]), None)
    mark = ["#ifdef AVI_PHASE_CLOCKS", "if (tid == 0) *clk = clock64();  // log pi is complete",
            "#endif"]
    n_loops = 0
    for group in _fuse(planner.loops, need):
        first = planner.loops[group[0]]
        if need[group[0]]:
            lines.append("__syncthreads();")
            if group[0] == mark_at:
                lines.extend(mark)
        n_loops += 1
        if first.kind == "pw":
            numel = _numel(first.space)
            head = (f"for (int e = tid; e < {numel}; e += kThreads) {{" if first.map == "flat"
                    else f"if (lane == 0) for (int e = warp; e < {numel}; e += kWarps) {{")
            body = list(first.lines[:-1])
            for k in group:
                body.append(planner.loops[k].lines[-1])
            lines += [head, *("  " + ln for ln in body), "}"]
        elif first.kind == "mm":
            mm = first.mm
            lines += _mm_call(mm, ptr(mm["A"]), ptr(mm["B"]), ptr(first.write.ref))
        else:
            lines += first.lines
    if mark_at is None:
        lines.extend(mark)
    out_lines = []
    for ln in lines:
        for node, store in placed.items():
            ln = ln.replace("{DST:" + node.name + "}", store)
        for node, off in offsets.items():
            ln = ln.replace("{DST:" + node.name + "}", f"(s + {off})")
            ln = ln.replace("{OFF:" + node.name + "}", str(off))
        out_lines.append(ln)
    body = "\n".join("  " + ln if not ln.startswith("#") else ln for ln in out_lines)
    stage = -(-packing.cf.numel() // 4) * 4 if staged else 0
    products = sum(loop.kind == "mm" for loop in planner.loops)
    barriers = sum(need)
    src = f"""// K5: the AD-derived model body, generated by
// advancedvi_jl_tpu_torch/ops/cuda/ad_body.py from the target's aten graph of
// value and gradient at (n, d) = ({n}, {d}): {len(gm.graph.nodes)} graph nodes,
// {n_loops} loops ({products} block products), {barriers} barriers, {peak} floats of scratch,
// float constants {'staged in shared memory' if staged else 'read from device memory'}.
// ops: {' '.join(ops)}
#pragma once

#include "fused_common.cuh"

namespace avi {{
namespace ad {{

constexpr int kThreads = {THREADS};
constexpr int kWarps = kThreads / 32;
constexpr int kN = {n};
constexpr int kD = {d};
constexpr int kScratch = {peak};
constexpr int kStage = {stage};  // floats of the float constants' copy in shared memory

__device__ __forceinline__ float sgn_(float x) {{
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}}

__device__ __forceinline__ float clamp_min_(float x, float m) {{
  return isnan(x) ? x : fmaxf(x, m);
}}

// Once a launch, before the caller's first barrier: the float constants cf
// (device memory, 16-byte aligned) into cs (kStage floats of shared memory,
// 16-byte aligned) when the body reads them there.
__device__ __forceinline__ void ad_stage(const float* __restrict__ cf, float* cs, int tid) {{
  (void)cf;
  (void)cs;
  (void)tid;
  for (int q = tid; q < kStage / 4; q += kThreads) {{
    const int e = 4 * q;  // the last float4 may run past cf's end: copy it float by float
    if (e + 4 <= {packing.cf.numel()}) {{
      reinterpret_cast<float4*>(cs)[q] = reinterpret_cast<const float4*>(cf)[q];
    }} else {{
      for (int f = e; f < {packing.cf.numel()}; ++f) cs[f] = cf[f];
    }}
  }}
}}

// log pi (n,) into logpi and grad log pi (n, d) into gs of the samples zs
// (n, d), each in shared or device memory; cf and ci: the packed constants
// in device memory, cs: cf's copy in shared memory (ad_stage) when kStage >
// 0; s: kScratch floats of shared or device memory, 16-byte aligned.  Every
// thread of the block calls it; the caller puts a barrier before (zs) and
// after (logpi, gs).  An AVI_PHASE_CLOCKS build has thread 0 store the SM clock in *clk
// at the barrier after which log pi is complete.
__device__ __forceinline__ void ad_body(const float* __restrict__ cf,
                                        const int* __restrict__ ci, const float* cs,
                                        const float* zs, int n, int d, float* logpi,
                                        float* gs, float* s, int tid, long long* clk) {{
  const int lane = tid & 31;
  const int warp = tid >> 5;
  (void)n;
  (void)d;
  (void)lane;
  (void)warp;
  (void)cf;
  (void)ci;
  (void)cs;
  (void)s;
  (void)clk;
{body}
}}

}}  // namespace ad
}}  // namespace avi
"""
    return ADProgram(gm=gm, packing=packing, n=n, d=d, source=src,
                     digest=hashlib.sha256(src.encode()).hexdigest()[:16], scratch=peak,
                     madds=planner.madds, loops=n_loops, barriers=barriers, ops=ops,
                     staged=staged, stage=stage, products=products,
                     planner=(planner, need, offsets))


# ---------------------------------------------------------------------------
# The model an ad spec carries
# ---------------------------------------------------------------------------


def _tensor_leaves(obj, depth: int = 0):
    """The tensors and arrays of a target's fields (dataclasses, mappings,
    lists and tuples), for the leaf-type check."""
    if depth > 8:
        return
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensor_leaves(getattr(obj, f.name), depth + 1)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensor_leaves(v, depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensor_leaves(v, depth + 1)


def check_leaves(target) -> None:
    """Raise ValueError for a bool or complex leaf anywhere in the target
    (JAX ad_spec :1579-1586), used by its log density or not."""
    for leaf in _tensor_leaves(target):
        dt = leaf.dtype
        if dt in (torch.bool, np.bool_) or (isinstance(dt, torch.dtype) and dt.is_complex) \
                or (isinstance(dt, np.dtype) and np.issubdtype(dt, np.complexfloating)):
            raise ValueError(
                f"the target has a {dt} leaf ({tuple(leaf.shape)}); only float and "
                "integer tensors can be the kernel's constants: cast it in the target"
            )


def leaf_device(target, default="cuda") -> torch.device:
    for leaf in _tensor_leaves(target):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device(default)


class ADModel:
    """A target's log density as K5 runs it: one ``ADProgram`` for each
    sample count the engines ask for, traced and emitted once."""

    def __init__(self, log_density: Callable, dim: int, device, name: str = "target"):
        self.log_density = log_density
        self.dim = int(dim)
        self.device = torch.device(device)
        self.name = name
        self._programs: Dict[int, ADProgram] = {}
        self._packings: Dict[tuple, Packing] = {}

    def program(self, n: int, staged: bool = False) -> ADProgram:
        """The program at ``n`` rows; ``staged`` reads the float constants
        from a copy in shared memory (``fused_advi.ad_program`` decides
        where they fit)."""
        prog = self._programs.get((n, staged))
        if prog is None:
            other = self._programs.get((n, not staged))
            if other is not None:  # the same graph and constants, emitted again
                gm, packing = other.gm, other.packing
            else:
                gm = trace(self.log_density, n, self.dim, self.device)
                check_graph(gm, n, self.dim)
                # the programs of one target share one copy of its constants
                key = tuple((name, t.data_ptr(), t.dtype, tuple(t.shape)) for name, t in
                            ((name, getattr(gm, name)) for name in _constant_names(gm)))
                packing = self._packings.get(key)
                if packing is None:
                    packing = self._packings[key] = pack(gm, self.device)
            prog = self._programs[(n, staged)] = emit(gm, packing, n, self.dim, staged)
            bind(gm, packing)
        return prog
