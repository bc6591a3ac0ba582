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
A pointwise node read once, element for element, by a pointwise node or a
sum is inlined into that consumer's expression.  ``ones_like``,
``new_zeros`` and ``scalar_tensor`` are literals, and pointwise nodes of
literals fold on the host with torch's own op.  ``mm`` and ``mv`` are a
k-term ``fmaf`` sum for each output element; ``sum`` is one reduction for
each output element (a warp's, over 32 terms or more).  ``cat``,
``slice_backward`` and ``select_backward`` are one pass that reads the
element or writes 0.  The arithmetic rounds as torch's ops do: ``__fadd_rn``
and ``__fmul_rn``, so no two ops contract into an FMA; ``logf``, ``expf`` and
``log1pf`` without fast math; ``sgn(0) = sgn(NaN) = 0`` and ``clamp_min``
keeps a NaN, as torch.  A ``__syncthreads()`` stands only where a loop reads
what an earlier loop wrote since the last barrier, or writes scratch that an
earlier loop read since then.  The intermediates live in the block's shared
memory, liveness-packed (first fit), ``scratch`` floats in all.

What bounds it on an H100: latency, as the hand bodies.  At the flagship
(n = 10, d = 62, 208 x 61 design) the graph's two products are 2 x 126,880
multiply-adds a step, a few microseconds of one SM; the body's sequential
depth is its loops and barriers, and it reads the constants (the design)
from global memory through L1 and L2 instead of staging them in shared
memory as the hand logreg body does.

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


def trace(log_density: Callable, n: int, d: int, device) -> torch.fx.GraphModule:
    """The aten graph of ``z -> (grad, (sum, log pi))`` of ``log_density``
    at a float32 (n, d) block, its constants float32 or integer and
    contiguous.  Raises ValueError where ``make_fx`` cannot trace it
    (data-dependent control flow) or a constant is bool or complex."""

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
    return gm


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
    """A pointwise node computed inside its one consumer's expression."""

    node: Any
    shape: Tuple[int, ...]


def _lit(v: float) -> str:
    f = np.float32(v)
    if not np.isfinite(f):
        return f"__int_as_float(0x{int(f.view(np.uint32)):08x})"
    return f"{float(f)!r}f"


def _shape(node) -> Tuple[int, ...]:
    return tuple(int(s) for s in node.meta["val"].shape)


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


@dataclass
class _Loop:
    out: Any            # the storage written (a node, GS or LOGPI)
    reads: set          # storages read
    body: List[str]


class _Planner:
    def __init__(self, gm: torch.fx.GraphModule, packing: Packing, n: int, d: int):
        self.gm, self.packing, self.n, self.d = gm, packing, n, d
        self.refs: Dict[Any, Any] = {}
        self.kind: Dict[Any, str] = {}
        self.loops: List[_Loop] = []
        self.inlined: set = set()
        self.placed: Dict[Any, str] = {}  # output nodes computed straight into GS, LOGPI

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

    def choose_inlined(self, live, outs):
        uses: Dict[Any, List[Any]] = {}
        for node in live:
            for a in node.args:
                for x in (a if isinstance(a, (list, tuple)) else (a,)):
                    if isinstance(x, torch.fx.Node) and x in live:
                        uses.setdefault(x, []).append(node)
        for node in self.gm.graph.nodes:
            if node not in live or self.kind.get(node) != "pw" or node in outs:
                continue
            users = uses.get(node, [])
            if len(users) != 1:
                continue
            user = users[0]
            kind = self.kind.get(user)
            if kind == "red" or (kind == "pw" and _shape(user) == _shape(node)):
                self.inlined.add(node)
                self.refs[node] = _Inl(node, _shape(node))

    # -- expressions ------------------------------------------------------------

    def expr(self, ref, idx: List[str], reads: set) -> str:
        """C expression of ``ref`` at the index ``idx`` of an iteration space
        of rank len(idx), ``ref`` broadcast against it from the right."""
        if isinstance(ref, _Lit):
            return _lit(ref.value)
        if isinstance(ref, _Inl):
            return self.pw_expr(ref.node, idx, reads)
        lead = len(idx) - len(ref.shape)
        terms = [str(ref.offset)] if ref.offset else []
        for k, (sz, st) in enumerate(zip(ref.shape, ref.strides)):
            if sz != 1 and st != 0 and idx[lead + k] != "0":
                terms.append(idx[lead + k] if st == 1 else f"{idx[lead + k]} * {st}")
        addr = " + ".join(terms) or "0"
        reads.add(ref.store)
        store = self.placed.get(ref.store, ref.store)
        if store == CI:
            return f"static_cast<float>(ci[{addr}])"
        if store in (ZS, CF, GS, LOGPI):
            return f"{store}[{addr}]"
        return f"s[{{OFF:{store.name}}} + {addr}]"

    def pw_expr(self, node, idx, reads) -> str:
        t = node.target
        shape = _shape(node)
        a = [self.expr(self.arg_ref(x, shape), idx, reads) if isinstance(x, torch.fx.Node)
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

    # -- loops ------------------------------------------------------------------

    def out_addr(self, node, idx) -> str:
        ref = self.refs[node]
        terms = [f"{i} * {st}" if st != 1 else i for i, st, sz in
                 zip(idx, ref.strides, ref.shape) if sz != 1 and i != "0"]
        return " + ".join(terms) or "0"

    def emit_node(self, node):
        kind = self.kind[node]
        shape = _shape(node)
        numel = int(np.prod(shape)) if shape else 1
        if numel == 0:
            return
        reads: set = set()
        dst = "{DST:" + node.name + "}"
        names = [f"i{k}" for k in range(len(shape))]
        idx = [n if s != 1 else "0" for n, s in zip(names, shape)]
        if kind in ("pw", "gather"):
            val = (self.pw_expr if kind == "pw" else self.gather_expr)(node, idx, reads)
            body = [f"for (int e = tid; e < {numel}; e += kThreads) {{",
                    *("  " + ln for ln in _unravel("e", shape, names)),
                    f"  {dst}[{self.out_addr(node, idx)}] = {val};", "}"]
        elif kind == "mm":
            body = self.product_loop(node, shape, dst, reads)
        else:
            body = self.reduction_loop(node, dst, reads)
        self.loops.append(_Loop(node, reads, body))

    def product_loop(self, node, shape, dst, reads):
        A, B = (self.refs[x] for x in node.args)
        K = A.shape[-1]
        if node.target == aten.mm.default:
            M, N = shape
            a = self.expr(A, ["i", "k"], reads)
            b = self.expr(B, ["k", "j"], reads)
            head = [f"for (int e = tid; e < {M * N}; e += kThreads) {{",
                    f"  const int i = e / {N};", f"  const int j = e % {N};"]
            out = self.out_addr(node, ["i" if M != 1 else "0", "j" if N != 1 else "0"])
        else:
            (M,) = shape
            a = self.expr(A, ["i", "k"], reads)
            b = self.expr(B, ["k"], reads)
            head = [f"for (int i = tid; i < {M}; i += kThreads) {{"]
            out = self.out_addr(node, ["i" if M != 1 else "0"])
        self.madds += (int(np.prod(shape)) if shape else 1) * K
        return head + ["  float acc = 0.0f;", "#pragma unroll 4",
                       f"  for (int k = 0; k < {K}; ++k) acc = fmaf({a}, {b}, acc);",
                       f"  {dst}[{out}] = acc;", "}"]

    def reduction_loop(self, node, dst, reads):
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
        n_out = int(np.prod([ishape[k] for k in kept])) if kept else 1
        n_red = int(np.prod([ishape[k] for k in dims])) if dims else 1
        iname = [f"o{k}" if k in kept else f"r{k}" for k in range(len(ishape))]
        idx = [nm if s != 1 else "0" for nm, s in zip(iname, ishape)]
        val = self.expr(self.refs[src], idx, reads)
        oidx = [idx[k] for k in range(len(ishape)) if keep or k in kept]
        out = self.out_addr(node, oidx)
        unr_o = _unravel("o", [ishape[k] for k in kept], [iname[k] for k in kept])
        unr_r = _unravel("r", [ishape[k] for k in dims], [iname[k] for k in dims])
        if n_red >= 32:  # one warp an output element
            return ([f"for (int o = warp; o < {n_out}; o += kWarps) {{",
                     *("  " + ln for ln in unr_o), "  float acc = 0.0f;",
                     f"  for (int r = lane; r < {n_red}; r += 32) {{",
                     *("    " + ln for ln in unr_r),
                     f"    acc = __fadd_rn(acc, {val});", "  }",
                     "  acc = avi::warp_sum(acc);",
                     f"  if (lane == 0) {dst}[{out}] = acc;", "}"])
        return ([f"for (int o = tid; o < {n_out}; o += kThreads) {{",
                 *("  " + ln for ln in unr_o), "  float acc = 0.0f;",
                 f"  for (int r = 0; r < {n_red}; ++r) {{",
                 *("    " + ln for ln in unr_r),
                 f"    acc = __fadd_rn(acc, {val});", "  }",
                 f"  {dst}[{out}] = acc;", "}"])

    def gather_expr(self, node, idx, reads) -> str:
        t = node.target
        shape = _shape(node)
        rank = len(shape)
        if t == aten.cat.default:
            dim = (node.args[1] if len(node.args) > 1 else 0) % rank
            pieces = [x for x in node.args[0] if _shape(x)[dim] > 0]
            out, start = "0.0f", sum(_shape(x)[dim] for x in pieces)
            for x in reversed(pieces):  # nested from the last piece outwards
                start -= _shape(x)[dim]
                sub = list(idx)
                sub[dim] = f"({idx[dim]} - {start})" if start else idx[dim]
                val = self.expr(self.refs[x], sub, reads)
                out = val if out == "0.0f" else \
                    f"({idx[dim]} < {start + _shape(x)[dim]} ? {val} : {out})"
            return out
        g = self.refs[node.args[0]]
        if t == aten.select_backward.default:
            dim, index = node.args[2] % rank, node.args[3] % shape[node.args[2] % rank]
            sub = idx[:dim] + idx[dim + 1:]
            return f"({idx[dim]} == {index} ? {self.expr(g, sub, reads)} : 0.0f)"
        dim = node.args[2] % rank
        size = shape[dim]
        start, end, step = node.args[3], node.args[4], node.args[5]
        start = min(max(start + size if start < 0 else start, 0), size)
        end = min(max(end + size if end < 0 else end, start), size)
        i = idx[dim]
        sub = list(idx)
        sub[dim] = f"({i} - {start})" if step == 1 else f"(({i} - {start}) / {step})"
        cond = f"{i} >= {start} && {i} < {end}"
        if step != 1:
            cond += f" && ({i} - {start}) % {step} == 0"
        return f"({cond} ? {self.expr(g, sub, reads)} : 0.0f)"

    def copy_loop(self, ref, dst_store, shape):
        """dst_store (GS or LOGPI, contiguous) = ref, element for element."""
        reads: set = set()
        names = [f"i{k}" for k in range(len(shape))]
        idx = [nm if sz != 1 else "0" for nm, sz in zip(names, shape)]
        val = self.expr(ref, idx, reads)
        body = [f"for (int e = tid; e < {int(np.prod(shape))}; e += kThreads) {{",
                *("  " + ln for ln in _unravel("e", shape, names)),
                f"  {dst_store}[e] = {val};", "}"]
        self.loops.append(_Loop(dst_store, reads, body))

    # -- the whole body -----------------------------------------------------------

    def plan(self):
        self.madds = 0
        self.classify()
        grad, lp = _outputs(self.gm)
        outs = {grad, lp}
        live = self.live_nodes(outs)
        self.choose_inlined(live, outs)
        placed = self.placed
        for node, store, contiguous in ((grad, GS, (self.d, 1)), (lp, LOGPI, (1,))):
            if node in self.kind and self.refs[node].strides == contiguous:
                placed[node] = store
        for node in self.gm.graph.nodes:
            if node in live and node in self.kind and node not in self.inlined:
                self.emit_node(node)
        for node, store in ((grad, GS), (lp, LOGPI)):
            if placed.get(node) != store:
                self.copy_loop(self.refs[node], store, _shape(node))
        return placed

    def allocate(self, placed):
        """First-fit offsets of the loops' scratch outputs, each freed after
        its last reader; returns ({node: offset}, peak floats)."""
        last: Dict[Any, int] = {}
        for k, loop in enumerate(self.loops):
            for st in loop.reads:
                last[st] = k
        offsets: Dict[Any, int] = {}
        busy: List[Tuple[int, int, Any]] = []  # (start, end, store)
        peak = 0
        for k, loop in enumerate(self.loops):
            node = loop.out
            if isinstance(node, torch.fx.Node) and node not in placed:
                size = int(np.prod(_shape(node))) if _shape(node) else 1
                start = 0
                for b0, b1, _ in sorted(busy, key=lambda b: b[0]):
                    if start + size <= b0:
                        break
                    start = max(start, b1)
                offsets[node] = start
                busy.append((start, start + size, node))
                peak = max(peak, start + size)
            busy = [b for b in busy if last.get(b[2], -1) > k]
        return offsets, peak

    def barriers(self, offsets) -> List[bool]:
        """Whether loop k needs a barrier before it: it reads a storage
        written since the last barrier (read after write), or writes a
        storage read since then (write after read: scratch reused, by
        extent)."""
        def where(store):
            store = self.placed.get(store, store)
            if store in offsets:
                size = int(np.prod(_shape(store))) if _shape(store) else 1
                return ("s", offsets[store], offsets[store] + size)
            return (store, 0, 1)

        def overlap(a, b):
            return a[0] == b[0] and a[1] < b[2] and b[1] < a[2]

        need, written, read = [], [], []
        for loop in self.loops:
            reads = [where(st) for st in loop.reads]
            out = where(loop.out)
            hazard = any(overlap(r, w) for r in reads for w in written) or any(
                overlap(out, r) for r in read)
            if hazard:
                written, read = [], []
            need.append(hazard)
            read.extend(reads)
            written.append(out)
        return need


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
    scratch: int         # floats of shared memory the body uses
    madds: int           # multiply-adds of its products (mm, mv) a call
    loops: int
    barriers: int
    ops: Tuple[str, ...]  # the distinct aten ops of the graph

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


def emit(gm: torch.fx.GraphModule, packing: Packing, n: int, d: int) -> ADProgram:
    """Plan the graph's loops, scratch and barriers and emit the header."""
    planner = _Planner(gm, packing, n, d)
    placed = planner.plan()
    offsets, peak = planner.allocate(placed)
    need = planner.barriers(offsets)
    ops = tuple(sorted({_op_name(node.target) for node in gm.graph.nodes
                        if node.op == "call_function"}))
    lines = []
    for loop, bar in zip(planner.loops, need):
        if bar:
            lines.append("__syncthreads();")
        for ln in loop.body:
            for node, store in placed.items():
                ln = ln.replace("{DST:" + node.name + "}", store)
            for node, off in offsets.items():
                ln = ln.replace("{DST:" + node.name + "}", f"(s + {off})")
                ln = ln.replace("{OFF:" + node.name + "}", str(off))
            lines.append(ln)
    body = "\n".join("  " + ln for ln in lines)
    src = f"""// K5: the AD-derived model body, generated by
// advancedvi_jl_tpu_torch/ops/cuda/ad_body.py from the target's aten graph of
// value and gradient at (n, d) = ({n}, {d}): {len(gm.graph.nodes)} graph nodes,
// {len(planner.loops)} loops, {sum(need)} barriers, {peak} floats of scratch.
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

__device__ __forceinline__ float sgn_(float x) {{
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}}

__device__ __forceinline__ float clamp_min_(float x, float m) {{
  return isnan(x) ? x : fmaxf(x, m);
}}

// log pi (n,) into logpi and grad log pi (n, d) into gs of the samples zs
// (n, d), all three in shared memory; cf and ci: the packed constants in
// device memory; s: kScratch floats of shared memory.  Every thread of the
// block calls it; the caller puts a barrier before (zs) and after (logpi, gs).
__device__ __forceinline__ void ad_body(const float* __restrict__ cf,
                                        const int* __restrict__ ci, const float* zs, int n,
                                        int d, float* logpi, float* gs, float* s, int tid) {{
  const int lane = tid & 31;
  const int warp = tid >> 5;
  (void)n;
  (void)d;
  (void)lane;
  (void)warp;
  (void)cf;
  (void)ci;
  (void)s;
{body}
}}

}}  // namespace ad
}}  // namespace avi
"""
    return ADProgram(gm=gm, packing=packing, n=n, d=d, source=src,
                     digest=hashlib.sha256(src.encode()).hexdigest()[:16], scratch=peak,
                     madds=planner.madds, loops=len(planner.loops), barriers=sum(need),
                     ops=ops)


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

    def program(self, n: int) -> ADProgram:
        prog = self._programs.get(n)
        if prog is None:
            gm = trace(self.log_density, n, self.dim, self.device)
            check_graph(gm, n, self.dim)
            # the programs of one target share one copy of its constants
            key = tuple((name, t.data_ptr(), t.dtype, tuple(t.shape)) for name, t in
                        ((name, getattr(gm, name)) for name in _constant_names(gm)))
            packing = self._packings.get(key)
            if packing is None:
                packing = self._packings[key] = pack(gm, self.device)
            prog = self._programs[n] = emit(gm, packing, n, self.dim)
            bind(gm, packing)
        return prog
