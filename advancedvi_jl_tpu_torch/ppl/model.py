"""Model ingestion: a probabilistic-program function -> a target ready to
fit (port of ppl/model.py; reference ext/AdvancedVIDynamicPPLExt.jl:72-211).

The user writes a plain Python function of torch ops with the
``ppl.sample`` / ``ppl.plate`` effect primitives:

    import advancedvi_jl_tpu_torch.ppl as ppl

    def model(data):
        X = data["X"]
        sigma = ppl.sample("sigma", ppl.LogNormal(0.0, 3.0))
        beta = ppl.sample("beta", ppl.Normal(X.new_zeros(X.shape[1]), sigma))
        with ppl.plate("obs", X.shape[0]):
            ppl.sample("y", ppl.Bernoulli(logits=X @ beta), obs=data["y"])

    m = ppl.ingest(model, data={"X": X, "y": y})   # on the card unless device="cpu"
    q, infos, _ = avt.optimize(0, alg, n_iter, m.target, m.q_init())
    draws = m.sample_posterior(1, q, 1000)          # a dict of site draws

As in the reference, the function is written for ONE parameter value: a
site's value has the site's own shape.  The port's targets are batched
(theta (..., d) -> (...)), so the ingested target maps the model's replay
over the rows of theta with ``torch.func.vmap``; the replay is pure tensor
code with no data-dependent Python branch, so K5's ``make_fx`` traces it
(``fused_spec_for(m.target)`` -> ``ad_spec``).  Constants a model creates
inside itself should come from a leaf (``X.new_zeros(d)``: on the data's
device, and a literal to K5) rather than a factory such as ``torch.zeros``,
which K5 refuses by name.

Ingestion runs ONE trace pass that draws every latent site from its prior
with a torch generator (only names, shapes and supports are kept), then
assembles the Stacked constrained -> unconstrained bijection from the
supports, ``logprior`` / ``loglike`` replays, and a ``PPLTarget`` when
``data`` is given: plate-observed sites are the subsampled likelihood,
rescaled by n / batch; observed sites outside a plate are global evidence
and never rescaled.  Latent sites inside a plate are per-datapoint locals:
with data, ``q_init()`` is a ``GlobalLocalFamily`` whose local block
subsamples in lockstep with the rows, and their priors and log-det-
Jacobians ride the rescaled likelihood.  Site order, flat layout, ``dim``
and ``dim_constrained`` are the reference's.  ``data`` may hold numpy
arrays (a JAX model's data pass across as numpy): they become tensors on
``device``, float arrays as float32.

``data_axis``: under a device mesh with that axis (parallel/mesh.py) a rank
replays the model on its row block of the data (or of the minibatch), in
local-latent mode with its rows' local latents, and the blocks'
likelihood sums are summed over the axis (``data_psum``); the priors and
global evidence are replicated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.factorized import _first_tensor, _map_data
from ..core.problem import ORDER_AUTOGRAD, fn_target
from ..parallel.mesh import data_psum, data_split, rows_of, shard_axis0
from ..core.transforms import (
    Blockwise,
    Identity,
    Sigmoid,
    Softplus,
    StickBreakingSimplex,
    TransformedDistribution,
    TransformedTarget,
    _cols,
    stacked,
)

# ---------------------------------------------------------------------------
# Effect-handler machinery
# ---------------------------------------------------------------------------

_HANDLER_STACK: List[Any] = []
_PLATE_STACK: List["plate"] = []


def sample(name: str, dist: Any, obs: Optional[torch.Tensor] = None):
    """Declare a random site: latent when ``obs`` is None, observed otherwise."""
    if not _HANDLER_STACK:
        raise RuntimeError(
            "ppl.sample() used outside a model execution context; call the "
            "model through ppl.ingest(...) (or ppl.prior_predictive)."
        )
    return _HANDLER_STACK[-1].process(name, dist, obs, in_plate=len(_PLATE_STACK) > 0)


class plate:
    """Marks the subsampled data axis: observed sites inside it form the
    per-datapoint likelihood (rescaled under minibatching)."""

    def __init__(self, name: str, size: int):
        self.name = name
        self.size = size

    def __enter__(self):
        _PLATE_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _PLATE_STACK.pop()
        return False


class _HandlerCtx:
    def __init__(self, handler):
        self.handler = handler

    def __enter__(self):
        _HANDLER_STACK.append(self.handler)
        return self.handler

    def __exit__(self, *exc):
        _HANDLER_STACK.pop()
        return False


class _Tracer:
    """Discovery pass: draws latent sites from their priors, records metadata."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = torch.device(device)
        self.sites: Dict[str, dict] = {}

    def process(self, name, dist, obs, in_plate):
        if name in self.sites:
            raise ValueError(f"duplicate site name {name!r}")
        if obs is not None:
            self.sites[name] = {"observed": True, "in_plate": in_plate}
            return obs
        support = dist.support
        if support == "discrete":
            raise ValueError(
                f"latent site {name!r} has a discrete distribution "
                f"({type(dist).__name__}); discrete latents are not "
                "supported by VI — marginalize them or observe the site."
            )
        val = dist.sample(self.generator).to(self.device)
        plate_size = None
        if in_plate:
            # A latent site inside a plate is per-datapoint: scalar (or
            # per-event) parameters broadcast to one draw a plate row, so
            # the model stays valid at any batch size; a site whose leading
            # dim already equals the plate size is kept as it is.
            if len(_PLATE_STACK) > 1:
                raise ValueError(
                    f"latent site {name!r} sits inside nested plates; "
                    "local-latent VI supports one plate level."
                )
            plate_size = _PLATE_STACK[-1].size
            if not (val.dim() >= 1 and val.shape[0] == plate_size):
                val = val.expand((plate_size,) + tuple(val.shape)).contiguous()
        self.sites[name] = {
            "observed": False,
            "in_plate": in_plate,
            "plate_size": plate_size,
            "shape": tuple(val.shape),
            "support": support,
            "dist_type": type(dist).__name__,
            "interval": (dist.lo, dist.hi) if support == "interval" else None,
            "init": val,
        }
        return val


class _Replayer:
    """Scoring pass: substitutes latent values, accumulates log densities."""

    def __init__(self, values: Dict[str, torch.Tensor]):
        self.values = values
        self.logprior = 0.0  # priors and global (non-plate) evidence
        self.loglike = 0.0  # plate-observed likelihood (rescalable)

    def process(self, name, dist, obs, in_plate):
        val = self.values[name] if obs is None else obs
        term = torch.sum(dist.log_prob(val))
        # per-datapoint latent priors belong to the rescalable per-datapoint
        # sum, as the likelihood (full batch: likeadj = 1, the total unchanged)
        if in_plate:
            self.loglike = self.loglike + term
        else:
            self.logprior = self.logprior + term
        return val


def _over_rows(fn: Callable, theta: torch.Tensor, width: Optional[int] = None) -> torch.Tensor:
    """``fn`` of one vector (d,) -> () (or -> (width,)) at every row of
    theta (..., d)."""
    if theta.dim() == 1:
        return fn(theta)
    lead = theta.shape[:-1] + (() if width is None else (width,))
    return torch.func.vmap(fn)(theta.reshape(-1, theta.shape[-1])).reshape(lead)


# ---------------------------------------------------------------------------
# Support -> Transform assembly
# ---------------------------------------------------------------------------


def _n_blocks(shape) -> int:
    return int(math.prod(shape[:-1])) if len(shape) > 1 else 1


def _site_transform(meta):
    s = meta["support"]
    if s == "real":
        return Identity()
    if s == "positive":
        return Softplus()
    if s == "unit_interval":
        return Sigmoid(lo=0.0, hi=1.0)
    if s == "interval":
        lo, hi = meta["interval"]
        return Sigmoid(lo=lo, hi=hi)
    if s == "simplex":
        # a (..., K) Dirichlet site is prod(batch) independent K-simplices,
        # each with its own stick-breaking map and Jacobian
        shape = meta["shape"]
        k = shape[-1]
        n_blocks = _n_blocks(shape)
        if n_blocks == 1:
            return StickBreakingSimplex()
        return Blockwise(inner=StickBreakingSimplex(), n_blocks=n_blocks, block_in=k - 1,
                         block_out=k)
    raise ValueError(f"unknown support {s!r}")


def _constrained_size(meta) -> int:
    return int(math.prod(meta["shape"])) if meta["shape"] else 1


def _unconstrained_size(meta) -> int:
    if meta["support"] == "simplex":
        shape = meta["shape"]
        return _n_blocks(shape) * (shape[-1] - 1)
    return _constrained_size(meta)


def _unpack(theta: torch.Tensor, slices) -> Dict[str, torch.Tensor]:
    """Flat constrained (..., dc) -> {site: (..., *shape)}."""
    batch = theta.shape[:-1]
    out = {}
    for n, (off, sz, shape) in slices.items():
        v = _cols(theta, off, sz)
        out[n] = v.reshape(*batch, *shape) if shape else v[..., 0]
    return out


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _to_device(data: Any, device) -> Any:
    """Tensors of a pytree of data on ``device``: numpy float arrays as
    float32 tensors, other numpy arrays as tensors of their type."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    if isinstance(data, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(data))
        return (t.to(torch.float32) if t.is_floating_point() else t).to(device)
    if isinstance(data, dict):
        return {k: _to_device(v, device) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(_to_device(v, device) for v in data)
    return data


# ---------------------------------------------------------------------------
# The ingested model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PPLTarget:
    """logprior(theta) + likeadj * loglike(theta, data) from ONE replay of the
    model function a row (the contract of core/factorized.FactorizedTarget:
    a weighted log-joint and a minibatch ``subsample``).  In local-latent
    mode (``local_k > 0``) theta's trailing rows * local_k block holds the
    minibatch's local latents, so ``dim`` shrinks with the batch."""

    data: Any
    likeadj: torch.Tensor
    replay_fn: Callable  # (theta (d,), data) -> (logprior, loglike)
    dim: int
    n_data: int
    data_axis: Optional[str] = None
    local_k: int = 0

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        if data_split(self.data_axis) is not None:
            return self._sharded_log_density(theta)

        def one(th):
            logprior, loglike = self.replay_fn(th, self.data)
            return logprior + self.likeadj * loglike

        return _over_rows(one, theta)

    def _sharded_log_density(self, theta: torch.Tensor) -> torch.Tensor:
        """The replay on this rank's rows of the data axis (and, in local
        mode, their block of theta's local latents); the likelihood summed
        over the axis."""
        axis = self.data_axis
        n = _first_tensor(self.data).shape[0]
        data = _map_data(lambda x: shard_axis0(x, axis), self.data)
        if self.local_k:
            row0, rows = rows_of(n, axis)
            k, dg = self.local_k, self.dim - n * self.local_k
            theta = torch.cat([theta[..., :dg],
                               theta[..., dg + row0 * k: dg + (row0 + rows) * k]], dim=-1)

        def one(th):
            logprior, loglike = self.replay_fn(th, data)
            return torch.stack([th.new_zeros(()) + logprior, th.new_zeros(()) + loglike])

        parts = _over_rows(one, theta, width=2)
        return parts[..., 0] + self.likeadj * data_psum(parts[..., 1], axis)

    def subsample(self, indices: torch.Tensor) -> "PPLTarget":
        batch = indices.shape[0]
        return PPLTarget(
            data=_map_data(lambda x: torch.index_select(x, 0, indices), self.data),
            likeadj=self.likeadj * (self.n_data / batch),
            replay_fn=self.replay_fn,
            dim=self.dim - (self.n_data - batch) * self.local_k,
            n_data=self.n_data,
            data_axis=self.data_axis,
            local_k=self.local_k,
        )


class Model:
    """Target and parameter-space bookkeeping of one model function."""

    def __init__(self, model_fn, data, latents, model_args, model_kwargs, data_axis=None,
                 device="cuda"):
        self._fn = model_fn
        self._data = data
        self.latents = latents  # ordered {name: meta}
        self._args = model_args
        self._kwargs = model_kwargs
        self._data_axis = data_axis
        self.device = torch.device(device)

        self.local_names = [n for n, m in latents.items() if m["in_plate"] and data is not _NO_DATA]
        self.global_names = [n for n in latents if n not in self.local_names]
        if self.local_names:
            self._init_local_mode(latents)
            return
        names = list(latents)
        self._slices = {}
        off = 0
        for n in names:
            sz = _constrained_size(latents[n])
            self._slices[n] = (off, sz, latents[n]["shape"])
            off += sz
        self.dim_constrained = off
        self.transform = stacked(*[(_site_transform(latents[n]), _unconstrained_size(latents[n]))
                                   for n in names])
        self.dim = sum(_unconstrained_size(latents[n]) for n in names)
        self.target = self._build_target()

    # -- local-latent (doubly-stochastic) mode -------------------------------
    def _init_local_mode(self, latents) -> None:
        """Plate-local latents with data subsampling: the VI vector is
        [global unconstrained | (rows, k) local block, row-major], the
        supports of the local sites applied inside the replay (their
        per-datapoint Jacobians are rescaled with the likelihood), so the
        layout holds at every batch size."""
        n_data = _first_tensor(self._data).shape[0]
        for n in self.local_names:
            m = latents[n]
            if m["support"] == "simplex":
                raise ValueError(
                    f"local latent site {n!r} has simplex support; only "
                    "elementwise supports (real/positive/interval) are "
                    "supported inside a subsampled plate."
                )
            if m["plate_size"] != n_data:
                raise ValueError(
                    f"plate size {m['plate_size']} of local site {n!r} != "
                    f"data leading dimension {n_data}."
                )
        self._slices = {}
        off = 0
        for n in self.global_names:
            sz = _constrained_size(latents[n])
            self._slices[n] = (off, sz, latents[n]["shape"])
            off += sz
        self._dg_con = off
        self.transform = stacked(*[
            (_site_transform(latents[n]), _unconstrained_size(latents[n]))
            for n in self.global_names]) if self.global_names else None
        self._dg_unc = sum(_unconstrained_size(latents[n]) for n in self.global_names)
        # local block: a row's slices (event shape = site shape less the plate dim)
        self._local_slices = {}
        row_off = 0
        for n in self.local_names:
            event_shape = latents[n]["shape"][1:]
            k = int(math.prod(event_shape)) if event_shape else 1
            self._local_slices[n] = (row_off, k, event_shape, _site_transform(latents[n]))
            row_off += k
        self.local_k = row_off
        self.n_data = n_data
        self.dim = self._dg_unc + n_data * self.local_k
        self.dim_constrained = self._dg_con + n_data * self.local_k

        def replay_fn(theta, batch_data):
            rows = _first_tensor(batch_data).shape[0]
            values, g_ldj, l_ldj = self._decode(theta, rows)
            rep = _Replayer(values)
            with _HandlerCtx(rep):
                self._fn(batch_data, *self._args, **self._kwargs)
            return rep.logprior + g_ldj, rep.loglike + l_ldj

        self.target = PPLTarget(data=self._data, likeadj=self._one(), replay_fn=replay_fn,
                                dim=self.dim, n_data=n_data, data_axis=self._data_axis,
                                local_k=self.local_k)

    def _one(self) -> torch.Tensor:
        return torch.ones((), device=self.device)

    def _decode(self, theta, rows: int):
        """Unconstrained (..., [global | (rows, k) local]) -> ({site: constrained
        value}, global ldj, per-datapoint ldj summed over the rows)."""
        batch = theta.shape[:-1]
        values, g_ldj, l_ldj = {}, 0.0, 0.0
        if self.global_names:
            g_con, g_ldj = self.transform.forward_and_ldj(_cols(theta, 0, self._dg_unc))
            values.update(_unpack(g_con, self._slices))
        local = _cols(theta, self._dg_unc, theta.shape[-1] - self._dg_unc).reshape(
            *batch, rows, self.local_k)
        for n, (off, k, event_shape, tf) in self._local_slices.items():
            con, ldj = tf.forward_and_ldj(_cols(local, off, k))
            values[n] = con.reshape(*batch, rows, *event_shape)
            l_ldj = l_ldj + torch.sum(ldj, dim=-1)
        return values, g_ldj, l_ldj

    # -- target assembly ---------------------------------------------------
    def _replay(self, theta_constrained, data):
        rep = _Replayer(self.unpack(theta_constrained))
        with _HandlerCtx(rep):
            if data is _NO_DATA:
                self._fn(*self._args, **self._kwargs)
            else:
                self._fn(data, *self._args, **self._kwargs)
        return rep

    def _build_target(self):
        if self._data is _NO_DATA:

            def logjoint(theta, _):
                def one(th):
                    rep = self._replay(th, _NO_DATA)
                    return rep.logprior + rep.loglike

                return _over_rows(one, theta)

            base = fn_target(logjoint, self.dim_constrained)
        else:

            def replay_fn(theta, batch):
                rep = self._replay(theta, batch)
                return rep.logprior, rep.loglike

            base = PPLTarget(data=self._data, likeadj=self._one(), replay_fn=replay_fn,
                             dim=self.dim_constrained, n_data=_first_tensor(self._data).shape[0],
                             data_axis=self._data_axis)
        return TransformedTarget(prob=base, transform=self.transform)

    # -- parameter-space helpers --------------------------------------------
    def unpack(self, theta_constrained: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flat constrained vector(s) (..., dc) -> {site: (..., *shape)}."""
        return _unpack(theta_constrained, self._slices)

    def constrain(self, x_unconstrained: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Unconstrained vector(s) (the VI space) -> {site: constrained value}."""
        if self.local_names:
            rows = (x_unconstrained.shape[-1] - self._dg_unc) // self.local_k
            return self._decode(x_unconstrained, rows)[0]
        return self.unpack(self.transform.forward(x_unconstrained))

    def q_init(self, scale: float = 0.1):
        """A mean-field Gaussian in the unconstrained space (the standard
        ADVI start), or in local-latent mode a ``GlobalLocalFamily`` whose
        local block subsamples with the data; on the model's device."""
        from ..families.location_scale import MeanFieldGaussian

        dev = self.device
        if self.local_names:
            from ..families.local import GlobalLocalFamily, per_datapoint_meanfield

            return GlobalLocalFamily(
                global_q=MeanFieldGaussian(torch.zeros(self._dg_unc, device=dev),
                                           scale * torch.ones(self._dg_unc, device=dev)),
                local_q=per_datapoint_meanfield(self.n_data, self.local_k, scale, device=dev),
            )
        return MeanFieldGaussian(torch.zeros(self.dim, device=dev),
                                 scale * torch.ones(self.dim, device=dev))

    def posterior(self, q) -> TransformedDistribution:
        """The fitted unconstrained family pushed to the constrained space."""
        if self.local_names:
            raise ValueError(
                "local-latent models have no single flat bijection "
                "(per-site transforms are applied per plate row); use "
                "sample_posterior() or constrain()."
            )
        return TransformedDistribution(base=q, transform=self.transform)

    def sample_posterior(self, key, q, n_samples: int) -> Dict[str, torch.Tensor]:
        """Constrained posterior draws of every site, stacked on axis 0."""
        if self.local_names:
            return self.constrain(q.sample(key, n_samples))
        return self.unpack(self.posterior(q).sample(key, n_samples))


_NO_DATA = object()


def _run_tracer(model_fn, generator, device, data, model_args, model_kwargs) -> _Tracer:
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    tracer = _Tracer(generator, device)
    with _HandlerCtx(tracer):
        if data is _NO_DATA:
            model_fn(*model_args, **model_kwargs)
        else:
            model_fn(data, *model_args, **model_kwargs)
    return tracer


def ingest(
    model_fn: Callable,
    data: Any = _NO_DATA,
    *model_args,
    seed: int = 0,
    data_axis: Optional[str] = None,
    device="cuda",
    **model_kwargs,
) -> Model:
    """Trace ``model_fn`` once and build the target ready to fit.

    ``data``: an optional pytree (tensor, dict, tuple or list) of tensors or
    numpy arrays, leading dim = plate size, passed as the model's first
    argument; it goes to ``device`` and enables the minibatch subsampling of
    plate-observed sites with the likelihood rescaled.  Without it the model
    takes only ``model_args`` / ``model_kwargs`` and the target is full
    batch.  ``seed`` seeds the trace pass's torch generator.  ``data_axis``:
    the mesh axis that splits the data rows (parallel/mesh.py)."""
    if data is not _NO_DATA:
        data = _to_device(data, device)
    tracer = _run_tracer(model_fn, seed, device, data, model_args, model_kwargs)
    latents = {n: m for n, m in tracer.sites.items() if not m["observed"]}
    if not latents:
        raise ValueError("model declares no latent sites; nothing to infer")
    return Model(model_fn, data, latents, model_args, model_kwargs, data_axis=data_axis,
                 device=device)


def prior_predictive(
    model_fn: Callable, generator, data: Any = _NO_DATA, *model_args, device="cuda",
    **model_kwargs,
) -> Dict[str, torch.Tensor]:
    """One joint draw of every latent site from the prior; ``generator``: an
    int seed or a ``torch.Generator``."""
    if data is not _NO_DATA:
        data = _to_device(data, device)
    tracer = _run_tracer(model_fn, generator, device, data, model_args, model_kwargs)
    return {n: m["init"] for n, m in tracer.sites.items() if not m["observed"]}
