"""Distributions of the model-ingestion DSL (port of ppl/dists.py).

Each distribution is a small dataclass with ``log_prob`` (elementwise torch
ops), ``sample(generator, shape=None)`` (prior draws from an explicit
``torch.Generator``, used by the trace pass of ``ppl.ingest`` and by
``prior_predictive``) and a ``support`` tag that ingestion maps onto a
Transform (core/transforms.py).  Discrete distributions have ``support =
"discrete"`` and may only be observed.

Parameters are Python numbers or tensors.  Where the reference calls
``gammaln`` / ``betaln`` on parameters that are Python numbers (Gamma, Beta,
StudentT's ``df``, Exponential's and the scales' logs), the constant is
computed on the host with ``math``, so a model with fixed hyperparameters
keeps to the ops of the fused AD body (K5, ops/cuda/ad_body.py); on a tensor
parameter it is ``torch.special.gammaln``, which K5 refuses by name (lgamma).
``tests/test_torch_ppl.py`` records which distributions trace into K5.

Draws are made on the generator's device in float32 and moved to the
device of the tensor parameters.  A Python number is never the left operand
of a subtraction from a tensor (``c - t`` traces as ``rsub``, which K5 does
not take): ``-t + c`` is the same float, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..core.transforms import softplus

_LOG_2PI = math.log(2.0 * math.pi)

Param = Any  # a Python number or a tensor


def _log(v: Param):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _softplus(v: Param):
    if isinstance(v, torch.Tensor):
        return softplus(v)
    return max(v, 0.0) + math.log1p(math.exp(-abs(v)))


def _lgamma(v: Param):
    return torch.special.gammaln(v) if isinstance(v, torch.Tensor) else math.lgamma(v)


def _shape(*params: Param) -> Tuple[int, ...]:
    return tuple(torch.broadcast_shapes(*(p.shape if isinstance(p, torch.Tensor) else ()
                                         for p in params)))


def _device(*params: Param) -> torch.device:
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


def _as_tensor(v: Param, shape, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.tensor(float(v))
    return t.to(device=device, dtype=torch.float32).expand(shape)


def _randn(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device).to(device)


def _rand(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device).to(device)


def _gamma(g: torch.Generator, conc: Param, shape, device) -> torch.Tensor:
    """Standard gamma draws of concentration ``conc``, broadcast to ``shape``."""
    a = _as_tensor(conc, shape, g.device).contiguous()
    return torch._standard_gamma(a, generator=g).to(device)


@dataclass(frozen=True)
class Normal:
    loc: Param = 0.0
    scale: Param = 1.0
    support: str = "real"

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z) - _log(self.scale) - 0.5 * _LOG_2PI

    def sample(self, generator, shape=None):
        shape = _shape(self.loc, self.scale) if shape is None else tuple(shape)
        return self.loc + self.scale * _randn(generator, shape, _device(self.loc, self.scale))


@dataclass(frozen=True)
class LogNormal:
    loc: Param = 0.0
    scale: Param = 1.0
    support: str = "positive"

    def log_prob(self, x):
        lx = torch.log(x)
        z = (lx - self.loc) / self.scale
        return -0.5 * (z * z) - _log(self.scale) - 0.5 * _LOG_2PI - lx

    def sample(self, generator, shape=None):
        shape = _shape(self.loc, self.scale) if shape is None else tuple(shape)
        dev = _device(self.loc, self.scale)
        return torch.exp(self.loc + self.scale * _randn(generator, shape, dev))


@dataclass(frozen=True)
class HalfNormal:
    scale: Param = 1.0
    support: str = "positive"

    def log_prob(self, x):
        z = x / self.scale
        return -0.5 * (z * z) + math.log(2.0) - _log(self.scale) - 0.5 * _LOG_2PI

    def sample(self, generator, shape=None):
        shape = _shape(self.scale) if shape is None else tuple(shape)
        return self.scale * torch.abs(_randn(generator, shape, _device(self.scale)))


@dataclass(frozen=True)
class HalfCauchy:
    scale: Param = 1.0
    support: str = "positive"

    def log_prob(self, x):
        z = x / self.scale
        return -torch.log1p(z * z) + (math.log(2.0 / math.pi) - _log(self.scale))

    def sample(self, generator, shape=None):
        shape = _shape(self.scale) if shape is None else tuple(shape)
        u = _rand(generator, shape, _device(self.scale))
        return self.scale * torch.abs(torch.tan(math.pi * (u - 0.5)))


@dataclass(frozen=True)
class Exponential:
    rate: Param = 1.0
    support: str = "positive"

    def log_prob(self, x):
        return -(self.rate * x) + _log(self.rate)

    def sample(self, generator, shape=None):
        shape = _shape(self.rate) if shape is None else tuple(shape)
        u = _rand(generator, shape, _device(self.rate))
        return -torch.log1p(-u) / self.rate


@dataclass(frozen=True)
class Gamma:
    concentration: Param = 1.0
    rate: Param = 1.0
    support: str = "positive"

    def log_prob(self, x):
        a, b = self.concentration, self.rate
        return a * _log(b) + (a - 1.0) * torch.log(x) - b * x - _lgamma(a)

    def sample(self, generator, shape=None):
        a, b = self.concentration, self.rate
        shape = _shape(a, b) if shape is None else tuple(shape)
        return _gamma(generator, a, shape, _device(a, b)) / b


@dataclass(frozen=True)
class Beta:
    a: Param = 1.0
    b: Param = 1.0
    support: str = "unit_interval"

    def log_prob(self, x):
        betaln = _lgamma(self.a) + _lgamma(self.b) - _lgamma(self.a + self.b)
        return (self.a - 1.0) * torch.log(x) + (self.b - 1.0) * torch.log1p(-x) - betaln

    def sample(self, generator, shape=None):
        shape = _shape(self.a, self.b) if shape is None else tuple(shape)
        dev = _device(self.a, self.b)
        ga, gb = _gamma(generator, self.a, shape, dev), _gamma(generator, self.b, shape, dev)
        return ga / (ga + gb)


@dataclass(frozen=True)
class Uniform:
    lo: float = 0.0  # defines the support
    hi: float = 1.0
    support: str = "interval"

    def log_prob(self, x):
        return x.new_zeros(x.shape) - math.log(self.hi - self.lo)

    def sample(self, generator, shape=None):
        shape = () if shape is None else tuple(shape)
        return self.lo + (self.hi - self.lo) * _rand(generator, shape, torch.device("cpu"))


@dataclass(frozen=True)
class StudentT:
    df: float = 5.0  # a Python number: the normalizing constant is the host's
    loc: Param = 0.0
    scale: Param = 1.0
    support: str = "real"

    def log_prob(self, x):
        nu = self.df
        z = (x - self.loc) / self.scale
        lognorm = math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0) - 0.5 * math.log(
            nu * math.pi)
        return -((nu + 1.0) / 2.0 * torch.log1p(z * z / nu)) + lognorm - _log(self.scale)

    def sample(self, generator, shape=None):
        shape = _shape(self.loc, self.scale) if shape is None else tuple(shape)
        dev = _device(self.loc, self.scale)
        chi2 = 2.0 * _gamma(generator, self.df / 2.0, shape, dev)
        t = _randn(generator, shape, dev) / torch.sqrt(chi2 / self.df)
        return self.loc + self.scale * t


@dataclass(frozen=True)
class Laplace:
    loc: Param = 0.0
    scale: Param = 1.0
    support: str = "real"

    def log_prob(self, x):
        return -torch.abs(x - self.loc) / self.scale - _log(2.0 * self.scale)

    def sample(self, generator, shape=None):
        shape = _shape(self.loc, self.scale) if shape is None else tuple(shape)
        u = _rand(generator, shape, _device(self.loc, self.scale)) - 0.5
        return self.loc - self.scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


@dataclass(frozen=True)
class Dirichlet:
    concentration: Optional[torch.Tensor] = None
    support: str = "simplex"

    def log_prob(self, x):
        """The joint density of the last axis (a simplex is a block
        support); a site sums it once more."""
        a = self.concentration
        return (torch.sum((a - 1.0) * torch.log(x), dim=-1)
                - torch.sum(torch.special.gammaln(a), dim=-1)
                + torch.special.gammaln(torch.sum(a, dim=-1)))

    def sample(self, generator, shape=None):
        a = self.concentration
        g = _gamma(generator, a, tuple(a.shape), a.device)
        return g / torch.sum(g, dim=-1, keepdim=True)


# --- observation-only (discrete) distributions -----------------------------


@dataclass(frozen=True)
class Bernoulli:
    logits: Param = 0.0
    support: str = "discrete"

    def log_prob(self, y):
        """y in {0, 1}: y l - softplus(l) (the logit parameterization)."""
        return y * self.logits - _softplus(self.logits)

    def sample(self, generator, shape=None):
        shape = _shape(self.logits) if shape is None else tuple(shape)
        p = torch.sigmoid(_as_tensor(self.logits, shape, generator.device))
        return torch.bernoulli(p, generator=generator).to(_device(self.logits))


@dataclass(frozen=True)
class Poisson:
    rate: Param = 1.0
    support: str = "discrete"

    def log_prob(self, y):
        return y * _log(self.rate) - self.rate - torch.special.gammaln(y + 1.0)

    def sample(self, generator, shape=None):
        shape = _shape(self.rate) if shape is None else tuple(shape)
        rate = _as_tensor(self.rate, shape, generator.device).contiguous()
        return torch.poisson(rate, generator=generator).to(_device(self.rate))


@dataclass(frozen=True)
class Categorical:
    logits: Optional[torch.Tensor] = None
    support: str = "discrete"

    def log_prob(self, y):
        logp = torch.log_softmax(self.logits, dim=-1)
        y = torch.as_tensor(y).long()
        if logp.dim() == 1:  # shared class probabilities, batched labels
            return logp[y]
        return torch.gather(logp, -1, y[..., None])[..., 0]

    def sample(self, generator, shape=None):
        probs = torch.softmax(self.logits, dim=-1).to(generator.device)
        flat = probs.reshape(-1, probs.shape[-1])
        draw = torch.multinomial(flat, 1, generator=generator)[:, 0]
        return draw.reshape(probs.shape[:-1]).to(self.logits.device)
