"""Normalizing-flow families and their ELBO (port of families/flows.py).

A flow pushes a mean-field Gaussian base draw z0 = u s + m through K layers
and tracks log q along the way (``sample_and_log_prob``); ``FlowELBO`` is
the Monte-Carlo-entropy ELBO on that contract, or with
``entropy="stl"`` the frozen density at the live draws, which needs an
analytic inverse (``log_prob``): the coupling flow has one, the planar and
radial flows do not.

The base draw is one launch of the mean-field sampler (K7a,
csrc/meanfield_sample.cu) at (n, d) on the base location and scale; a
float64 flow draws u through ops/base_draws.py.  The layers are plain
torch, a Python loop where JAX scans: per layer one (n, d) x (d,)
contraction and an elementwise block (planar, radial), or the
conditioner's (n, d) x (d, h) and (n, h) x (h, 2d) products (coupling),
which the JAX package also forms outside Pallas.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.pytree import tree_stop_gradient, value_and_grad
from ..objectives.repgradelbo import base_noise
from ..parallel.mesh import mc_rows
from ..ops import base_draws
from ..ops.cuda.location_scale_kernels import as_key, meanfield_sample, seed_words
from .base import Normal
from .location_scale import take_rows

_LOG_2PI = math.log(2.0 * math.pi)


def _base_draw(q, key, n_samples: int):
    """(z0, u) of the flow's mean-field base, (n, d) each."""
    m, s = q.base_location, q.base_scale_diag
    if m.dtype == torch.float32:
        k = as_key(key)
        return meanfield_sample(k.seed, k.it, m, s, n_samples)
    u = base_draws.draw(Normal(), key, n_samples, q.dim, m.dtype, m.device)
    return u * s + m, u


def _base_log_prob(q, u: torch.Tensor) -> torch.Tensor:
    return (torch.sum(-0.5 * (u * u), dim=-1) - 0.5 * q.dim * _LOG_2PI
            - torch.sum(torch.log(torch.abs(q.base_scale_diag))))


class _Flow:
    """The shared sampling contract: a subclass defines ``_push(z, logq)``."""

    @property
    def dim(self) -> int:
        return self.base_location.shape[-1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw (``sample_and_log_prob_from_base``)."""
        return self.dim

    def sample_and_log_prob(self, key, n_samples: int):
        """Reparameterized draws and their log-density under q."""
        z0, u = _base_draw(self, key, n_samples)
        return self._push(z0, _base_log_prob(self, u))

    def sample_and_log_prob_from_base(self, u: torch.Tensor):
        """The same for given (n, d) base draws u."""
        return self._push(u * self.base_scale_diag + self.base_location,
                          _base_log_prob(self, u))

    def sample(self, key, n_samples: int) -> torch.Tensor:
        return self.sample_and_log_prob(key, n_samples)[0]


def _init_generator(seed) -> torch.Generator:
    """A CPU generator keyed by ``seed``'s words: a fresh flow's random
    parameters are the same numbers on every device."""
    return base_draws.generator(seed_words(seed), "cpu")


@dataclass(frozen=True)
class PlanarFlowFamily(_Flow):
    """Mean-field Gaussian base through K planar layers (Rezende & Mohamed
    2015), f(z) = z + a_hat tanh(w . z + b), with a_hat = a + (softplus(w.a)
    - 1 - w.a) w / |w|^2 so that w . a_hat >= -1 (invertible)."""

    base_location: torch.Tensor  # (d,)
    base_scale_diag: torch.Tensor  # (d,)
    w: torch.Tensor  # (K, d)
    a: torch.Tensor  # (K, d)
    b: torch.Tensor  # (K,)

    @property
    def n_layers(self) -> int:
        return self.w.shape[0]

    @staticmethod
    def _a_hat(w, a):
        """a_hat of every layer at once: (K, d) w and a."""
        wa = torch.sum(w * a, dim=-1, keepdim=True)
        m = F.softplus(wa) - 1.0
        return a + (m - wa) * w / (torch.sum(w * w, dim=-1, keepdim=True) + 1e-12)

    def _push(self, z, logq):
        # the layers' own terms in one pass, then a short loop over the draws
        a_hat = self._a_hat(self.w, self.a)
        w_a_hat = torch.sum(self.w * a_hat, dim=-1)
        for w, b, ah, wah in zip(self.w, self.b, a_hat, w_a_hat):
            t = torch.tanh(z @ w + b)  # (n,)
            z = z + t[:, None] * ah
            # |det J| = |1 + (1 - tanh^2) w . a_hat|
            det = 1.0 + (1.0 - t * t) * wah
            logq = logq - torch.log(torch.abs(det) + 1e-12)
        return z, logq


def planar_flow(
seed, dim: int, n_layers: int = 8, dtype=torch.float32,
                device="cuda") -> PlanarFlowFamily:
    """A fresh near-identity planar flow: standard base, w and a 0.1 N(0, 1)."""
    g = _init_generator(seed)
    w = 0.1 * torch.randn((n_layers, dim), dtype=dtype, generator=g)
    a = 0.1 * torch.randn((n_layers, dim), dtype=dtype, generator=g)
    return PlanarFlowFamily(
        base_location=torch.zeros(dim, dtype=dtype, device=device),
        base_scale_diag=torch.ones(dim, dtype=dtype, device=device),
        w=w.to(device), a=a.to(device),
        b=torch.zeros(n_layers, dtype=dtype, device=device),
    )


@dataclass(frozen=True)
class RadialFlowFamily(_Flow):
    """Mean-field Gaussian base through K radial layers,
    f(z) = z + beta_hat h (z - z0), r = |z - z0|, h = 1 / (alpha + r), with
    alpha = softplus(alpha_raw) and beta_hat = -alpha + softplus(beta_raw);
    log|det J| = (d - 1) log(1 + beta_hat h) + log(1 + beta_hat h
    - beta_hat r / (alpha + r)^2)."""

    base_location: torch.Tensor  # (d,)
    base_scale_diag: torch.Tensor  # (d,)
    z0: torch.Tensor  # (K, d)
    alpha_raw: torch.Tensor  # (K,)
    beta_raw: torch.Tensor  # (K,)

    @property
    def n_layers(self) -> int:
        return self.z0.shape[0]

    def _push(self, z, logq):
        d = self.dim
        alphas = F.softplus(self.alpha_raw)
        betas = -alphas + F.softplus(self.beta_raw)
        for z0, alpha, beta in zip(self.z0, alphas, betas):
            diff = z - z0
            r = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
            ar = alpha + r
            h = 1.0 / ar
            bh = beta * h
            z = z + bh[:, None] * diff
            radial = 1.0 + bh - beta * r / (ar * ar)
            logdet = (d - 1) * torch.log(torch.abs(1.0 + bh) + 1e-12) + torch.log(
                torch.abs(radial) + 1e-12)
            logq = logq - logdet
        return z, logq


def radial_flow(
seed, dim: int, n_layers: int = 8, dtype=torch.float32,
                device="cuda") -> RadialFlowFamily:
    """A fresh near-identity radial flow (beta_hat ~ 0: softplus(1) on both
    raw parameters), centres 0.1 N(0, 1)."""
    z0 = 0.1 * torch.randn((n_layers, dim), dtype=dtype, generator=_init_generator(seed))
    return RadialFlowFamily(
        base_location=torch.zeros(dim, dtype=dtype, device=device),
        base_scale_diag=torch.ones(dim, dtype=dtype, device=device),
        z0=z0.to(device),
        alpha_raw=torch.full((n_layers,), 1.0, dtype=dtype, device=device),
        beta_raw=torch.full((n_layers,), 1.0, dtype=dtype, device=device),
    )


@dataclass(frozen=True)
class CouplingFlowFamily(_Flow):
    """RealNVP-style affine coupling with an analytic inverse.  Layer k
    keeps the coordinates of the mask m_k[i] = (i + k) % 2 and moves the
    rest, y = m z + (1 - m) (z exp(s(m z)) + t(m z)), (s, t) from a small
    MLP on the kept coordinates, s = s_cap tanh(s_raw / s_cap); log|det J|
    = sum((1 - m) s).  The inverse is closed form, so ``log_prob`` exists
    and ``FlowELBO(entropy="stl")`` applies."""

    base_location: torch.Tensor  # (d,)
    base_scale_diag: torch.Tensor  # (d,)
    W1: torch.Tensor  # (K, d, h)
    b1: torch.Tensor  # (K, h)
    W2: torch.Tensor  # (K, h, 2d)
    b2: torch.Tensor  # (K, 2d)
    s_cap: float = 2.0

    @property
    def n_layers(self) -> int:
        return self.W1.shape[0]

    def _layers(self):
        """Per layer: the mask m_k, 1 - m_k and the conditioner's weights."""
        idx = torch.arange(self.n_layers, device=self.base_location.device)[:, None] + \
            torch.arange(self.dim, device=self.base_location.device)
        masks = (idx % 2).to(self.base_location.dtype)  # (K, d)
        return zip(masks, 1.0 - masks, self.W1, self.b1, self.W2, self.b2)

    def _st(self, z_masked, W1, b1, W2, b2):
        h = torch.tanh(z_masked @ W1 + b1)
        st = h @ W2 + b2
        s_raw, t = st[..., : self.dim], st[..., self.dim:]
        return self.s_cap * torch.tanh(s_raw / self.s_cap), t

    def _push(self, z, logq):
        for m, keep, *weights in self._layers():
            s, t = self._st(m * z, *weights)
            z = m * z + keep * (z * torch.exp(s) + t)
            logq = logq - torch.sum(keep * s, dim=-1)
        return z, logq

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """The density at any point, through the analytic inverse."""
        squeeze = z.ndim == 1
        if squeeze:
            z = z[None, :]
        acc = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for m, keep, *weights in reversed(list(self._layers())):
            s, t = self._st(m * z, *weights)
            z = m * z + keep * (z - t) * torch.exp(-s)
            acc = acc + torch.sum(keep * s, dim=-1)
        u = (z - self.base_location) / self.base_scale_diag
        logq = _base_log_prob(self, u) - acc
        return logq[0] if squeeze else logq


def coupling_flow(
seed, dim: int, n_layers: int = 8, hidden: int = 32, dtype=torch.float32,
                  device="cuda") -> CouplingFlowFamily:
    """A fresh identity coupling flow (W2 = 0, so s = t = 0), W1 N(0, 1/d)."""
    W1 = torch.randn((n_layers, dim, hidden), dtype=dtype, generator=_init_generator(seed))
    return CouplingFlowFamily(
        base_location=torch.zeros(dim, dtype=dtype, device=device),
        base_scale_diag=torch.ones(dim, dtype=dtype, device=device),
        W1=((1.0 / math.sqrt(dim)) * W1).to(device),
        b1=torch.zeros((n_layers, hidden), dtype=dtype, device=device),
        W2=torch.zeros((n_layers, hidden, 2 * dim), dtype=dtype, device=device),
        b2=torch.zeros((n_layers, 2 * dim), dtype=dtype, device=device),
    )


_FLOW_ENTROPIES = ("monte_carlo", "stl")


@dataclass(frozen=True)
class FlowELBO:
    """ELBO for families with ``sample_and_log_prob`` (a ``ParamSpaceSGD``
    objective): the gradient of -(E log pi(z) - E log q(z)) with
    reparameterized z.  ``entropy``: "monte_carlo" (the density along the
    sampling path; every flow) or "stl" (the frozen density at the live
    draws; a family with ``log_prob``).  ``mc_axis``: the mesh axis that
    splits the samples (parallel/mesh.py); a rank draws the whole batch
    through the flow and evaluates the target on its rows, weighted by
    rows / n."""

    n_samples: int = 1
    mc_axis: Optional[str] = None
    entropy: str = "monte_carlo"

    def __post_init__(self):
        if self.entropy not in _FLOW_ENTROPIES:
            raise ValueError(
                f"FlowELBO entropy must be 'monte_carlo' or 'stl', got {self.entropy!r}"
            )

    def init(self, seed, q, prob):
        if self.entropy == "stl" and not hasattr(q, "log_prob"):
            raise ValueError(
                "FlowELBO(entropy='stl') requires a family with log_prob "
                "(an analytic flow inverse, e.g. CouplingFlowFamily); "
                f"{type(q).__name__} tracks density only along the sampling "
                "path."
            )
        return ()

    def loss(self, q, prob, key, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            z, logq = q.sample_and_log_prob(key, self.n_samples)
        else:
            z, logq = q.sample_and_log_prob_from_base(base_noise(q, noise, self.n_samples))
        rows = mc_rows(self.n_samples, self.mc_axis)
        z, logq = take_rows(z, rows), take_rows(logq, rows)
        if self.entropy == "stl":
            ent = -torch.mean(tree_stop_gradient(q).log_prob(z))
        else:
            ent = -torch.mean(logq)
        nelbo = -(torch.mean(prob.log_density(z)) + ent)
        return nelbo if rows is None else nelbo * (rows[1] / self.n_samples)

    def _loss_and_aux(self, q, prob, key, noise: Optional[torch.Tensor] = None):
        nelbo = self.loss(q, prob, key, noise)
        return nelbo, {"elbo": -nelbo.detach()}

    def value_and_grad(self, q, prob, key, obj_state=(), noise=None):
        """One gradient estimate; returns (grad family, obj_state, info).
        ``noise``: (n_samples, d) base draws that replace the sampler."""
        grad, info = value_and_grad(lambda live: self._loss_and_aux(live, prob, key, noise), q,
                                    self.mc_axis)
        return grad, obj_state, info

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        n = n_samples if n_samples is not None else self.n_samples
        z, logq = q.sample_and_log_prob(key, n)
        return -(torch.mean(prob.log_density(z)) - torch.mean(logq))
