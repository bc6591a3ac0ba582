"""Mixtures of Gaussians and the stratified ELBO (port of families/mixture.py).

A K-component mixture q(z) = sum_k w_k q_k(z), w = softmax(logits), with
mean-field or full-rank components, and ``MixtureELBO``, the stratified
ELBO sum_k w_k E_{z ~ q_k}[log pi(z) - log q(z)] from n draws of every
component, a (K, n, d) batch in which every term is pathwise.

The stratified draw is one launch of the mean-field sampler (K7a,
csrc/meanfield_sample.cu) over the flat (n, K d) width: for the mean-field
mixture at location ``locations`` and scale ``scale_diags`` flattened, so
the kernel forms u s_k + m_k itself; for the full-rank mixture at zero
location and unit scale, then the batched product
einsum("knd,ked->kne", u, tril C) + m_k.  Row i, columns [k d, (k + 1) d)
of the launch are component k's draw i.  A float64 mixture draws its u
through ops/base_draws.py.  The ancestral ``sample`` (diagnostics only)
draws component indices and u from one torch generator a step
(ops/base_draws.py's ``key_generator``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.problem import maybe_wrap_custom_grad
from ..core.pytree import tree_stop_gradient, value_and_grad
from ..ops import base_draws
from ..ops.cuda.location_scale_kernels import as_key, meanfield_sample, seed_words
from ..parallel.mesh import psum, rows_of, terms_split
from .base import Normal
from .location_scale import standard_draw

_LOG_2PI = math.log(2.0 * math.pi)


def _components(u_flat: torch.Tensor, K: int) -> torch.Tensor:
    """(n, K d) -> (K, n, d): component k's draws in columns [k d, (k + 1) d)."""
    n = u_flat.shape[0]
    return u_flat.reshape(n, K, -1).permute(1, 0, 2)


def _span(K: int, comps) -> slice:
    """The components ``comps=(k0, count)`` as a slice (all K for None)."""
    return slice(0, K) if comps is None else slice(comps[0], comps[0] + comps[1])


def _ancestral(q, key, n_samples: int):
    """(component index, u) of n ancestral draws from the step's generator."""
    dev = q.locations.device
    g = base_draws.key_generator(key, dev)
    comps = torch.multinomial(q.weights().detach(), n_samples, replacement=True, generator=g)
    u = torch.randn((n_samples, q.dim), dtype=q.locations.dtype, device=dev, generator=g)
    return comps, u


def _init_locations(seed, dim: int, n_components: int, spread: float, dtype, device):
    """spread * N(0, 1) locations from a CPU generator keyed by ``seed``'s
    words (the same numbers on every device)."""
    g = base_draws.generator(seed_words(seed), "cpu")
    locs = torch.randn((n_components, dim), dtype=dtype, generator=g)
    return (spread * locs).to(device)


@dataclass(frozen=True)
class MixtureMeanField:
    """K-component mean-field Gaussian mixture."""

    logits: torch.Tensor  # (K,)
    locations: torch.Tensor  # (K, d)
    scale_diags: torch.Tensor  # (K, d)

    @property
    def dim(self) -> int:
        return self.locations.shape[-1]

    @property
    def n_components(self) -> int:
        return self.locations.shape[0]

    def weights(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def sample_stratified_with_base(self, key, n_per_component: int, comps=None):
        """(z, u), both (K, n, d): n reparameterized draws of every
        component, one K7a launch for a float32 mixture; ``comps=(k0,
        count)``: those components' (the launch stays whole)."""
        K, mine = self.n_components, _span(self.n_components, comps)
        if self.locations.dtype == torch.float32:
            k = as_key(key)
            z, u = meanfield_sample(k.seed, k.it, self.locations.reshape(-1),
                                    self.scale_diags.reshape(-1), n_per_component)
            return _components(z, K)[mine], _components(u, K)[mine]
        u = _components(standard_draw(Normal(), key, n_per_component, K * self.dim,
                                      self.locations.dtype, self.locations.device), K)[mine]
        return self.stratified_from_base(u, comps), u

    def sample_stratified(self, key, n_per_component: int, comps=None) -> torch.Tensor:
        return self.sample_stratified_with_base(key, n_per_component, comps)[0]

    def stratified_from_base(self, u: torch.Tensor, comps=None) -> torch.Tensor:
        """z_k = u_k s_k + m_k for given (K, n, d) draws (``comps``: u holds
        those components' draws alone)."""
        mine = _span(self.n_components, comps)
        return u * self.scale_diags[mine, None, :] + self.locations[mine, None, :]

    def sample(self, key, n_samples: int) -> torch.Tensor:
        """Ancestral draws (generation and diagnostics, not the training path)."""
        comps, u = _ancestral(self, key, n_samples)
        return u * self.scale_diags[comps] + self.locations[comps]

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """log sum_k w_k N(z; m_k, s_k) by logsumexp; z (..., d)."""
        diff = (z[..., None, :] - self.locations) / self.scale_diags  # (..., K, d)
        comp_lp = (
            -0.5 * torch.sum(diff * diff, dim=-1)
            - torch.sum(torch.log(torch.abs(self.scale_diags)), dim=-1)
            - 0.5 * self.dim * _LOG_2PI
        )
        logw = torch.log_softmax(self.logits, dim=-1)
        return torch.logsumexp(comp_lp + logw, dim=-1)

    def mean(self) -> torch.Tensor:
        return torch.einsum("k,kd->d", self.weights(), self.locations)

    def var(self) -> torch.Tensor:
        w, m = self.weights(), self.mean()
        second = torch.einsum(
            "k,kd->d", w, self.scale_diags * self.scale_diags + self.locations * self.locations)
        return second - m * m

    def cov(self) -> torch.Tensor:
        w, m = self.weights(), self.mean()
        cov = torch.einsum("k,kd,ke->de", w, self.locations, self.locations) - torch.outer(m, m)
        return cov + torch.diag(torch.einsum("k,kd->d", w, self.scale_diags * self.scale_diags))


@dataclass(frozen=True)
class MixtureFullRank:
    """K-component full-rank Gaussian mixture; each component's Cholesky
    scale has its strict upper triangle inert (read through tril)."""

    logits: torch.Tensor  # (K,)
    locations: torch.Tensor  # (K, d)
    scales: torch.Tensor  # (K, d, d), lower-triangular by convention

    @property
    def dim(self) -> int:
        return self.locations.shape[-1]

    @property
    def n_components(self) -> int:
        return self.locations.shape[0]

    def weights(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def _tril(self) -> torch.Tensor:
        return torch.tril(self.scales)

    def sample_stratified_with_base(self, key, n_per_component: int, comps=None):
        """(z, u), both (K, n, d): u from one K7a launch (float32) at zero
        location and unit scale, then one batched product; ``comps=(k0,
        count)``: those components' (the launch stays whole, the product
        takes their factors alone)."""
        K = self.n_components
        u = _components(standard_draw(Normal(), key, n_per_component, K * self.dim,
                                      self.locations.dtype, self.locations.device), K)
        u = u[_span(K, comps)]
        return self.stratified_from_base(u, comps), u

    def sample_stratified(self, key, n_per_component: int, comps=None) -> torch.Tensor:
        return self.sample_stratified_with_base(key, n_per_component, comps)[0]

    def stratified_from_base(self, u: torch.Tensor, comps=None) -> torch.Tensor:
        """z_k = u_k C_k^T + m_k for given (K, n, d) draws (``comps``: u holds
        those components' draws alone)."""
        mine = _span(self.n_components, comps)
        return (torch.einsum("knd,ked->kne", u, torch.tril(self.scales[mine]))
                + self.locations[mine, None, :])

    def sample(self, key, n_samples: int) -> torch.Tensor:
        comps, u = _ancestral(self, key, n_samples)
        C = self._tril()[comps]  # (n, d, d)
        return torch.einsum("nd,ned->ne", u, C) + self.locations[comps]

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        d, K = self.dim, self.n_components
        C = self._tril()
        diff = z[..., None, :] - self.locations  # (..., K, d)
        flat = torch.movedim(diff, -2, 0).reshape(K, -1, d)  # (K, N, d)
        v = torch.linalg.solve_triangular(C, flat.transpose(1, 2), upper=False)  # (K, d, N)
        quad = torch.sum(v * v, dim=1)  # (K, N)
        logdet = torch.sum(torch.log(torch.abs(torch.diagonal(C, dim1=-2, dim2=-1))), dim=-1)
        comp_lp = -0.5 * quad - logdet[:, None] - 0.5 * d * _LOG_2PI
        logw = torch.log_softmax(self.logits, dim=-1)
        out = torch.logsumexp(comp_lp + logw[:, None], dim=0)
        return out.reshape(diff.shape[:-2])

    def mean(self) -> torch.Tensor:
        return torch.einsum("k,kd->d", self.weights(), self.locations)

    def cov(self) -> torch.Tensor:
        w, m = self.weights(), self.mean()
        C = self._tril()
        comp_cov = torch.einsum("kde,kfe->kdf", C, C)
        second = torch.einsum("k,kdf->df", w, comp_cov) + torch.einsum(
            "k,kd,ke->de", w, self.locations, self.locations)
        return second - torch.outer(m, m)

    def var(self) -> torch.Tensor:
        return torch.diagonal(self.cov())


def mixture_fullrank(
    seed,
    dim: int,
    n_components: int,
    init_scale: float = 1.0,
    spread: float = 1.0,
    dtype=torch.float32,
    device="cuda",
) -> MixtureFullRank:
    """A fresh full-rank mixture: jittered locations, identity-scaled
    components, equal weights."""
    locs = _init_locations(seed, dim, n_components, spread, dtype, device)
    eye = init_scale * torch.eye(dim, dtype=dtype, device=device)
    return MixtureFullRank(
        logits=torch.zeros(n_components, dtype=dtype, device=device),
        locations=locs,
        scales=eye.expand(n_components, dim, dim).clone(),
    )


def mixture_meanfield(
    seed,
    dim: int,
    n_components: int,
    init_scale: float = 1.0,
    spread: float = 1.0,
    dtype=torch.float32,
    device="cuda",
) -> MixtureMeanField:
    """A fresh mean-field mixture: components jittered around the origin,
    equal weights.  The locations come from a CPU generator keyed by
    ``seed``'s words, so every device starts from the same numbers."""
    return MixtureMeanField(
        logits=torch.zeros(n_components, dtype=dtype, device=device),
        locations=_init_locations(seed, dim, n_components, spread, dtype, device),
        scale_diags=torch.full((n_components, dim), float(init_scale), dtype=dtype,
                               device=device),
    )


_MIXTURE_ENTROPIES = ("monte_carlo", "stl")


@dataclass(frozen=True)
class MixtureELBO:
    """Stratified-sampling ELBO for the mixtures (a ``ParamSpaceSGD``
    objective).

    Args:
      n_samples: reparameterized draws a component a step.
      entropy: "monte_carlo" (log q differentiated) or "stl" (log q's
        parameters stopped: the path derivative only).
      ep_axis: the component axis over a device mesh: each rank evaluates
        its components' draws, and the shares are summed over the axis.
    """

    n_samples: int = 4
    entropy: str = "stl"
    ep_axis: Optional[str] = None

    def init(self, seed, q, prob):
        return ()

    def _draw(self, q, key, noise: Optional[torch.Tensor], comps) -> torch.Tensor:
        if noise is None:
            return q.sample_stratified(key, self.n_samples, comps)
        u = noise.to(device=q.locations.device, dtype=q.locations.dtype)
        expect = (q.n_components, self.n_samples, q.dim)
        if tuple(u.shape) != expect:
            raise ValueError(f"noise must have shape {expect}, got {tuple(u.shape)}")
        return q.stratified_from_base(u[_span(q.n_components, comps)], comps)

    def loss(self, q, prob, key, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-ELBO; under a mesh with ``ep_axis`` this rank's share, the terms
        of its components (its K_j n draws through log q and the target)."""
        if self.entropy not in _MIXTURE_ENTROPIES:
            raise ValueError(
                f"unknown mixture entropy estimator: {self.entropy!r} "
                "(supported: 'monte_carlo', 'stl')"
            )
        comps = rows_of(q.n_components, self.ep_axis)
        z = self._draw(q, key, noise, comps)  # (K_j, n, d)
        q_for_logq = tree_stop_gradient(q) if self.entropy == "stl" else q
        logq = q_for_logq.log_prob(z)  # (K_j, n)
        K, n, d = z.shape
        energy = prob.log_density(z.reshape(K * n, d)).reshape(K, n)
        per_comp = torch.mean(energy - logq, dim=1)
        return -torch.sum(q.weights()[_span(q.n_components, comps)] * per_comp)

    def _loss_and_aux(self, q, prob, key, noise: Optional[torch.Tensor] = None):
        nelbo = self.loss(q, maybe_wrap_custom_grad(prob), key, noise)
        return nelbo, {"elbo": -nelbo.detach()}

    def value_and_grad(self, q, prob, key, obj_state=(), noise=None):
        """One gradient estimate; returns (grad family, obj_state, info).
        ``noise``: (K, n_samples, d) base draws that replace the sampler.
        Under a mesh the components' shares are summed over ``ep_axis``."""
        grad, info = value_and_grad(lambda live: self._loss_and_aux(live, prob, key, noise), q,
                                    self.ep_axis)
        return grad, obj_state, info

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        n = self.n_samples if n_samples is None else n_samples
        with terms_split(self.ep_axis):
            share = MixtureELBO(n_samples=n, entropy="monte_carlo", ep_axis=self.ep_axis).loss(
                q, prob, key)
        return psum(share, self.ep_axis)
