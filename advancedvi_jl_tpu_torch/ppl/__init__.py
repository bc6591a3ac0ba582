"""Probabilistic-program ingestion (port of ppl/): write models with
``ppl.sample`` / ``ppl.plate`` and turn them into unconstrained targets
ready to fit with ``ppl.ingest`` (support transforms from the sites'
supports, plate-aware subsampling).  The reference's ``from_numpyro`` is not
ported: a numpyro model is a JAX program, and the port imports no JAX."""

from .dists import (
    Bernoulli,
    Beta,
    Categorical,
    Dirichlet,
    Exponential,
    Gamma,
    HalfCauchy,
    HalfNormal,
    Laplace,
    LogNormal,
    Normal,
    Poisson,
    StudentT,
    Uniform,
)
from .model import Model, PPLTarget, ingest, plate, prior_predictive, sample

__all__ = [
    "Bernoulli",
    "Beta",
    "Categorical",
    "Dirichlet",
    "Exponential",
    "Gamma",
    "HalfCauchy",
    "HalfNormal",
    "Laplace",
    "LogNormal",
    "Normal",
    "Poisson",
    "StudentT",
    "Uniform",
    "Model",
    "PPLTarget",
    "ingest",
    "plate",
    "prior_predictive",
    "sample",
]
