"""Carry weights, states and noise between the JAX package and the port.

Works on numpy arrays (anything ``np.asarray`` accepts, so JAX arrays pass
through too) and imports no JAX.  The JAX fused engine keeps its state and
its injected noise in TPU lane/sublane padding; the port keeps ``(d,)``
tensors and ``(steps, n_samples, d)`` noise.  The padding widths are the JAX
package's ``d_pad_for`` and ``n_pad_for`` (ops/pallas/fused_advi.py), restated
here so the port never imports it; a test pins the two against each other.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .families.location_scale import MeanFieldGaussian, MeanFieldLocationScale
from .models.logreg import LogReg
from .ops.cuda.fused_advi import STATE_FIELDS, FusedADVIState

D_PAD = 128  # JAX fused engine: lane padding unit
N_PAD = 16   # JAX fused engine: minimum sample-row padding


def d_pad_for(d: int) -> int:
    """The JAX fused engine's lane padding of a d-dimensional model."""
    return max(D_PAD, -(-d // D_PAD) * D_PAD)


def n_pad_for(n: int) -> int:
    """The JAX fused engine's row padding of n samples per step."""
    return max(N_PAD, -(-n // 8) * 8)


def to_tensor(a: Any, device=None, dtype=torch.float32) -> torch.Tensor:
    """A float32 tensor copy of an array-like, on ``device``."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def logreg_from_numpy(X, y, likeadj=1.0, prior_scale: float = 3.0,
                      device=None) -> LogReg:
    """The port's LogReg from a JAX LogReg's ``X, y, likeadj, prior_scale``."""
    return LogReg(
        X=to_tensor(X, device), y=to_tensor(y, device),
        likeadj=to_tensor(likeadj, device), prior_scale=float(prior_scale),
    )


def meanfield_from_numpy(location, scale_diag, device=None) -> MeanFieldLocationScale:
    """The port's MeanFieldGaussian from a JAX one's ``location, scale_diag``."""
    return MeanFieldGaussian(to_tensor(location, device), to_tensor(scale_diag, device))


def fused_state_from_numpy(jax_state: Any, d: int, device=None) -> FusedADVIState:
    """The port's FusedADVIState from a JAX ``FusedADVIState`` (any object
    with its field names), stripping the padding: the first row and the
    first ``d`` lanes of each ``(1, d_pad)`` field."""
    rows = {
        f: to_tensor(np.asarray(getattr(jax_state, f))[0, :d], device)
        for f in STATE_FIELDS
    }
    return FusedADVIState(
        **rows, iteration=int(np.asarray(jax_state.iteration)),
        elbo=to_tensor(jax_state.elbo, device),
    )


def pack_noise(noise, n_pad: Optional[int] = None,
               d_pad: Optional[int] = None) -> np.ndarray:
    """The port's ``(steps, n_samples, d)`` base draws in the JAX fused
    engine's ``(steps * n_pad, d_pad)`` layout (zero padding)."""
    noise = np.asarray(noise, dtype=np.float32)
    steps, n, d = noise.shape
    n_pad = n_pad_for(n) if n_pad is None else n_pad
    d_pad = d_pad_for(d) if d_pad is None else d_pad
    out = np.zeros((steps, n_pad, d_pad), np.float32)
    out[:, :n, :d] = noise
    return out.reshape(steps * n_pad, d_pad)
