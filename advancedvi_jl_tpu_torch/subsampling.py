"""Doubly-stochastic VI: epoch-reshuffled minibatch subsampling (port of
subsampling.py; reference reshuffling.jl:13-60).

Each epoch draws a fresh permutation of the ``n_data`` indices, keeps the
first ``n_batches * batchsize`` of them (the ragged trailing batch is
dropped, as in the reference and the JAX package) and visits the batches in
order.  The JAX package draws its permutations from threefry keys, which
PyTorch cannot reproduce; here epoch ``e``'s permutation is
``torch.randperm`` under a ``torch.Generator`` on the permutation's device,
seeded from (seed words, e).  So the schedule depends only on (seed, epoch)
for a given device, and a resumed run repeats an uninterrupted one bitwise.

The permutation lives on the target's device; the epoch and the position in
it are host integers, as the iteration counter of
``algorithms/paramspace.py`` is, so advancing the schedule never waits on the
card.  The parity tests carry the JAX package's own permutations across with
``convert.reshuffling_state_from_numpy``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

import torch

from .ops.cuda.location_scale_kernels import SeedLike, seed_words


@dataclass(frozen=True)
class ReshufflingState:
    perm: torch.Tensor  # (n_batches * batchsize,) int64, on the target's device
    epoch: int  # 1-based
    step: int  # 0-based position within the epoch
    seed: Tuple[int, int]  # the two Philox seed words the permutations derive from


def keyed_permutation(n: int, seed: Tuple[int, int], counter: int,
                      device="cuda") -> torch.Tensor:
    """A permutation of ``range(n)`` on ``device`` that depends only on
    (seed words, counter) there: ``torch.randperm`` under a generator seeded
    from a hash of the three."""
    key = f"{seed[0]}:{seed[1]}:{counter}".encode()
    digest = hashlib.blake2b(key, digest_size=8).digest()
    g = torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)
    return torch.randperm(n, generator=g, device=device)


@dataclass(frozen=True)
class ReshufflingBatchSubsampling:
    """Random-reshuffling batch schedule over ``n_data`` data points: every
    epoch a fresh permutation, ``n_batches`` full batches of ``batchsize``
    (trailing remainder dropped), each visited once."""

    n_data: int
    batchsize: int

    @property
    def n_batches(self) -> int:
        n = self.n_data // self.batchsize
        if n == 0:
            raise ValueError(
                f"batchsize {self.batchsize} exceeds dataset size {self.n_data}"
            )
        return n

    def __len__(self) -> int:
        return self.n_batches

    def draw_perm(self, seed: Tuple[int, int], epoch: int, device="cuda") -> torch.Tensor:
        """Epoch ``epoch``'s truncated permutation, drawn on ``device``."""
        perm = keyed_permutation(self.n_data, seed, epoch, device)
        return perm[: self.n_batches * self.batchsize]

    def init(self, seed: SeedLike, device="cuda") -> ReshufflingState:
        words = seed_words(seed)
        return ReshufflingState(perm=self.draw_perm(words, 1, device), epoch=1, step=0,
                                seed=words)

    def step(self, state: ReshufflingState):
        """Advance one batch; reshuffle at the epoch boundary.  Returns
        ``(batch indices (batchsize,), new state, {"epoch", "step"})``."""
        bs, nb = self.batchsize, self.n_batches
        batch = state.perm[state.step * bs:(state.step + 1) * bs]
        info = {"epoch": state.epoch, "step": state.step + 1}
        if state.step + 1 >= nb:
            new = ReshufflingState(
                perm=self.draw_perm(state.seed, state.epoch + 1, state.perm.device),
                epoch=state.epoch + 1, step=0, seed=state.seed,
            )
        else:
            new = ReshufflingState(perm=state.perm, epoch=state.epoch, step=state.step + 1,
                                   seed=state.seed)
        return batch, new, info

    def epoch_batches(self, seed: SeedLike, device="cuda") -> torch.Tensor:
        """A full epoch of batches, shape (n_batches, batchsize) (reference
        subsampledobjective.jl:47-58): the epoch-1 permutation of ``seed``."""
        return self.draw_perm(seed_words(seed), 1, device).reshape(self.n_batches,
                                                                    self.batchsize)
