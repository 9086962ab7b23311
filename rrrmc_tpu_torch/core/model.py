"""The model contract, batch-explicit.

A model is a frozen dataclass of tensors describing one disorder realization
of an Ising-type energy over N binary spins. Unlike the JAX package, whose
methods are single-chain functions mapped over the batch with `vmap`, every
method here takes the whole batch: `sigma` is a [B, N] int8 tensor of +-1
values and the auxiliary state (the local-field cache) is batched on axis 0.

==========================  ====================================================
reference                   here
==========================  ====================================================
`energy(X, C)`              `model.energy(sigma)` -> [B]
`delta_energy(X, C, i)`     `model.delta_one(sigma, aux, i)` with i [B]
(lfields cache)             `model.delta_all(sigma, aux)` -> [B, N]
`spinflip!(X, C, i)`        `model.flip(sigma, aux, i, do)` (masked, in place)
`allDeltaE(...)`            `model.delta_classes()`
`getN(X)`                   `model.N`
==========================  ====================================================

Masked flips: samplers decide acceptance per chain in lockstep, so `flip`
takes a boolean `do` [B]; chains with do=False are left untouched. `flip`
updates `sigma` and `aux` IN PLACE (an O(B * degree) scatter instead of an
O(B * N) copy per move) and returns them; samplers clone the caller's state
once per call, so a caller's tensors are never modified behind its back.

Internal vs physical units: integer models compute energies in an exact int32
domain; `scale` converts to physical units (see core/dtypes.py).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

Tensor = torch.Tensor


def default_device(device=None) -> torch.device:
    """`device`, or the card when none is given: builders and `init_state`
    place their tensors on CUDA unless the caller asks for the CPU, and on a
    machine without a card torch's own error is raised, never a quiet
    fallback to the host."""
    return torch.device("cuda" if device is None else device)


def flip_spin(sigma: Tensor, i: Tensor, do: Tensor) -> Tensor:
    """Flip sigma[b, i[b]] for every chain b with do[b], in place."""
    rows = torch.arange(sigma.shape[0], device=sigma.device)
    cur = sigma[rows, i]
    sigma[rows, i] = torch.where(do, -cur, cur)
    return sigma


class Model:
    """Base class; concrete models are frozen dataclasses deriving from it."""

    N: int  # number of spins
    scale: float = 1.0  # physical energy = internal * scale

    def energy(self, sigma: Tensor) -> Tensor:
        """[B] total energies (internal units), computed from scratch."""
        raise NotImplementedError

    def init_aux(self, sigma: Tensor) -> Any:
        """Auxiliary (local-field-like) state for `sigma` [B, N]."""
        raise NotImplementedError

    def delta_all(self, sigma: Tensor, aux: Any) -> Tensor:
        """[B, N] energy change (internal units) of flipping each spin."""
        raise NotImplementedError

    def flip(self, sigma: Tensor, aux: Any, i: Tensor, do: Tensor):
        """Flip spin i[b] of every chain b with do[b], updating `sigma` and
        `aux` in place; returns (sigma, aux)."""
        raise NotImplementedError

    def delta_one(self, sigma: Tensor, aux: Any, i: Tensor) -> Tensor:
        """[B] energy change of flipping spin i[b]. Default: gather of
        delta_all."""
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        return self.delta_all(sigma, aux)[rows, i]

    def delta_classes(self) -> Optional[Sequence[float]]:
        """Non-negative |dE| class values in physical units for discrete
        models (the reference's `allDeltaE`), or None for continuous ones."""
        return None

    def neighbor_table(self) -> Optional[Tensor]:
        """[N, K] int32 table, padded with the sentinel N, of the spins whose
        `delta_one` can change when spin i flips; None means every spin."""
        return getattr(self, "neigh", None)

    def to_physical(self, e: Tensor) -> Tensor:
        """Internal-unit energies in physical units (float32)."""
        from .dtypes import ftype, is_integer

        if is_integer(e) or self.scale != 1.0:
            return e.to(ftype()) * self.scale
        return e

    @property
    def inner(self) -> Optional["Model"]:
        """Inner (exactly-sampled) part of DoubleModel composites, else None."""
        return None


def random_spins(batch: int, n: int, *, generator: torch.Generator,
                 device=None) -> Tensor:
    """[batch, n] random +-1 int8 configurations (the `Config(N)` analog),
    drawn from an explicit generator on `device`."""
    bits = torch.randint(0, 2, (batch, n), generator=generator,
                         device=device, dtype=torch.int8)
    return bits * 2 - 1
