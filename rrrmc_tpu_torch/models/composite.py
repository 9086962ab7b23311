"""Model combinators (the JAX package's rrrmc_tpu/models/composite.py),
batch-explicit: `Mixed`, the sum of models on the same N spins, and `Double`,
an inner part that rrrMC samples exactly plus a residual part corrected by
Metropolis (the reference's DoubleGraph). Composite energies are physical
floats; exact integer arithmetic stays inside the parts.

Every part's `flip` updates the shared spins in place, so a composite flips
each part against the spins as they were: it lets a part flip, flips the
spin back (an O(B) step) and hands the spins to the next part; the last
part's flip is the one that stays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.model import Model, flip_spin


def _phys(model, e):
    return model.to_physical(e)


def _flip_parts(parts, sigma, aux, i, do):
    """Each part's flip of spin i where `do`, all against the spins before
    the flip; returns (sigma flipped once, the parts' updated aux)."""
    out = []
    for n, (p, a) in enumerate(zip(parts, aux)):
        sigma, a = p.flip(sigma, a, i, do)
        out.append(a)
        if n < len(parts) - 1:
            flip_spin(sigma, i, do)        # back, for the next part
    return sigma, tuple(out)


def _union(tables):
    """Column concatenation of the parts' affected-spin tables (duplicate
    entries are harmless), None when any part has none."""
    if any(t is None for t in tables):
        return None
    return torch.cat([t.to(torch.int32) for t in tables], dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class Mixed(Model):
    """The sum of the parts' physical energies (the reference's GraphMixed)."""
    parts: Tuple[Model, ...]
    N: int
    scale: float = 1.0

    def energy(self, sigma):
        return sum(_phys(p, p.energy(sigma)) for p in self.parts)

    def init_aux(self, sigma):
        return tuple(p.init_aux(sigma) for p in self.parts)

    def delta_all(self, sigma, aux):
        return sum(_phys(p, p.delta_all(sigma, a))
                   for p, a in zip(self.parts, aux))

    def delta_one(self, sigma, aux, i):
        return sum(_phys(p, p.delta_one(sigma, a, i))
                   for p, a in zip(self.parts, aux))

    def flip(self, sigma, aux, i, do):
        return _flip_parts(self.parts, sigma, aux, i, do)

    def neighbor_table(self):
        return _union([p.neighbor_table() for p in self.parts])


def mixed(*parts: Model) -> Mixed:
    if len(parts) < 2:
        raise ValueError("mixed needs at least two parts")
    n = parts[0].N
    if any(p.N != n for p in parts):
        raise ValueError("every part must have the same N")
    return Mixed(parts=tuple(parts), N=n)


@dataclasses.dataclass(frozen=True, eq=False)
class Double(Model):
    """inner (the exactly-sampled discrete part) + resid (Metropolis
    corrected)."""
    inner_m: Model
    resid_m: Model
    N: int
    scale: float = 1.0

    def energy(self, sigma):
        return (_phys(self.inner_m, self.inner_m.energy(sigma))
                + _phys(self.resid_m, self.resid_m.energy(sigma)))

    def init_aux(self, sigma):
        return (self.inner_m.init_aux(sigma), self.resid_m.init_aux(sigma))

    def delta_all(self, sigma, aux):
        return (_phys(self.inner_m, self.inner_m.delta_all(sigma, aux[0]))
                + _phys(self.resid_m, self.resid_m.delta_all(sigma, aux[1])))

    def delta_one(self, sigma, aux, i):
        return (_phys(self.inner_m, self.inner_m.delta_one(sigma, aux[0], i))
                + _phys(self.resid_m,
                        self.resid_m.delta_one(sigma, aux[1], i)))

    def flip(self, sigma, aux, i, do):
        return _flip_parts((self.inner_m, self.resid_m), sigma, aux, i, do)

    def neighbor_table(self):
        return _union([self.inner_m.neighbor_table(),
                       self.resid_m.neighbor_table()])

    @property
    def inner(self):
        return self.inner_m

    def inner_aux(self, aux):
        return aux[0]

    def residual_delta_one(self, sigma, aux, i):
        return _phys(self.resid_m, self.resid_m.delta_one(sigma, aux[1], i))

    def delta_classes(self):
        return self.inner_m.delta_classes()
