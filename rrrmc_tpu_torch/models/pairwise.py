"""Generic sparse pairwise Ising model with padded neighbor lists.

One model covers the whole 2-body family of the reference (EA lattices, RRG,
Ising1D, external fields): adjacency as a dense padded [N, K] int32 table
(padding entries point at the sentinel index N and carry J=0), couplings as a
matching [N, K] table with each symmetric edge stored twice, plus per-spin
external fields.

Energy convention (the reference's, e.g. graphs/EA.jl):

    E = -1/2 sum_i sigma_i sum_k J[i,k] sigma[neigh[i,k]] - sum_i h_i sigma_i

Auxiliary state: the local field lf_i = sum_k J[i,k] sigma_nb + h_i, so that
dE_i = 2 sigma_i lf_i. A flip of spin i updates lf only at i's neighbors, an
O(degree) masked scatter-add over the batch.

Integer-coupling instances keep lf/E in exact int32 with a static `scale` to
physical units; float-coupling instances are float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.model import Model, default_device, flip_spin
from ..core.dtypes import ftype, itype, is_integer, FIXED_POINT_SCALE


@dataclasses.dataclass(frozen=True, eq=False)
class Pairwise(Model):
    neigh: torch.Tensor   # [N, K] int32, padded with N
    J: torch.Tensor       # [N, K] couplings (0 on padding), int32 or float32
    h: torch.Tensor       # [N] external fields, J's dtype
    offset: torch.Tensor  # scalar constant energy shift (internal units)
    N: int
    K: int
    scale: float = 1.0
    classes: Optional[Tuple[float, ...]] = None

    @property
    def device(self) -> torch.device:
        return self.J.device

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        # int32 sums stay int32 (torch would promote them to int64)
        return x.sum(-1, dtype=self.J.dtype)

    def local_fields(self, sigma: torch.Tensor) -> torch.Tensor:
        """[B, N] local fields of the configurations `sigma` [B, N]."""
        B = sigma.shape[0]
        se = torch.cat([sigma.to(self.J.dtype),
                        torch.zeros((B, 1), dtype=self.J.dtype,
                                    device=sigma.device)], dim=1)
        return self._sum(self.J * se[:, self.neigh.long()]) + self.h

    def energy(self, sigma: torch.Tensor) -> torch.Tensor:
        lf = self.local_fields(sigma)
        s = sigma.to(self.J.dtype)
        pair = self._sum(s * (lf - self.h))
        if is_integer(self.J):
            pair = torch.div(pair, 2, rounding_mode="floor")
        else:
            pair = pair / 2
        return -(pair + self._sum(s * self.h)) + self.offset

    def init_aux(self, sigma):
        return self.local_fields(sigma)

    def delta_all(self, sigma, aux):
        return 2 * sigma.to(self.J.dtype) * aux

    def delta_one(self, sigma, aux, i):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        return 2 * sigma[rows, i].to(self.J.dtype) * aux[rows, i]

    def flip(self, sigma, aux, i, do):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        nb = self.neigh[i].long()                     # [B, K]; padding == N
        s_i = sigma[rows, i].to(self.J.dtype)
        upd = -2 * s_i[:, None] * self.J[i]
        keep = do[:, None] & (nb < self.N)
        upd = torch.where(keep, upd, torch.zeros_like(upd))
        # padded slots are redirected to a valid row with a zero update
        aux.scatter_add_(1, nb.clamp(max=self.N - 1), upd)
        flip_spin(sigma, i, do)
        return sigma, aux

    def delta_classes(self):
        return self.classes


def _pad_adjacency(adj: Sequence[Sequence[int]],
                   couplings: Sequence[Sequence[float]],
                   n: int, kmax: Optional[int] = None):
    """Build padded [N, K] numpy tables from ragged per-spin lists."""
    if kmax is None:
        kmax = max((len(a) for a in adj), default=0)
    kmax = max(kmax, 1)
    neigh = np.full((n, kmax), n, dtype=np.int32)
    jmat = np.zeros((n, kmax), dtype=np.float64)
    for i, (a, js) in enumerate(zip(adj, couplings)):
        if len(a) != len(js):
            raise ValueError(f"row {i}: {len(a)} neighbors, {len(js)} couplings")
        neigh[i, : len(a)] = a
        jmat[i, : len(a)] = js
    return neigh, jmat


def make_pairwise(adj, couplings, n, *, h=None, offset=0.0, kmax=None,
                  integer_scale: Optional[float] = None,
                  classes: Optional[Tuple[float, ...]] = None,
                  device=None) -> Pairwise:
    """Construct a Pairwise model from ragged python/numpy adjacency.

    integer_scale: if given, couplings/fields are exact multiples of it; the
    model stores int32 internally with `scale=integer_scale` (exact discrete
    energies). If None, float32 storage with scale=1. The tables go to
    `device`, CUDA when none is given."""
    device = default_device(device)
    neigh, jmat = _pad_adjacency(adj, couplings, n, kmax)
    hvec = np.zeros(n) if h is None else np.asarray(h, dtype=np.float64)
    nt = torch.as_tensor(neigh, device=device)
    if integer_scale is not None:
        ji = np.round(jmat / integer_scale).astype(np.int32)
        hi = np.round(hvec / integer_scale).astype(np.int32)
        oi = int(round(offset / integer_scale))
        if not np.allclose(ji * integer_scale, jmat, atol=1e-12):
            raise ValueError("couplings not on the integer grid")
        if not np.allclose(hi * integer_scale, hvec, atol=1e-12):
            raise ValueError("fields not on the integer grid")
        it = itype()
        return Pairwise(
            neigh=nt, J=torch.as_tensor(ji, dtype=it, device=device),
            h=torch.as_tensor(hi, dtype=it, device=device),
            offset=torch.tensor(oi, dtype=it, device=device),
            N=n, K=neigh.shape[1], scale=float(integer_scale),
            classes=classes)
    ft = ftype()
    return Pairwise(
        neigh=nt, J=torch.as_tensor(jmat, dtype=ft, device=device),
        h=torch.as_tensor(hvec, dtype=ft, device=device),
        offset=torch.tensor(offset, dtype=ft, device=device),
        N=n, K=neigh.shape[1], scale=1.0, classes=classes)


def infer_integer_scale(values: np.ndarray) -> Optional[float]:
    """Pick an exact fixed-point scale for a finite level set (the reference's
    DFloat64 auto-wrap of Float64 levels): integers get scale 1, short
    decimals a 10^-5 grid, else None."""
    values = np.asarray(values, dtype=np.float64)
    if np.allclose(values, np.round(values), atol=0):
        return 1.0
    scaled = values * FIXED_POINT_SCALE
    if np.allclose(scaled, np.round(scaled), atol=1e-9):
        return 1.0 / FIXED_POINT_SCALE
    return None


def enumerate_pair_classes(levels: Sequence[float],
                           degree: int) -> Tuple[float, ...]:
    """All possible non-negative |dE| values for a spin of exact degree
    `degree` with couplings drawn from `levels` (the allDeltaE analog)."""
    sums = {0.0}
    for _ in range(degree):
        sums = {s + 2.0 * l * sgn for s in sums for l in levels
                for sgn in (-1.0, 1.0)}
    return tuple(sorted({abs(round(s, 9)) for s in sums}))
