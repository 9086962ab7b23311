"""Lattice-specialised EA model: local fields by periodic rolls, not gathers.

A D-dimensional periodic lattice's neighbour structure is D pairs of +-1
shifts, so the local fields are D pairs of `torch.roll`s over the
[B, L, ..., L] view of the spins instead of the padded [B, N, K] gather of
`Pairwise.local_fields`. The padded tables are still built (LatticeEA
subclasses Pairwise), so every single-site sampler and the sparse race kernel
work unchanged; only `local_fields` and `sweep_masks` are overridden.

Couplings are stored direction-major, as in the JAX package's
`rrrmc_tpu/models/lattice.py`: Jd[d] is the coupling of the edge from site x
to x + e_d, and

    lf[x] = sum_d Jd[d][x] * sigma[x+e_d] + Jd[d][x-e_d] * sigma[x-e_d] + h[x]
          = sum_d Jd[d]*roll(sigma,-1,d) + roll(Jd[d]*sigma,+1,d) + h

Requires L > 2 (L = 2 has doubled parallel edges; graphs.GraphEA keeps the
generic Pairwise path there).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import ftype, itype
from ..core.model import default_device
from .pairwise import Pairwise, infer_integer_scale, enumerate_pair_classes


@dataclasses.dataclass(frozen=True, eq=False)
class LatticeEA(Pairwise):
    Jd: Optional[torch.Tensor] = None   # [D, L, ..., L] couplings toward +e_d
    L: int = 0
    D: int = 0

    @property
    def lat_shape(self) -> Tuple[int, ...]:
        return (self.L,) * self.D

    def local_fields(self, sigma: torch.Tensor) -> torch.Tensor:
        """[B, N] local fields of `sigma` [B, N]: exact int32 for integer
        couplings, equal to the gathered `Pairwise.local_fields`."""
        B = sigma.shape[0]
        s = sigma.to(self.Jd.dtype).view(B, *self.lat_shape)
        lf = None
        for d in range(self.D):
            jd = self.Jd[d]
            t = jd * torch.roll(s, -1, d + 1) + torch.roll(jd * s, 1, d + 1)
            lf = t if lf is None else lf + t
        return lf.reshape(B, self.N) + self.h

    def sweep_masks(self) -> torch.Tensor:
        """[C, N] independent-set masks: the exact checkerboard 2-colouring
        for even L. Odd L is not bipartite (the periodic wrap joins
        same-parity sites), so it takes the greedy colouring: parity masks
        there would flip coupled neighbours at once and break the chain
        law."""
        if self.L % 2:
            from ..samplers.sweep import color_masks
            return color_masks(self)
        par = torch.as_tensor(parity(self.L, self.D) == 0, device=self.device)
        return torch.stack([par, ~par])


def parity(L: int, D: int) -> np.ndarray:
    """[N] int: the coordinate sum of every site modulo 2 (row-major sites,
    the last axis has stride 1)."""
    return np.indices((L,) * D).sum(axis=0).reshape(L ** D) % 2


def _lattice_tables(L: int, D: int, Jd: np.ndarray):
    """Padded [N, 2D] neighbour / coupling tables from direction-major Jd:
    column 2d is x + e_d, column 2d + 1 is x - e_d (unsorted, unlike
    graphs.gen_ea_adjacency)."""
    n = L ** D
    shape = (L,) * D
    idx = np.arange(n).reshape(shape)
    neigh = np.empty((n, 2 * D), dtype=np.int32)
    jmat = np.empty((n, 2 * D), dtype=np.float64)
    for d in range(D):
        neigh[:, 2 * d] = np.roll(idx, -1, axis=d).reshape(n)      # x + e_d
        jmat[:, 2 * d] = Jd[d].reshape(n)
        neigh[:, 2 * d + 1] = np.roll(idx, 1, axis=d).reshape(n)   # x - e_d
        jmat[:, 2 * d + 1] = np.roll(Jd[d], 1, axis=d).reshape(n)
    return neigh, jmat


def lattice_tensors(L: int, D: int, Jd: np.ndarray, h: np.ndarray, *,
                    scale: float, classes: Optional[Tuple[float, ...]],
                    device=None) -> LatticeEA:
    """LatticeEA from couplings and fields already in internal units:
    integer arrays are stored as int32 with `scale`, float ones as
    float32, on `device` (CUDA when none is given)."""
    if L <= 2:
        raise ValueError("LatticeEA needs L > 2 (L = 2 has doubled edges)")
    n = L ** D
    Jd = np.asarray(Jd)
    h = np.asarray(h)
    if Jd.shape != (D,) + (L,) * D or h.shape != (n,):
        raise ValueError(f"expected Jd {(D,) + (L,) * D} and h {(n,)}, got "
                         f"{Jd.shape} and {h.shape}")
    integer = np.issubdtype(Jd.dtype, np.integer)
    if integer != np.issubdtype(h.dtype, np.integer):
        raise ValueError("Jd and h must both be integer or both be float")
    device = default_device(device)
    neigh, jmat = _lattice_tables(L, D, Jd)
    dt = itype() if integer else ftype()

    def put(a):
        return torch.tensor(np.asarray(a), device=device).to(dt)

    return LatticeEA(neigh=torch.as_tensor(neigh, device=device),
                     J=put(jmat), h=put(h), offset=put(np.asarray(0)),
                     N=n, K=2 * D, scale=float(scale),
                     classes=None if classes is None else tuple(classes),
                     Jd=put(Jd), L=L, D=D)


def make_lattice_ea(L: int, D: int, Jd: np.ndarray, *, h=None,
                    integer_scale: Optional[float] = None,
                    classes: Optional[Tuple[float, ...]] = None,
                    device=None) -> LatticeEA:
    """LatticeEA from physical couplings Jd [D, L, ..., L] and fields h [N].
    integer_scale: couplings and fields are exact multiples of it and are
    stored as int32 (exact energies); None stores float32."""
    n = L ** D
    Jd = np.asarray(Jd, dtype=np.float64)
    hv = np.zeros(n) if h is None else np.asarray(h, dtype=np.float64)
    if integer_scale is None:
        return lattice_tensors(L, D, Jd, hv, scale=1.0, classes=classes,
                               device=device)
    jdi = np.round(Jd / integer_scale).astype(np.int32)
    hi = np.round(hv / integer_scale).astype(np.int32)
    if not np.allclose(jdi * integer_scale, Jd, atol=1e-12):
        raise ValueError("couplings not on the integer grid")
    if not np.allclose(hi * integer_scale, hv, atol=1e-12):
        raise ValueError("fields not on the integer grid")
    return lattice_tensors(L, D, jdi, hi, scale=integer_scale,
                           classes=classes, device=device)


def lattice_ea_from_levels(L: int, D: int, LEV: Sequence[float], rng, *,
                           device=None) -> LatticeEA:
    """EA lattice with couplings drawn from the levels LEV (the JAX
    package's draw: rng.choice(lev, size=(D,) + (L,) * D))."""
    lev = [float(x) for x in LEV]
    Jd = rng.choice(lev, size=(D,) + (L,) * D)
    scale = infer_integer_scale(np.asarray(lev))
    classes = enumerate_pair_classes(lev, 2 * D)
    return make_lattice_ea(L, D, Jd, integer_scale=scale, classes=classes,
                           device=device)


def lattice_ea_normal(L: int, D: int, rng, *, device=None) -> LatticeEA:
    """EA lattice with unit-variance Gaussian couplings, float32."""
    Jd = rng.standard_normal((D,) + (L,) * D)
    return make_lattice_ea(L, D, Jd, device=device)
