"""Carry models and states across from numpy arrays (for example the JAX
package's `np.asarray(jax_model.J)`, ...), so that both implementations run
on identical tables and identical starting spins."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .core.dtypes import ftype, itype
from .core.model import default_device
from .models.dense import FullyConnected, dense_tensors
from .models.lattice import LatticeEA, lattice_tensors
from .models.pairwise import Pairwise
from .models.pspin import PSpin3
from .models.sat import SATModel, make_sat
from .samplers.common import DEFAULT_SEED, MCState, make_generator


def pairwise_from_arrays(neigh, J, h, offset, *, N: int, K: int,
                         scale: float,
                         classes: Optional[Tuple[float, ...]] = None,
                         device=None) -> Pairwise:
    """The port's Pairwise from [N, K] neighbor / coupling tables, [N]
    fields and a scalar offset. Integer J (and h) are stored as int32 with
    `scale`; float J as float32."""
    neigh = np.asarray(neigh)
    J = np.asarray(J)
    h = np.asarray(h)
    if neigh.shape != (N, K) or J.shape != (N, K) or h.shape != (N,):
        raise ValueError(f"expected neigh/J {(N, K)} and h {(N,)}, got "
                         f"{neigh.shape}, {J.shape}, {h.shape}")
    if neigh.min() < 0 or neigh.max() > N:
        raise ValueError("neighbor ids must lie in [0, N] (N is padding)")
    integer = np.issubdtype(J.dtype, np.integer)
    if integer != np.issubdtype(h.dtype, np.integer):
        raise ValueError("J and h must both be integer or both be float")
    dt = itype() if integer else ftype()
    device = default_device(device)

    def put(a, dtype):
        return torch.tensor(np.asarray(a), device=device).to(dtype)

    return Pairwise(neigh=put(neigh, torch.int32), J=put(J, dt),
                    h=put(h, dt), offset=put(np.asarray(offset), dt),
                    N=int(N), K=int(K), scale=float(scale),
                    classes=None if classes is None else tuple(classes))


def lattice_from_arrays(Jd, h, L: int, D: int, scale: float,
                        classes: Optional[Tuple[float, ...]] = None,
                        device=None) -> LatticeEA:
    """The port's LatticeEA from direction-major couplings Jd [D, L, ..., L]
    and fields h [N] in internal units (for example a JAX LatticeEA's
    `np.asarray(m.Jd)`, `np.asarray(m.h)`, `m.L`, `m.D`, `m.scale`,
    `m.classes`). Integer arrays are stored as int32, float ones as
    float32; the padded tables are rebuilt in the JAX package's order."""
    return lattice_tensors(int(L), int(D), np.asarray(Jd), np.asarray(h),
                           scale=scale, classes=classes, device=device)


def fully_connected_from_arrays(J, h, *, scale: float,
                                device=None) -> FullyConnected:
    """The port's FullyConnected from couplings J [N, N] and fields h [N] in
    internal units (for example a JAX FullyConnected's `np.asarray(m.J)`,
    `np.asarray(m.h)`, `m.scale`): int8 J stays int8, other integer J is
    stored as int32, float J and h as float32."""
    return dense_tensors(np.asarray(J), np.asarray(h), scale=scale,
                         device=device)


def pspin_from_arrays(A, N: int, K: int, device=None) -> PSpin3:
    """The port's PSpin3 from a partner table A [N, K, 2] (for example a JAX
    PSpin3's `np.asarray(m.A)`, `m.N`, `m.K`), stored as int32."""
    A = np.asarray(A)
    if A.shape != (N, K, 2):
        raise ValueError(f"expected A {(N, K, 2)}, got {A.shape}")
    if A.min(initial=0) < 0 or A.max(initial=0) >= N:
        raise ValueError("partner ids must lie in [0, N)")
    return PSpin3(A=torch.tensor(A.astype(np.int32),
                                 device=default_device(device)),
                  N=int(N), K=int(K))


def sat_from_arrays(N: int, A, L, device=None) -> SATModel:
    """The port's SATModel from clause arrays A [Mc, K] (variable ids, N
    pads) and L [Mc, K] (literal signs), through `make_sat` (for example a
    JAX SATModel's `m.N`, `np.asarray(m.A)`, `np.asarray(m.L)`)."""
    return make_sat(int(N), np.asarray(A), np.asarray(L), device=device)


def state_from_arrays(model, sigma, E=None, accepted=None, *,
                      seed: int = DEFAULT_SEED, device=None) -> MCState:
    """MCState for spins sigma [B, N] on `device` (CUDA when none is
    given); aux is re-derived, E defaults to model.energy(sigma) and
    accepted to zeros."""
    device = default_device(device)
    sigma = torch.tensor(np.asarray(sigma, dtype=np.int8), device=device)
    E = model.energy(sigma) if E is None else torch.tensor(
        np.asarray(E), device=device).to(model.energy(sigma[:1]).dtype)
    B = sigma.shape[0]
    acc = (torch.zeros(B, dtype=torch.int32, device=device)
           if accepted is None else
           torch.tensor(np.asarray(accepted), device=device
                        ).to(torch.int32))
    return MCState(sigma=sigma, aux=model.init_aux(sigma), E=E, accepted=acc,
                   generator=make_generator(seed, sigma.device))
