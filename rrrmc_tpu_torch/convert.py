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
from .models.perceptron import Perceptron
from .models.pspin import PSpin3
from .models.committee import Committee
from .models.replicas import (GraphAddFields, GraphAddSubFields,
                              GraphLocalEntropy, GraphQuant,
                              GraphRobustEnsemble,
                              GraphTopologicalLocalEntropy, neighbor_lists)
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


def perceptron_from_arrays(xi, loss_table, *, N: int, P: int, scale: float,
                           device=None) -> Perceptron:
    """The port's Perceptron from patterns xi [P, N] (+-1, stored as int8)
    and its loss table [N + 1] (for example a JAX Perceptron's
    `np.asarray(m.xi)`, `np.asarray(m.loss_table)`, `m.N`, `m.P`,
    `m.scale`): an integer table is stored as int32, a float one as
    float32."""
    xi = np.asarray(xi)
    table = np.asarray(loss_table)
    if xi.shape != (P, N) or table.shape != (N + 1,):
        raise ValueError(f"expected xi {(P, N)} and loss_table {(N + 1,)}, "
                         f"got {xi.shape}, {table.shape}")
    if not np.isin(xi, (-1, 1)).all():
        raise ValueError("patterns must be +-1")
    dt = itype() if np.issubdtype(table.dtype, np.integer) else ftype()
    device = default_device(device)
    return Perceptron(xi=torch.tensor(xi.astype(np.int8), device=device),
                      loss_table=torch.tensor(table, device=device).to(dt),
                      N=int(N), P=int(P), scale=float(scale))


def replica_from_arrays(kind: str, base, *, M: Optional[int] = None,
                        coupling: Optional[float] = None,
                        beta: Optional[float] = None,
                        lambda_: Optional[float] = None, neighb=None,
                        fields=None):
    """The port's wrapper of kind `kind` over `base`, itself carried across
    with the other converters:

    * "quant": QuantModel, coupling = Gamma (a JAX QuantModel's `m.M`,
      `m.Gamma`, `m.beta`);
    * "re": REModel, coupling = gamma (`m.M`, `m.inner_m.gamma`,
      `m.inner_m.beta_p`);
    * "le": LEModel, coupling = gamma (`m.M`, and gamma / beta =
      `m.inner_m.scale` with beta = 1);
    * "tle": TLEModel, coupling = gamma, lambda_, and `neighb` the [Nk,
      Kmax] site table padded with Nk (`m.inner_m.gammaT`,
      `m.inner_m.lambdaT` with beta = 1, `np.asarray(m.inner_m.neighb)`);
    * "af" / "addsub": GraphAddFields / GraphAddSubFields with `fields` [N]
      in the reference's sign (minus a JAX model's `m.inner_m.h`).

    The wrapper tables (fourK, fk, the LE and TLE stars, the fields) are
    derived from the constants as the JAX builders derive them."""
    if kind in ("af", "addsub"):
        fields = np.asarray(fields, dtype=np.float64)
        return (GraphAddFields if kind == "af" else GraphAddSubFields)(
            fields, base)
    Nk, M, coupling, beta = base.N, int(M), float(coupling), float(beta)
    if kind == "quant":
        return GraphQuant(Nk, M, coupling, beta, base)
    if kind == "re":
        return GraphRobustEnsemble(Nk, M, coupling, beta, base)
    if kind == "le":
        return GraphLocalEntropy(Nk, M, coupling, beta, base)
    if kind == "tle":
        nb = np.asarray(neighb)
        if nb.ndim != 2 or nb.shape[0] != Nk:
            raise ValueError(f"neighb must be [{Nk}, Kmax], got {nb.shape}")
        return GraphTopologicalLocalEntropy(Nk, M, coupling, float(lambda_),
                                            beta, base,
                                            neighb=neighbor_lists(nb))
    raise ValueError(f"kind must be 'quant', 're', 'le', 'tle', 'af' or "
                     f"'addsub', got {kind!r}")


def committee_from_arrays(xi, y, c, K1: int, K2: int, kind: str,
                          device=None) -> Committee:
    """The port's Committee from patterns xi [P, K1 K2], labels y [P] and
    unit weights c [K2], all +-1 and stored as int8 (for example a JAX
    Committee's `np.asarray(m.xi)`, `np.asarray(m.y)`, `np.asarray(m.c)`,
    `m.K1`, `m.K2`, `m.kind`)."""
    xi, y, c = (np.asarray(a) for a in (xi, y, c))
    P = xi.shape[0]
    if xi.shape != (P, K1 * K2) or y.shape != (P,) or c.shape != (K2,):
        raise ValueError(f"expected xi {(P, K1 * K2)}, y {(P,)} and c "
                         f"{(K2,)}, got {xi.shape}, {y.shape}, {c.shape}")
    if kind not in ("step", "relu", "qu"):
        raise ValueError(f"kind must be 'step', 'relu' or 'qu', got "
                         f"{kind!r}")
    if not all(np.isin(a, (-1, 1)).all() for a in (xi, y, c)):
        raise ValueError("xi, y and c must be +-1")
    device = default_device(device)

    def put(a):
        return torch.tensor(a.astype(np.int8), device=device)

    return Committee(xi=put(xi), y=put(y), c=put(c), N=int(K1 * K2),
                     K1=int(K1), K2=int(K2), P=int(P), kind=kind)


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


def pt_state_from_arrays(model, sigma, E=None, rank=None, swap_acc=None, *,
                         seed: int = DEFAULT_SEED, device=None):
    """PTState for spins sigma [T, B, N] by slot on `device` (CUDA when none
    is given): aux re-derived, E defaulting to the slots' energies, rank to
    the slot index and swap_acc to zeros; the generator seeded as
    parallel_tempering seeds it (seed ^ 0x5EED)."""
    from .parallel.tempering import PT_SALT, PTState

    device = default_device(device)
    sig = torch.tensor(np.asarray(sigma, dtype=np.int8), device=device)
    T, B, N = sig.shape
    flat = sig.reshape(T * B, N)
    e = model.energy(flat)
    E = (e.view(T, B) if E is None else
         torch.tensor(np.asarray(E), device=device).to(e.dtype))
    rank = (torch.arange(T, dtype=torch.int32, device=device)[:, None]
            .expand(T, B).contiguous() if rank is None else
            torch.tensor(np.asarray(rank), device=device).to(torch.int32))
    acc = (torch.zeros((T, B), dtype=torch.int32, device=device)
           if swap_acc is None else
           torch.tensor(np.asarray(swap_acc), device=device).to(torch.int32))
    return PTState(sigma=sig, aux=model.init_aux(flat).view(T, B, N), E=E,
                   rank=rank, swap_acc=acc,
                   generator=make_generator(seed ^ PT_SALT, device))


def et_state_from_arrays(models, sigmas, walker=None, swap_acc=None, *,
                         seed: int = DEFAULT_SEED, device=None):
    """ETState for the slots' spins sigmas [T, B, N] under `models` on
    `device` (CUDA when none is given): each slot a `state_from_arrays`
    (seeded seed + 7919 t, as tempered_ensembles seeds its slots), walker
    defaulting to the slot index and swap_acc to zeros; the swap generator
    seeded seed ^ 0x7E3B."""
    from .parallel.tempering import ET_SALT, ETState

    device = default_device(device)
    slots = tuple(state_from_arrays(m, s, seed=seed + 7919 * t,
                                    device=device)
                  for t, (m, s) in enumerate(zip(models, sigmas)))
    T, B = len(slots), slots[0].sigma.shape[0]
    walker = (torch.arange(T, dtype=torch.int32, device=device)[:, None]
              .expand(T, B).contiguous() if walker is None else
              torch.tensor(np.asarray(walker), device=device).to(torch.int32))
    acc = (torch.zeros((T, B), dtype=torch.int32, device=device)
           if swap_acc is None else
           torch.tensor(np.asarray(swap_acc), device=device).to(torch.int32))
    return ETState(slots=slots, walker=walker, swap_acc=acc,
                   generator=make_generator(seed ^ ET_SALT, device))
