"""Flatten wrapper compositions into one Pairwise model (the JAX package's
rrrmc_tpu/models/flatten.py).

The replica wrappers (Quant, LE, AddFields, Mixed) are combinators: their
energy is a sum of pairwise parts over disjoint or shared index ranges of
the composite spin vector. `flatten(model)` merges every part into ONE
Pairwise over the composite N (each spin's adjacency lists concatenated,
couplings, fields and offsets in physical units), so that the single-move
samplers run a flat model: standardMC(backend="kernel") and sweepMC on the
site kernel, bklMC / wtmMC / rrrMC on the sparse race kernel, extremal_opt
on the sparse EO kernel.

Supported: Pairwise, Scaled, Mixed, Double (QuantModel, LEModel, AddFields
and AddSubFields included) and Replicated over a Pairwise base. GraphRE
(the log-cosh star), GraphTLE (the 4-spin term) and bases that are not
Pairwise raise ValueError.

The result is float32 at scale 1: parts of different physical scales lose
the shared integer grid, so the energy invariants hold to float tolerance.
rrrMC should keep the original Double, which it samples exactly on its
inner part.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .composite import Double, Mixed
from .pairwise import Pairwise, make_pairwise
from .replicas import Replicated, Scaled, model_device


def _pairwise_lists(pw: Pairwise, weight: float):
    """Pairwise -> (adjacency lists, coupling lists, h, offset), physical
    and times `weight`, in float64."""
    neigh = pw.neigh.cpu().numpy()
    J = pw.J.cpu().numpy().astype(np.float64) * pw.scale * weight
    h = pw.h.cpu().numpy().astype(np.float64) * pw.scale * weight
    off = float(pw.offset.cpu()) * pw.scale * weight
    adj: List[List[int]] = [[] for _ in range(pw.N)]
    cpl: List[List[float]] = [[] for _ in range(pw.N)]
    for i in range(pw.N):
        for k in range(neigh.shape[1]):
            j = int(neigh[i, k])
            if j < pw.N and J[i, k] != 0.0:
                adj[i].append(j)
                cpl[i].append(float(J[i, k]))
    return adj, cpl, h, off


def _collect(model, weight: float, n: int, parts: list):
    """Append the (adj, cpl, h, offset) parts of `model` over the
    composite index space [0, n)."""
    if isinstance(model, Pairwise):
        if model.N != n:
            raise ValueError(f"part has N={model.N}, expected {n}")
        parts.append(_pairwise_lists(model, weight))
    elif isinstance(model, Scaled):
        _collect(model.base, weight * model.factor, n, parts)
    elif isinstance(model, Mixed):
        for p in model.parts:
            _collect(p, weight, n, parts)
    elif isinstance(model, Double):
        _collect(model.inner_m, weight, n, parts)
        _collect(model.resid_m, weight, n, parts)
    elif isinstance(model, Replicated):
        base = model.base
        if not isinstance(base, Pairwise):
            raise ValueError(
                f"cannot flatten Replicated over {type(base).__name__} "
                "(only Pairwise bases are pairwise-representable)")
        adj_b, cpl_b, h_b, off_b = _pairwise_lists(base,
                                                   weight * model.weight)
        Nk = model.Nk
        adj = [[] for _ in range(n)]
        cpl = [[] for _ in range(n)]
        h = np.zeros(n)
        for k in range(model.M):
            lo = (model.offset + k) * Nk
            for i in range(Nk):
                adj[lo + i] = [lo + j for j in adj_b[i]]
                cpl[lo + i] = list(cpl_b[i])
            h[lo:lo + Nk] = h_b
        parts.append((adj, cpl, h, off_b * model.M))
    else:
        raise ValueError(
            f"cannot flatten {type(model).__name__}: not pairwise-"
            "representable (RE's log-cosh star, TLE's 4-spin term, and "
            "non-pairwise bases have no Pairwise form)")


def flatten(model) -> Pairwise:
    """One physical-unit float32 Pairwise over the composite spin vector of
    `model`, on its device, with the same layout: energies and flip costs
    equal the model's to float tolerance. Merged in float64; duplicate edges
    are summed in their first appearance's order (an AddSubFields-style
    cancellation to 0 drops the edge), as the JAX package merges them."""
    n = model.N
    parts: list = []
    _collect(model, 1.0, n, parts)
    adj = [[] for _ in range(n)]
    cpl: List[List[float]] = [[] for _ in range(n)]
    h = np.zeros(n)
    offset = 0.0
    for adj_p, cpl_p, h_p, off_p in parts:
        for i in range(n):
            adj[i].extend(adj_p[i])
            cpl[i].extend(cpl_p[i])
        h += h_p
        offset += off_p
    for i in range(n):
        if len(set(adj[i])) != len(adj[i]):
            acc = {}
            for j, v in zip(adj[i], cpl[i]):
                acc[j] = acc.get(j, 0.0) + v
            adj[i] = [j for j, v in acc.items() if v != 0.0]
            cpl[i] = [v for v in acc.values() if v != 0.0]
    return make_pairwise(adj, cpl, n, h=h, offset=offset,
                         device=model_device(model))
