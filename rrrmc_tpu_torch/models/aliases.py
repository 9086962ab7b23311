"""Aliases composing the replica wrappers with base models (the JAX
package's rrrmc_tpu/models/aliases.py, Quant and RE; the reference's
QAliases.jl and REAliases.jl). Each alias builds the base disorder once and
shares it across the replicas, on `device` (CUDA when none is given)."""

from __future__ import annotations

import numpy as np

from .dense import GraphSK, GraphSKNormal
from .graphs import GraphEmpty, assign_edge_couplings, gen_ea_adjacency
from .pairwise import Pairwise, make_pairwise
from .replicas import GraphQuant, GraphRobustEnsemble, QuantModel, REModel


def _ea_normal(L: int, D: int, seed, device=None) -> Pairwise:
    """The reference's QEAT / EARE base: an EA lattice with uniform float
    couplings in [-2, 2) (4 rand() - 2), a generic Pairwise, the JAX
    package's draw."""
    rng = np.random.default_rng(seed)
    adj = gen_ea_adjacency(L, D)
    J = assign_edge_couplings(adj, lambda: float(4 * rng.random() - 2))
    return make_pairwise(adj, J, L ** D, device=device)


# --- Quant (QAliases.jl) ---------------------------------------------------

def GraphQ0T(Nk, M, Gamma, beta, *, device=None) -> QuantModel:
    """Transverse field on free spins (for tests)."""
    return GraphQuant(Nk, M, Gamma, beta, GraphEmpty(Nk, device=device))


def GraphQSKT(Nk, M, Gamma, beta, *, seed=None, device=None) -> QuantModel:
    return GraphQuant(Nk, M, Gamma, beta,
                      GraphSK(Nk, seed=seed, device=device))


def GraphQSKNormalT(Nk, M, Gamma, beta, *, seed=None,
                    device=None) -> QuantModel:
    return GraphQuant(Nk, M, Gamma, beta,
                      GraphSKNormal(Nk, seed=seed, device=device))


def GraphQEAT(L, D, M, Gamma, beta, *, seed=None, device=None) -> QuantModel:
    return GraphQuant(L ** D, M, Gamma, beta, _ea_normal(L, D, seed, device))


# --- Robust ensemble (REAliases.jl) ----------------------------------------

def Graph0RE(Nk, M, gamma, beta, *, device=None) -> REModel:
    return GraphRobustEnsemble(Nk, M, gamma, beta,
                               GraphEmpty(Nk, device=device))


def GraphSKRE(Nk, M, gamma, beta, *, seed=None, device=None) -> REModel:
    return GraphRobustEnsemble(Nk, M, gamma, beta,
                               GraphSK(Nk, seed=seed, device=device))


def GraphEARE(L, D, M, gamma, beta, *, seed=None, device=None) -> REModel:
    return GraphRobustEnsemble(L ** D, M, gamma, beta,
                               _ea_normal(L, D, seed, device))
