"""Aliases composing the replica wrappers with base models (the JAX
package's rrrmc_tpu/models/aliases.py; the reference's QAliases.jl,
REAliases.jl, LEAliases.jl and TLEAliases.jl). Each alias builds the base
disorder once and shares it across the replicas, on `device` (CUDA when none
is given). The K-SAT, perceptron and committee aliases sit beside their base
models."""

from __future__ import annotations

import numpy as np

from .dense import FullyConnected, GraphSK, GraphSKNormal
from .graphs import GraphEmpty, assign_edge_couplings, gen_ea_adjacency
from .pairwise import Pairwise, make_pairwise
from .replicas import (GraphLocalEntropy, GraphQuant, GraphRobustEnsemble,
                       GraphTopologicalLocalEntropy, LEModel, QuantModel,
                       REModel, TLEModel)


def _ea_normal(L: int, D: int, seed, device=None) -> Pairwise:
    """The reference's QEAT / EARE base: an EA lattice with uniform float
    couplings in [-2, 2) (4 rand() - 2), a generic Pairwise, the JAX
    package's draw."""
    rng = np.random.default_rng(seed)
    adj = gen_ea_adjacency(L, D)
    J = assign_edge_couplings(adj, lambda: float(4 * rng.random() - 2))
    return make_pairwise(adj, J, L ** D, device=device)


def _tle_neighb(base: FullyConnected):
    """The topological neighbourhood of a FullyConnected base (TLE.jl):
    every other site. A Pairwise base's is its adjacency, which
    GraphTopologicalLocalEntropy takes by default."""
    n = base.N
    return [[j for j in range(n) if j != i] for i in range(n)]


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


# --- Local entropy (LEAliases.jl) ------------------------------------------

def Graph0LE(Nk, M, gamma, beta, *, device=None) -> LEModel:
    return GraphLocalEntropy(Nk, M, gamma, beta,
                             GraphEmpty(Nk, device=device))


def GraphSKLE(Nk, M, gamma, beta, *, seed=None, device=None) -> LEModel:
    return GraphLocalEntropy(Nk, M, gamma, beta,
                             GraphSK(Nk, seed=seed, device=device))


def GraphEALE(L, D, M, gamma, beta, *, seed=None, device=None) -> LEModel:
    return GraphLocalEntropy(L ** D, M, gamma, beta,
                             _ea_normal(L, D, seed, device))


# --- Topological local entropy (TLEAliases.jl) -----------------------------

def Graph0TLE(Nk, M, gamma, lambda_, beta, *, device=None) -> TLEModel:
    return GraphTopologicalLocalEntropy(Nk, M, gamma, lambda_, beta,
                                        GraphEmpty(Nk, device=device),
                                        neighb=[[] for _ in range(Nk)])


def GraphSKTLE(Nk, M, gamma, lambda_, beta, *, seed=None,
               device=None) -> TLEModel:
    base = GraphSK(Nk, seed=seed, device=device)
    return GraphTopologicalLocalEntropy(Nk, M, gamma, lambda_, beta, base,
                                        neighb=_tle_neighb(base))


def GraphEATLE(L, D, M, gamma, lambda_, beta, *, seed=None,
               device=None) -> TLEModel:
    return GraphTopologicalLocalEntropy(L ** D, M, gamma, lambda_, beta,
                                        _ea_normal(L, D, seed, device))
