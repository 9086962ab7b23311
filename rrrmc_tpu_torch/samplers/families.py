"""The kernels of each model family, in one table: the race samplers
(samplers/bkl.py: bklMC, wtmMC, rrrMC) and extremal_opt (samplers/eo.py)
take the first family whose eligibility rule holds for the model.

Every race wrapper takes the model's resident state (model.init_aux(sigma),
updated in place), `beta_s = beta * model.scale`, and the model's tables as
`tables(model)` gives them; every EO wrapper takes the same state and tables
and the rank table, plus `eo_kw(model)`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.dtypes import is_integer
from ..models.dense import FullyConnected
from ..ops.eo import eo_sparse_chunk
from ..ops.eo_dense import eo_dense_chunk
from ..ops.eo_pspin import eo_pspin_chunk
from ..ops.eo_sat import eo_sat_chunk
from ..ops.pspin import pspin_rejfree_ok, rejfree_pspin_chunk
from ..ops.rejfree import rejfree_sparse_chunk, sparse_rejfree_ok
from ..ops.rejfree_dense import (dense_rejfree_ok, kernel_couplings,
                                 rejfree_dense_chunk)
from ..ops.sat import rejfree_sat_chunk, sat_rejfree_ok, sat_tables

#: the models the kernels take, as the samplers' errors state it
ELIGIBLE = ("a Pairwise model with N >= 8, a FullyConnected one with N >= 8 "
            "and integer |J| <= 127 or float J, a PSpin3 with N >= 9, or a "
            "SATModel with N >= 8 whose clauses hold distinct variables")


class Family(NamedTuple):
    """A model family's kernels: its name (the routes kernel-rejfree-<name>
    and kernel-eo-<name>), its eligibility rule, its race and EO chunk
    wrappers, the model's tables as both wrappers take them, and the EO
    wrapper's further keyword arguments; then what a bound on the kernels'
    work counts: the largest |key| of the EO select over every
    configuration, None for float keys (it sizes the select's histogram:
    the pairwise EO wrappers take it as half_max, the hypergraph ones read
    it off their tables), and the resident fields one applied flip
    updates."""
    name: str
    eligible: Callable
    race: Callable
    eo: Callable
    tables: Callable
    eo_kw: Callable
    key_max: Callable
    flip_sites: Callable


def half_bound(model) -> Optional[int]:
    """The largest |sigma_i lf_i| of a pairwise model over every
    configuration, None for float couplings: the largest row sum of |J|
    plus |h|. The pairwise EO kernels count integer keys in 2 half_max + 1
    histogram bins when that is at most HIST_MAX, else they take the radix
    select."""
    if isinstance(model, FullyConnected):
        return int(model.half_max) if is_integer(model.J) else None
    if not is_integer(model.J):
        return None
    rows = model.J.abs().to(torch.int64).sum(1) + model.h.abs().to(
        torch.int64)
    return int(rows.max())


def _pairwise_kw(model) -> dict:
    return {"half_max": half_bound(model)}


def _no_kw(model) -> dict:
    return {}


FAMILIES = (
    Family("dense", dense_rejfree_ok, rejfree_dense_chunk, eo_dense_chunk,
           lambda m: (kernel_couplings(m),), _pairwise_kw, half_bound,
           lambda m: m.N),
    Family("sparse", sparse_rejfree_ok, rejfree_sparse_chunk,
           eo_sparse_chunk, lambda m: (m.neigh, m.J), _pairwise_kw,
           half_bound, lambda m: m.K),
    # key sigma_i c_i, |c_i| <= K; a flip moves the 2K partners' sums
    Family("pspin", pspin_rejfree_ok, rejfree_pspin_chunk, eo_pspin_chunk,
           lambda m: (m.A,), _no_kw, lambda m: m.K, lambda m: 2 * m.K),
    # key dE_i, |dE_i| <= Cmax; a flip moves the dE of the K variables of
    # each of the winner's Cmax clauses
    Family("sat", sat_rejfree_ok, rejfree_sat_chunk, eo_sat_chunk,
           sat_tables, _no_kw, lambda m: m.Cmax, lambda m: m.Cmax * m.K),
)


def family_of(model) -> Optional[Family]:
    """The first family whose kernels take `model`, or None."""
    return next((f for f in FAMILIES if f.eligible(model)), None)
