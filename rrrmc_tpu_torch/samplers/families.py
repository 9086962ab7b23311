"""The kernels of each model family, in one table: the race samplers
(samplers/bkl.py: bklMC, wtmMC, rrrMC) and extremal_opt (samplers/eo.py)
take the first family whose eligibility rule holds for the model.

Every race wrapper takes the model's resident state and E as
`state(model, sigma, E)` gives them (model.init_aux(sigma), updated in
place, and E in its dtype; the replica composites keep their base fields and
float32 physical energies), `beta_s = beta * model.scale`, and the model's
tables as `tables(model)` gives them; every EO wrapper takes the same state
and tables and the rank table, plus `eo_kw(model)`. The race wrappers of
the fused kernels (dense, sparse, pspin, replica) also take
`race_kw(model)`: the bound on their resident fields |lf| over every
configuration, from which they pick the fields' resident type. A family
without an EO kernel (the replica composites, in either package) has `eo`
None. A family whose float32 running E drifts (the xentr perceptron)
resyncs it from the resident state at every chunk boundary through
`resync(model, state, E)`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.dtypes import is_integer
from ..models.dense import FullyConnected
from ..ops.eo import eo_sparse_chunk
from ..ops.eo_dense import eo_dense_chunk
from ..ops.eo_pspin import eo_pspin_chunk
from ..ops.eo_perc import eo_perc_chunk
from ..ops.eo_sat import eo_sat_chunk
from ..ops.perc import (perc_rejfree_ok, perc_resync, perc_state,
                        perc_tables, rejfree_perc_chunk)
from ..ops.pspin import pspin_rejfree_ok, rejfree_pspin_chunk
from ..ops.rejfree import rejfree_sparse_chunk, sparse_rejfree_ok
from ..ops.rejfree_classes import rejfree_classes_chunk
from ..ops.rejfree_dense import (dense_rejfree_ok, kernel_couplings,
                                 rejfree_dense_chunk)
from ..ops.replica import (rejfree_replica_chunk, replica_base,
                           replica_dense_ok, replica_sparse_ok,
                           replica_state, replica_tables)
from ..ops.sat import rejfree_sat_chunk, sat_rejfree_ok, sat_tables
from ..utils.profiling import annotate, spanned

#: the models the kernels take, as the samplers' errors state it
ELIGIBLE = ("a Pairwise model with N >= 8, a FullyConnected one with N >= 8 "
            "and integer |J| <= 127 or float J, a PSpin3 with N >= 9, a "
            "SATModel with N >= 8 whose clauses hold distinct variables, a "
            "Perceptron with an odd N >= 9, +-1 patterns and a step, linear "
            "or xentr loss, or a GraphQuant / GraphRobustEnsemble composite "
            "over such a Pairwise or FullyConnected base")


def _no_kw(model) -> dict:
    return {}


class Family(NamedTuple):
    """A model family's kernels: its name (the routes kernel-rejfree-<name>
    and kernel-eo-<name>), its eligibility rule, its race and EO chunk
    wrappers, the model's tables as both wrappers take them, and the EO
    wrapper's further keyword arguments; then what a bound on the kernels'
    work counts: the largest |key| of the EO select over every
    configuration, None for float keys (it sizes the select's histogram:
    the pairwise EO wrappers take it as half_max, the hypergraph ones read
    it off their tables), and the resident fields one applied flip
    updates; the kernels' resident state (`aux_state` when None); and
    the resync of a drifting float32 E at chunk boundaries (None: none);
    the race wrapper's further keyword arguments; and the wrapper that
    runs bkl by energy classes in place of the race where its rule holds
    (`classes_ok` of ops/rejfree_classes.py; None: the race always)."""
    name: str
    eligible: Callable
    race: Callable
    eo: Optional[Callable]
    tables: Callable
    eo_kw: Callable
    key_max: Callable
    flip_sites: Callable
    state: Optional[Callable] = None
    resync: Optional[Callable] = None
    race_kw: Callable = _no_kw
    classes: Optional[Callable] = None


def aux_state(model, sigma, E):
    """The resident state of the pairwise and hypergraph kernels: the
    model's aux, and a copy of E in its dtype."""
    lf = model.init_aux(sigma).contiguous()
    return lf, E.to(lf.dtype).clone()


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
    with annotate("rrrmc.sync.field_bound"):
        return int(rows.max())


def _pairwise_kw(model) -> dict:
    return {"half_max": half_bound(model)}


def _replica_race_kw(model) -> dict:
    """The composite race's bound: its base's (the base fields are
    resident)."""
    return {"field_bound": half_bound(replica_base(model))}


FAMILIES = (
    Family("dense", dense_rejfree_ok, rejfree_dense_chunk, eo_dense_chunk,
           lambda m: (kernel_couplings(m),), _pairwise_kw, half_bound,
           lambda m: m.N, race_kw=lambda m: {"field_bound": half_bound(m)}),
    Family("sparse", sparse_rejfree_ok, rejfree_sparse_chunk,
           eo_sparse_chunk, lambda m: (m.neigh, m.J), _pairwise_kw,
           half_bound, lambda m: m.K,
           race_kw=lambda m: {"field_bound": half_bound(m)},
           classes=rejfree_classes_chunk),
    # key sigma_i c_i, |c_i| <= K; a flip moves the 2K partners' sums
    Family("pspin", pspin_rejfree_ok, rejfree_pspin_chunk, eo_pspin_chunk,
           lambda m: (m.A,), _no_kw, lambda m: m.K, lambda m: 2 * m.K,
           race_kw=lambda m: {"field_bound": m.K}),
    # key dE_i, |dE_i| <= Cmax; a flip moves the dE of the K variables of
    # each of the winner's Cmax clauses
    Family("sat", sat_rejfree_ok, rejfree_sat_chunk, eo_sat_chunk,
           sat_tables, _no_kw, lambda m: m.Cmax, lambda m: m.Cmax * m.K),
    # key dE_i, |dE_i| <= P (a flip moves each pattern's loss by at most
    # one); a flip moves the P stabilities
    Family("perc", perc_rejfree_ok, rejfree_perc_chunk, eo_perc_chunk,
           perc_tables, _no_kw, lambda m: m.P, lambda m: m.P, perc_state,
           perc_resync),
    # the replica composites: no EO kernel; a flip moves the Nk fields of
    # the dense base row, or the K of the sparse one, in the mover's replica
    Family("replica-dense", replica_dense_ok, rejfree_replica_chunk, None,
           replica_tables, _no_kw, lambda m: None, lambda m: m.Nk,
           replica_state, race_kw=_replica_race_kw),
    Family("replica-sparse", replica_sparse_ok, rejfree_replica_chunk, None,
           replica_tables, _no_kw, lambda m: None,
           lambda m: m.resid_m.base.K, replica_state,
           race_kw=_replica_race_kw),
)


@spanned("rrrmc.prep.route")
def family_of(model) -> Optional[Family]:
    """The first family whose kernels take `model`, or None: then bklMC,
    wtmMC and rrrMC take the generic torch path."""
    return next((f for f in FAMILIES if f.eligible(model)), None)


def inexact_reason(model) -> Optional[str]:
    """Why the model's own delta_all and flip do not follow its energy, so
    that no route of bklMC, wtmMC or rrrMC may run it; None for a sound
    model. Two models the JAX package builds and samples are refused: a
    SATModel whose clause holds a variable twice (delta_all and flip count
    such a clause's slots separately; ROADMAP.md queue 3) and a Perceptron
    whose patterns are not all +-1 (delta_all assumes a flip moves every
    stability by 2). Their energy invariant would fail on every route."""
    from ..models.perceptron import Perceptron
    from ..models.sat import SATModel
    from ..ops.perc import plus_minus_one
    from ..ops.sat import distinct_variables

    if isinstance(model, SATModel):
        # a sort of the clause table and a wait for it, once a call
        with annotate("rrrmc.prep.route"):
            distinct = distinct_variables(model)
        if not distinct:
            return ("a SATModel whose clauses hold distinct variables (a "
                    "repeated variable's slots count its clause twice)")
    if isinstance(model, Perceptron) and not plus_minus_one(model.xi):
        return ("a Perceptron with +-1 patterns (delta_all assumes a flip "
                "moves every stability by 2)")
    return None


def resident_state(fam: Family, model, sigma, E):
    """(resident state, E) of `model` as the family's kernels take them."""
    return (fam.state or aux_state)(model, sigma, E)
