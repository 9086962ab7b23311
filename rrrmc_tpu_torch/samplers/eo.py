"""extremal_opt: tau-extremal optimisation ground-state search (the JAX
package's rrrmc_tpu/samplers/eo.py), batch-explicit.

Semantics follow the reference (RRRMC.jl's extremal_opt): rank all spins by
dE ascending (ties broken uniformly at random), draw a rank k with
P(k) ~ k^-tau, flip that spin unconditionally, and track the lowest-energy
configuration seen. The rank is drawn by inverse CDF on the static
cumulative k^-tau table (the reference's f_tau), the rank-k order statistic
is selected with a uniform race among equal values (ops/eo.py gives the
law).

Routes (`backend`):

* "kernel": the EO kernels, ops/eo.py for sparse Pairwise models (EA
  lattices included), ops/eo_dense.py for FullyConnected ones,
  ops/eo_pspin.py for PSpin3, ops/eo_sat.py for K-SAT and ops/eo_perc.py
  for the perceptrons (one table of the model families,
  samplers/families.py): the CUDA kernel for a CUDA
  state, its plain version on the CPU, one launch per call;
* "torch": the generic path on any model of the port, through
  `model.delta_all` and `model.flip`, drawing from the kernels' Philox
  streams, so on a model the kernels take it makes the same moves;
* "auto": "kernel" when the model is eligible, else "torch".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.model import Model
from ..ops import prng
from ..ops.eo import eo_draws, select_rank_with_ties, sort_key
from ..utils.profiling import annotate, spanned
from .common import (DEFAULT_SEED, MCState, init_state, kernel_seed,
                     set_route, working_copy)
from .families import ELIGIBLE, Family, family_of, resident_state


@dataclasses.dataclass(frozen=True, eq=False)
class EOResult:
    sigma: torch.Tensor      # [B, N] final configurations
    E: torch.Tensor          # [B] final physical energies
    Emin: torch.Tensor       # [B] best physical energies found
    sigma_min: torch.Tensor  # [B, N] best configurations
    itmin: torch.Tensor      # [B] move after which the best was reached


def _rank_cdf(n: int, tau: float) -> np.ndarray:
    """Cumulative P(rank <= k) with P(k) ~ k^{-tau}, in float64 (the
    reference's f_tau table)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-tau)
    c = np.cumsum(w)
    return c / c[-1]


def rank_table(n: int, tau: float, device) -> torch.Tensor:
    """[n] float32 rank table: `_rank_cdf` cast once, as the kernels read
    it."""
    return torch.tensor(_rank_cdf(n, tau).astype(np.float32), device=device)


def eo_kernel_route(model) -> Optional[str]:
    """The family of the EO kernel that takes `model` ("dense" for a
    FullyConnected model, "sparse" for a Pairwise one, lattices included,
    "pspin" for a PSpin3, "sat" for a SATModel, "perc" for a Perceptron),
    else None: the JAX
    package's `pallas_eo_eligible` without its TPU size caps and
    chain-block rule (the shared-memory limit is checked at launch). A
    family without an EO kernel (the replica composites) gives None: such a
    model takes the torch route."""
    fam = _eo_family(model)
    return None if fam is None else fam.name


def _eo_family(model) -> Optional[Family]:
    """The family whose EO kernel takes `model`, else None."""
    fam = family_of(model)
    return None if fam is None or fam.eo is None else fam


def _eo_kernel(model, fam: Family, cdf, state: MCState, iters: int):
    with annotate("rrrmc.prep.resident_state"):
        seed = kernel_seed(state.generator)
        sigma = state.sigma.clone()
        lf, E = resident_state(fam, model, sigma, state.E)
        emin, smin = E.clone(), sigma.clone()
        itmin = torch.zeros(E.shape, dtype=torch.int32, device=E.device)
        tables = fam.tables(model)
        eo_kw = fam.eo_kw(model)
    fam.eo(sigma, lf, E, emin, smin, itmin, *tables, cdf, n_moves=iters,
           seed=seed, chain0=state.chain0, **eo_kw)
    set_route(f"kernel-eo-{fam.name}",
              impl="cuda" if sigma.device.type == "cuda" else "plain")
    return sigma, E, emin, smin, itmin


def _eo_torch(model, cdf, state: MCState, iters: int):
    """The generic move on `model.delta_all` / `model.flip`, with the
    kernels' streams (chain ids chain0 .. chain0 + B - 1)."""
    seed = kernel_seed(state.generator)
    st = working_copy(state)
    sigma, aux, E = st.sigma, st.aux, st.E
    B, N = sigma.shape
    rows = torch.arange(B, device=sigma.device)
    do = torch.ones(B, dtype=torch.bool, device=sigma.device)
    emin, smin = E.clone(), sigma.clone()
    itmin = torch.zeros(B, dtype=torch.int32, device=E.device)
    rank_draws, tie_draws = eo_draws(seed, state.chain0, B, N, 0, iters,
                                     sigma.device)
    for m in range(iters):
        dE = model.delta_all(sigma, aux)
        rank = torch.searchsorted(cdf, prng.to_uniform(next(rank_draws)))
        i = select_rank_with_ties(sort_key(dE), rank, next(tie_draws))
        E = E + dE[rows, i]
        sigma, aux = model.flip(sigma, aux, i, do)
        better = E < emin
        emin = torch.where(better, E, emin)
        smin = torch.where(better[:, None], sigma, smin)
        itmin = torch.where(better, m + 1, itmin)
    set_route("torch", impl="plain")
    return sigma, E, emin, smin, itmin


@spanned("rrrmc.call.extremal_opt")
def extremal_opt(model: Model, tau: float, iters: int, *, step: int = 1,
                 chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
                 state: Optional[MCState] = None, backend: str = "auto",
                 block_chains: Optional[int] = None,
                 device=None) -> EOResult:
    """Ground-state search: `iters` EO moves per chain; returns an EOResult
    (the reference's (C, Emin, Cmin, itmin)) with physical energies.

    backend "kernel": the EO kernels (samplers/families.py: a Pairwise
    model with N >= 8 whose couplings and fields are both integer or both
    finite floats; a FullyConnected one with integer |J| <= 127 or float J;
    a PSpin3 with N >= 9; a SATModel with N >= 8 whose clauses hold distinct
    variables; a Perceptron with an odd N >= 9 and a step, linear or xentr
    loss), raising for other models; "torch": the generic path on any
    model; "auto": "kernel" when the model is eligible, else "torch".
    `step` is unused, as in the JAX package (EO records no series);
    `block_chains`, the JAX package's TPU chain block, has no counterpart
    (one thread block per chain) and must be None."""
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if block_chains is not None:
        raise ValueError("block_chains is a TPU chain-block width; the port "
                         "runs one thread block per chain")
    if not 0 <= iters < 2 ** 31:
        raise ValueError(f"iters must be in [0, 2^31), given {iters}")
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    fam = _eo_family(model) if backend != "torch" else None
    if backend == "kernel" and fam is None:
        raise NotImplementedError(
            f"extremal_opt(backend='kernel'): {type(model).__name__} is not "
            f"eligible for the EO kernels ({ELIGIBLE})")
    with annotate("rrrmc.prep.rank_table"):
        cdf = rank_table(model.N, float(tau), state.sigma.device)
    if fam is None:
        sigma, E, emin, smin, itmin = _eo_torch(model, cdf, state, iters)
    else:
        sigma, E, emin, smin, itmin = _eo_kernel(model, fam, cdf, state,
                                                 iters)
    return EOResult(sigma=sigma, E=model.to_physical(E),
                    Emin=model.to_physical(emin), sigma_min=smin,
                    itmin=itmin)
