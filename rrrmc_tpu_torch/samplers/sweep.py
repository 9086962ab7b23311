"""sweepMC: Metropolis over whole sweeps (N attempted flips per chain each).

Pairwise models take three routes, chosen as the JAX package's
`rrrmc_tpu/samplers/sweep.py` chooses them:

(a) the checkerboard kernel (ops/sweep.py) for a LatticeEA with integer
    couplings and fields and an even L: one launch per checkpoint, exact
    int32 energies, the spins resident for the whole checkpoint, the last
    launch writing the final local fields (`MCState.aux`);
(b) the site-sweep route for every other sparse Pairwise model with N >= 8
    (RRG, float or odd-L lattices, EA L=2): the single-site kernel
    (ops/site.py) on a schedule of random permutations, so every sweep
    attempts each site exactly once;
(c) the generic torch colour-mask sweep: per colour class of a greedy
    colouring (the checkerboard for even-L lattices) every chain decides
    all sites of the class at once against fixed neighbours, a product of
    independent single-site Metropolis moves with the same stationary law.

Routes (a) and (b) run their CUDA kernel for a CUDA state and its plain
version on the CPU. `accepted` follows the JAX routes: (b) adds the applied
flips, (a) and (c) leave it as it was.

A FullyConnected model is routed by structure, as in the JAX package: the
dense sweep kernel when it is eligible (samplers/dense_sweep.py, backend
"kernel"); else the delayed-update torch route when some spin has more than
32 couplings; else route (c) on the colouring of J's sparsity pattern.

A GraphQuant / GraphRobustEnsemble / GraphLocalEntropy /
GraphTopologicalLocalEntropy composite over a sparse Pairwise base takes the
composite colour-mask sweep (the JAX package's plain-XLA route, in plain
torch): masks of one slot (a replica, or LE's and TLE's centre block) times
one colour class of the base, so no mask holds two interacting spins (the
ring, the star and the LE star couple only spins of one site, the base only
the spins of one replica, TLE's 4-spin term only spins of two adjacent sites
in two slots); route (c) then decides all members of a mask at once on the
composite's `delta_all`. Quant and RE composites over a dense base take
`sweepMC_quant` (dense_sweep.py); any other model raises, as the JAX
package's sweepMC asserts a Pairwise model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.dense import FullyConnected
from ..models.pairwise import Pairwise
from ..ops.site import SiteSampler
from ..ops.sk import sk_sweep_eligible
from ..ops.sweep import Sweeper, sweep_eligible
from ..utils.profiling import annotate, spanned
from .common import (DEFAULT_SEED, MCState, cached, init_lfT, init_state,
                     kernel_seed, physical_series, set_route, working_copy)
from .dense_sweep import sweepMC_dense

#: a FullyConnected model with a spin of more couplings than this takes the
#: delayed-update route instead of a colouring (the JAX package's threshold)
DENSE_DEGREE = 32


def greedy_coloring(neigh: np.ndarray, n: int) -> np.ndarray:
    """[N] colour ids such that no edge joins two sites of one colour
    (first-fit greedy; the exact 2-colouring for bipartite lattices)."""
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        used = {colors[j] for j in neigh[i] if j < n and colors[j] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def color_masks(model: Pairwise) -> torch.Tensor:
    """[C, N] boolean independent-set masks of a Pairwise model, on its
    device."""
    return _masks(greedy_coloring(model.neigh.cpu().numpy(), model.N),
                  model.device)


def color_masks_dense(model: FullyConnected) -> torch.Tensor:
    """[C, N] masks from the sparsity pattern of a dense coupling matrix."""
    J = model.J.cpu().numpy()
    n = model.N
    rows = [np.nonzero(J[i])[0] for i in range(n)]
    neigh = np.full((n, max((len(r) for r in rows), default=0) or 1), n,
                    dtype=np.int32)
    for i, r in enumerate(rows):
        neigh[i, : len(r)] = r
    return _masks(greedy_coloring(neigh, n), model.device)


def _masks(colors: np.ndarray, device) -> torch.Tensor:
    ncol = int(colors.max()) + 1
    return torch.as_tensor(np.stack([colors == c for c in range(ncol)]),
                           device=device)


def composite_masks(model):
    """[C * S, N] independent-set masks of a GraphQuant /
    GraphRobustEnsemble / GraphLocalEntropy / GraphTopologicalLocalEntropy
    composite over a sparse Pairwise base: mask s * C + c is colour class c
    of the base in slot s of the S = n_slots blocks (LE's and TLE's centre
    block first), on the base's device; None for other models or a base
    whose greedy colouring needs more than 32 colours."""
    from ..models.replicas import (LEModel, QuantModel, Replicated, REModel,
                                   TLEModel)

    if not isinstance(model, (QuantModel, REModel, LEModel, TLEModel)):
        return None
    resid = model.resid_m
    if not (isinstance(resid, Replicated)
            and isinstance(resid.base, Pairwise)):
        return None
    base = resid.base
    colors = greedy_coloring(base.neigh.cpu().numpy(), base.N)
    ncol = int(colors.max()) + 1
    if ncol > 32:
        return None
    Nk, S = resid.Nk, resid.n_slots
    masks = np.zeros((ncol * S, Nk * S), dtype=bool)
    for s in range(S):
        for c in range(ncol):
            masks[s * ncol + c, s * Nk:(s + 1) * Nk] = colors == c
    return torch.as_tensor(masks, device=base.device)


def _impl(t: torch.Tensor) -> str:
    return "cuda" if t.device.type == "cuda" else "plain"


#: Sweepers of route (a), keyed on the identity of the coupling AND field
#: tensors (a field variant made by dataclasses.replace shares Jd with its
#: base), the scale and beta
_SWEEPERS: dict = {}
#: colourings of sparse FullyConnected models, keyed on the identity of J
_MASKS: dict = {}


def _sweeper(model, beta: float) -> Sweeper:
    """The cached Sweeper of (model.Jd, model.h, model.scale, beta), so that
    repeated and checkpointed calls reuse its device tables."""
    return cached(_SWEEPERS, (model.Jd, model.h), (model.scale, beta),
                  lambda: Sweeper(model, beta))


def _run_checkerboard(model, beta, n_ckpt, step, state):
    """Route (a): one kernel launch per checkpoint; the sweeps continue one
    Philox stream across launches, and the last launch writes the local
    fields of the final spins into `aux` (LAST_ROUTE["aux"] "kernel"). A
    call with no checkpoint launches nothing and computes them with
    `init_aux` ("torch")."""
    with annotate("rrrmc.prep.sweeper"):
        sweeper = _sweeper(model, beta)
        seed = kernel_seed(state.generator)
        sigma, E = state.sigma.clone(), state.E.clone()
        aux = torch.empty_like(sigma, dtype=torch.int32)
    assert aux.dtype == model.Jd.dtype
    Es = []
    for k in range(n_ckpt):
        sweeper(sigma, E, seed=seed, n_sweeps=step, sweep0=k * step,
                chain0=state.chain0, aux=aux if k == n_ckpt - 1 else None)
        with annotate("rrrmc.post.checkpoint"):
            Es.append(model.to_physical(E))
    set_route("kernel-sweep", impl=_impl(sigma), table=sweeper.table,
              aux="kernel" if n_ckpt else "torch")
    if not n_ckpt:
        with annotate("rrrmc.post.init_aux"):
            aux = model.init_aux(sigma)
    state = MCState(sigma=sigma, aux=aux, E=E,
                    accepted=state.accepted.clone(),
                    generator=state.generator, chain0=state.chain0)
    return physical_series(Es, sigma.shape[0], sigma.device), state


def _run_site_sweep(model, beta, n_ckpt, step, state, sampler=None):
    """Route (b): the single-site kernel on the permutation schedule, step
    sweeps (step * N moves) per checkpoint, at beta; `sampler` is a
    SiteSampler of the model prepared earlier (tempering's sweep_kernel
    keeps one a slot)."""
    if sampler is None:
        sampler = SiteSampler(model, beta)
    gen = state.generator
    seed = kernel_seed(gen)
    sigT = state.sigma.t().contiguous()
    lfT = init_lfT(model, state.sigma)
    E = state.E.clone()
    acc = torch.zeros_like(state.accepted)
    moves = step * model.N
    Es = []
    for k in range(n_ckpt):
        sampler(sigT, lfT, E, acc, generator=gen, seed=seed, n_moves=moves,
                move0=k * moves, chain0=state.chain0, sweep_schedule=True,
                beta_s=float(beta) * model.scale)
        with annotate("rrrmc.post.checkpoint"):
            Es.append(model.to_physical(E))
    set_route("kernel-site-sweep", impl=_impl(sigT), acc=acc)
    state = MCState(sigma=sigT.t().contiguous(), aux=lfT.t().contiguous(),
                    E=E, accepted=state.accepted + acc, generator=gen,
                    chain0=state.chain0)
    return physical_series(Es, sigT.shape[1], sigT.device), state


def _run_color_masks(model, beta, n_ckpt, step, state, masks=None):
    """Route (c), and the composites' mask sweep: the colour-mask sweep in
    plain torch on the model's delta_all, uniforms from the state's
    generator; beta is a float, or a [B] tensor of each chain's (a
    tempering ladder's)."""
    if torch.is_tensor(beta):
        beta = beta[:, None]
    if masks is None:
        masks = (model.sweep_masks() if hasattr(model, "sweep_masks")
                 else color_masks(model))
    st = working_copy(state)
    sigma, E, gen = st.sigma, st.E, st.generator
    aux = model.init_aux(sigma)
    zero = torch.zeros((), dtype=E.dtype, device=E.device)
    Es = []
    for _ in range(n_ckpt):
        for _ in range(step):
            for mask in masks:
                dE = model.delta_all(sigma, aux)
                x = -beta * model.to_physical(dE)
                u = torch.rand(sigma.shape, generator=gen,
                               device=sigma.device)
                acc = mask & ((x >= 0) | (u < torch.exp(x.clamp(max=0.0))))
                sigma = torch.where(acc, -sigma, sigma)
                E = E + torch.where(acc, dE, zero).sum(dim=1, dtype=E.dtype)
                aux = model.init_aux(sigma)
        Es.append(model.to_physical(E))
    set_route("torch", impl="torch", n_masks=int(masks.shape[0]))
    state = MCState(sigma=sigma, aux=aux, E=E, accepted=st.accepted,
                    generator=gen, chain0=st.chain0)
    return physical_series(Es, sigma.shape[0], sigma.device), state


@spanned("rrrmc.call.sweepMC")
def sweepMC(model, beta: float, sweeps: int, *, step: int = 1,
            chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
            state: Optional[MCState] = None, backend: str = "auto",
            device=None):
    """Run `sweeps` full sweeps (N attempted flips each) per chain, in
    sweeps // step checkpoints of `step` sweeps (the JAX package's count: a
    remainder of sweeps is not run). Returns (Es [chains, sweeps // step]
    physical energies, final MCState).

    Same stationary law as standardMC; use it for throughput and
    equilibrium observables, standardMC where strict single-site dynamics
    matter.

    backend "auto": route (a) for an even-L integer LatticeEA, else route
    (b) for a sparse Pairwise model with N >= 8, else route (c) (see the
    module docstring). "kernel": route (a) or (b), raising when neither
    takes the model. "torch": route (c). A FullyConnected model takes the
    dense routes of the module docstring ("kernel": the dense sweep kernel
    or raise; "torch": never the kernel). A GraphQuant /
    GraphRobustEnsemble / GraphLocalEntropy / GraphTopologicalLocalEntropy
    composite over a sparse base takes route (c) on its slot x colour masks
    ("kernel" raises)."""
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if isinstance(model, FullyConnected):
        return _sweep_dense(model, beta, sweeps, step, chains, seed, C0,
                            state, backend, device)
    if not isinstance(model, Pairwise):
        masks = composite_masks(model)
        if masks is None:
            raise NotImplementedError(
                f"sweepMC on {type(model).__name__}: sweepMC requires a "
                f"Pairwise model, a FullyConnected one, or a GraphQuant / "
                f"GraphRobustEnsemble / GraphLocalEntropy / "
                f"GraphTopologicalLocalEntropy composite over a sparse "
                f"Pairwise base (Quant and RE composites over a dense "
                f"base: sweepMC_quant), as the JAX package's does")
        if backend == "kernel":
            raise NotImplementedError(
                "sweepMC(backend='kernel'): no sweep kernel takes a "
                "composite over a sparse base (the JAX package runs it as "
                "plain XLA)")
        if state is None:
            state = init_state(model, chains, seed, C0, device=device)
        return _run_color_masks(model, float(beta), sweeps // step, step,
                                state, masks=masks)
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    beta = float(beta)
    n_ckpt = sweeps // step
    if backend != "torch" and sweep_eligible(model):
        Es, state = _run_checkerboard(model, beta, n_ckpt, step, state)
    elif backend != "torch" and model.N >= 8:
        Es, state = _run_site_sweep(model, beta, n_ckpt, step, state)
    elif backend == "kernel":
        raise NotImplementedError(
            f"sweepMC(backend='kernel'): no sweep kernel takes "
            f"{type(model).__name__} with N={model.N} (N >= 8 needed)")
    else:
        Es, state = _run_color_masks(model, beta, n_ckpt, step, state)
    return Es, state


def _sweep_dense(model, beta, sweeps, step, chains, seed, C0, state, backend,
                 device):
    """The routes of a FullyConnected model (module docstring)."""
    kw = dict(step=step, chains=chains, seed=seed, C0=C0, state=state,
              device=device)
    if backend != "torch" and sk_sweep_eligible(model):
        return sweepMC_dense(model, beta, sweeps, backend="kernel", **kw)
    if backend == "kernel":
        raise NotImplementedError(
            "sweepMC(backend='kernel'): the dense sweep kernel takes integer "
            "couplings |J| <= 127 and integer fields only")
    if model.max_degree > DENSE_DEGREE:
        return sweepMC_dense(model, beta, sweeps, backend="torch", **kw)
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    return _run_color_masks(model, float(beta), sweeps // step, step, state,
                            masks=cached(_MASKS, (model.J,), (),
                                         lambda: color_masks_dense(model)))
