"""sweepMC: Metropolis over whole sweeps (N attempted flips per chain each).

Three routes, chosen as the JAX package's `rrrmc_tpu/samplers/sweep.py`
chooses them:

(a) the checkerboard kernel (ops/sweep.py) for a LatticeEA with integer
    couplings and fields and an even L: one launch per checkpoint, exact
    int32 energies, the spins resident for the whole checkpoint;
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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.pairwise import Pairwise
from ..ops.site import SiteSampler
from ..ops.sweep import Sweeper, sweep_eligible
from .common import (DEFAULT_SEED, MCState, init_lfT, init_state, kernel_seed,
                     set_route, working_copy)


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
    colors = greedy_coloring(model.neigh.cpu().numpy(), model.N)
    ncol = int(colors.max()) + 1
    return torch.as_tensor(np.stack([colors == c for c in range(ncol)]),
                           device=model.device)


def _physical(Es: list, B: int, device) -> torch.Tensor:
    if not Es:
        return torch.zeros((B, 0), dtype=torch.float32, device=device)
    return torch.stack(Es, dim=1)


def _impl(t: torch.Tensor) -> str:
    return "cuda" if t.device.type == "cuda" else "plain"


#: Sweepers of route (a), keyed on the identity of the coupling AND field
#: tensors (a field variant made by dataclasses.replace shares Jd with its
#: base), the scale and beta; the oldest is dropped beyond _SWEEPERS_MAX
_SWEEPERS: dict = {}
_SWEEPERS_MAX = 8


def _sweeper(model, beta: float) -> Sweeper:
    """The cached Sweeper of (model.Jd, model.h, model.scale, beta), so that
    repeated and checkpointed calls reuse its device tables."""
    key = (id(model.Jd), id(model.h), model.scale, beta)
    ent = _SWEEPERS.get(key)
    if ent is None or ent[0] is not model.Jd or ent[1] is not model.h:
        if key not in _SWEEPERS and len(_SWEEPERS) >= _SWEEPERS_MAX:
            _SWEEPERS.pop(next(iter(_SWEEPERS)))
        ent = (model.Jd, model.h, Sweeper(model, beta))
        _SWEEPERS[key] = ent
    return ent[2]


def _run_checkerboard(model, beta, n_ckpt, step, state):
    """Route (a): one kernel launch per checkpoint; the sweeps continue one
    Philox stream across launches."""
    sweeper = _sweeper(model, beta)
    seed = kernel_seed(state.generator)
    sigma, E = state.sigma.clone(), state.E.clone()
    Es = []
    for k in range(n_ckpt):
        sweeper(sigma, E, seed=seed, n_sweeps=step, sweep0=k * step)
        Es.append(model.to_physical(E))
    set_route("kernel-sweep", impl=_impl(sigma), table=sweeper.table)
    state = MCState(sigma=sigma, aux=model.init_aux(sigma), E=E,
                    accepted=state.accepted.clone(),
                    generator=state.generator)
    return _physical(Es, sigma.shape[0], sigma.device), state


def _run_site_sweep(model, beta, n_ckpt, step, state):
    """Route (b): the single-site kernel on the permutation schedule, step
    sweeps (step * N moves) per checkpoint."""
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
                move0=k * moves, sweep_schedule=True)
        Es.append(model.to_physical(E))
    set_route("kernel-site-sweep", impl=_impl(sigT), acc=acc)
    state = MCState(sigma=sigT.t().contiguous(), aux=lfT.t().contiguous(),
                    E=E, accepted=state.accepted + acc, generator=gen)
    return _physical(Es, sigT.shape[1], sigT.device), state


def _run_color_masks(model, beta, n_ckpt, step, state):
    """Route (c): the colour-mask sweep in plain torch, uniforms from the
    state's generator."""
    masks = (model.sweep_masks() if hasattr(model, "sweep_masks")
             else color_masks(model))
    st = working_copy(state)
    sigma, E, gen = st.sigma, st.E, st.generator
    lf = model.local_fields(sigma)
    zero = torch.zeros((), dtype=E.dtype, device=E.device)
    Es = []
    for _ in range(n_ckpt):
        for _ in range(step):
            for mask in masks:
                dE = 2 * sigma.to(lf.dtype) * lf
                x = -beta * model.to_physical(dE)
                u = torch.rand(sigma.shape, generator=gen,
                               device=sigma.device)
                acc = mask & ((x >= 0) | (u < torch.exp(x.clamp(max=0.0))))
                sigma = torch.where(acc, -sigma, sigma)
                E = E + torch.where(acc, dE, zero).sum(dim=1, dtype=E.dtype)
                lf = model.local_fields(sigma)
        Es.append(model.to_physical(E))
    set_route("torch", impl="torch", n_masks=int(masks.shape[0]))
    state = MCState(sigma=sigma, aux=lf, E=E, accepted=st.accepted,
                    generator=gen)
    return _physical(Es, sigma.shape[0], sigma.device), state


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
    takes the model. "torch": route (c)."""
    if not isinstance(model, Pairwise):
        raise NotImplementedError(
            f"sweepMC on {type(model).__name__}: only Pairwise models are "
            f"ported; FullyConnected is ROADMAP.md queue 1, item 9, the "
            f"replica composites item 10")
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
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
