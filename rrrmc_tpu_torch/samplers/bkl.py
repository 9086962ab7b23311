"""bklMC: rejection-free Bortz-Kalos-Lebowitz, and the race-kernel loop
shared by bklMC / wtmMC / rrrMC.

Semantics follow the reference: each move draws a geometric number of
virtually-rejected iterations `skip` with success probability z/N, then an
always-accepted move proportional to w_i = min(1, e^{-beta dE_i}); the
iteration counter advances by skip+1, so results are directly comparable
with standardMC at equal `iters`.

Chains advance different numbers of virtual iterations per move, so
checkpoints cannot be emitted in lockstep. Each chunk of moves records a
per-chain (coordinate, energy) stream, and checkpoint energies are filled by
a batched searchsorted over the stream: the batch generalization of the
reference's checkpoint drain loop.

This port runs bkl, wtm and rrr on the race kernels only, one per model
family (samplers/families.py): the sparse one (ops/rejfree.py) for Pairwise
models, the dense one (ops/rejfree_dense.py) for FullyConnected models, and
the hypergraph ones (ops/pspin.py, ops/sat.py) for PSpin3 and K-SAT; their
generic torch paths, with hooks and observers, are ROADMAP.md queue 1,
item 3.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.model import Model
from ..ops.rejfree import coord_dtype
from .common import DEFAULT_SEED, MCState, init_state, kernel_seed, set_route
from .families import ELIGIBLE, family_of

#: iteration targets above this would overflow the kernels' int32
#: coordinates
MAX_ITERS = 10 ** 9


def require_kernel_route(sampler: str, model, *, backend: str, hook,
                         observer):
    """Raise unless the call can run on a race kernel."""
    later = "ROADMAP.md queue 1, item 3 (the generic torch samplers)"
    if backend not in ("auto", "kernel"):
        raise NotImplementedError(
            f"{sampler}(backend={backend!r}): only the kernel route is "
            f"ported; the generic torch path is {later}")
    if hook is not None or observer is not None:
        raise NotImplementedError(
            f"{sampler} with a hook or an observer needs the generic torch "
            f"path: {later}")
    if family_of(model) is None:
        raise NotImplementedError(
            f"{sampler}: {type(model).__name__} is not eligible for the "
            f"race kernels ({ELIGIBLE}), and the generic torch path is "
            f"{later}")


def fill_checkpoints(S, step, x_start, o_start, xs, os_):
    """Fill the checkpoint series S [B, K] (checkpoint coordinate
    ns_k = (k+1)*step) with the observable in effect just before the first
    move whose post-move coordinate reaches ns_k. xs / os_: [chunk, B]
    per-move coordinate and observable streams (xs non-decreasing per
    chain); x_start / o_start [B]: values at the chunk start."""
    B, n_ckpt = S.shape
    ns = (torch.arange(1, n_ckpt + 1, dtype=xs.dtype, device=xs.device)
          * torch.tensor(step, dtype=xs.dtype, device=xs.device))
    xb = xs.t().contiguous()
    idx = torch.searchsorted(xb, ns.expand(B, n_ckpt).contiguous(),
                             right=False)        # moves strictly before ns
    vals = torch.cat([o_start[:, None], os_.t()], dim=1).gather(1, idx)
    newly = (ns[None, :] > x_start[:, None]) & (ns[None, :] <= xb[:, -1:])
    return torch.where(newly, vals.to(S.dtype), S)


def rejfree_mc(model, beta: float, mode: str, target, step,
               state: MCState, n_ckpt: int, chunk_moves: int):
    """Run the race kernel in chunks of `chunk_moves` moves until every
    chain's coordinate reaches `target`; one host sync per chunk.
    Returns (Es [B, n_ckpt] physical energies, final MCState); `accepted`
    gains the applied flips, and LAST_ROUTE holds acc and the summed z/N.
    The model's family picks the kernel (samplers/families.py)."""
    fam = family_of(model)
    B = state.sigma.shape[0]
    dev = state.sigma.device
    seed = kernel_seed(state.generator)
    sigma = state.sigma.clone()
    lf = model.init_aux(sigma)
    E = state.E.to(lf.dtype).clone()
    ct = coord_dtype(mode)
    coord = torch.zeros(B, dtype=ct, device=dev)
    acc = torch.zeros(B, dtype=torch.int32, device=dev)
    zacc = torch.zeros(B, dtype=torch.float32, device=dev)
    Es = torch.zeros((B, n_ckpt), dtype=torch.float32, device=dev)
    tables = fam.tables(model)
    k = 0
    while bool(coord.min() < target):
        x_start = coord.clone()
        e_start = model.to_physical(E)
        cs, es = fam.race(
            sigma, lf, E, coord, acc, zacc, *tables, mode=mode,
            n_moves=chunk_moves, beta_s=beta * model.scale, target=target,
            seed=seed, move0=k * chunk_moves)
        Es = fill_checkpoints(Es, step, x_start, e_start, cs,
                              model.to_physical(es))
        k += 1
    set_route(f"kernel-rejfree-{fam.name}",
              impl="cuda" if dev.type == "cuda" else "plain", mode=mode,
              acc=acc, z_over_n=zacc, chunks=k)
    return Es, MCState(sigma=sigma, aux=model.init_aux(sigma), E=E,
                       accepted=state.accepted + acc,
                       generator=state.generator)


def bklMC(model: Model, beta: float, iters: int, *, step: int = 1,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          chunk_moves: int = 1024, hook=None, observer=None,
          state: Optional[MCState] = None, backend: str = "auto",
          device=None):
    """Rejection-free BKL; `iters` counts virtual (rejected-inclusive)
    iterations. Returns (Es [chains, iters // step], final MCState).

    Runs on the race kernel of the model's family (families.py: the CUDA
    kernel for a CUDA state, its plain version on the CPU), `chunk_moves`
    moves per launch. backend "auto" and "kernel" both take it; hooks, observers and
    ineligible models raise NotImplementedError."""
    require_kernel_route("bklMC", model, backend=backend, hook=hook,
                         observer=observer)
    if iters > MAX_ITERS:
        raise ValueError(f"bklMC: iters must be <= {MAX_ITERS}")
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    return rejfree_mc(model, float(beta), "bkl", int(iters), int(step),
                      state, iters // step, chunk_moves)
