"""standardMC: Metropolis with uniform single-spin proposals.

Per move each chain proposes a site, computes dE from the local-field aux in
O(1), accepts with min(1, e^{-beta dE}) (the reference's `accept`) and
applies a masked O(degree) flip. Checkpoint energies are recorded every
`step` moves.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.model import Model
from ..core.dtypes import is_integer
from ..utils.profiling import annotate, spanned
from .common import (DEFAULT_SEED, MCState, init_state, init_lfT,
                     kernel_seed, run_with_hook, series_to_chain_major,
                     set_route, working_copy)


def metropolis_accept(u, x):
    """Accept iff x >= 0 or u < e^x (the reference's `accept`), with u [B]
    uniform."""
    return (x >= 0) | (u < torch.exp(torch.clamp(x, max=0.0)))


def make_metropolis_step(model: Model, beta: float):
    n = model.N

    def step(st: MCState):
        B = st.sigma.shape[0]
        dev = st.sigma.device
        i = torch.randint(0, n, (B,), generator=st.generator, device=dev)
        u = torch.rand(B, generator=st.generator, device=dev)
        dE = model.delta_one(st.sigma, st.aux, i)
        acc = metropolis_accept(u, -beta * model.to_physical(dE))
        model.flip(st.sigma, st.aux, i, acc)
        st.E.add_(torch.where(acc, dE, torch.zeros_like(dE)))
        st.accepted.add_(acc.to(torch.int32))

    return step


@spanned("rrrmc.call.standardMC")
def standardMC(model: Model, beta: float, iters: int, *, step: int = 1,
               chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
               observer=None, hook=None, hook_every: int = 10,
               state: Optional[MCState] = None, backend: str = "torch",
               device=None):
    """Run `iters` Metropolis moves per chain; returns (Es, state).

    Es: [chains, iters // step] physical energies at each checkpoint.
    state: final MCState (a warm restart handle: pass it back as state=).
    hook(it, model, state) -> bool is the reference hook protocol: called
    every `hook_every` checkpoints; returning False stops early.

    backend="torch" (default): every chain draws its own site sequence.
    backend="kernel": the single-site kernel (ops/site.py; the CUDA kernel
    for a CUDA state, its plain version on the CPU). Each chain is still an
    exact Metropolis chain but the site SCHEDULE is shared across the batch,
    so chains are not mutually independent: do not feed them to cross-chain
    error estimators. Pairwise models only, no hook/observer.
    backend="auto": "kernel" for an eligible hookless call, else "torch"."""
    from ..models.pairwise import Pairwise

    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    kernel_ok = (isinstance(model, Pairwise) and hook is None
                 and observer is None)
    if backend == "auto":
        backend = "kernel" if kernel_ok else "torch"
    if backend == "kernel":
        if not kernel_ok:
            raise NotImplementedError(
                "standardMC(backend='kernel') takes Pairwise models without "
                "hook or observer")
        return _standard_kernel(model, float(beta), iters, step, state)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    set_route("torch")
    state, series = run_with_hook(model, working_copy(state), float(beta),
                                  make_metropolis_step, iters // step, step,
                                  observer, hook, hook_every)
    return series_to_chain_major(series), state


def _standard_kernel(model, beta, iters, step, state):
    from ..ops.site import SiteSampler

    with annotate("rrrmc.prep.site_sampler"):
        ps = SiteSampler(model, beta)
    gen = state.generator
    with annotate("rrrmc.prep.init_lfT"):
        seed = kernel_seed(gen)
        sigT = state.sigma.t().contiguous()
        lfT = init_lfT(model, state.sigma)
        E = state.E.to(torch.int32 if is_integer(model.J)
                       else torch.float32).clone()
        acc = state.accepted.clone()
    n_ckpt = iters // step
    Es = []
    for c in range(n_ckpt):
        ps(sigT, lfT, E, acc, generator=gen, seed=seed, n_moves=step,
           move0=c * step, chain0=state.chain0)
        with annotate("rrrmc.post.checkpoint"):
            Es.append(model.to_physical(E))
    if iters % step:
        ps(sigT, lfT, E, acc, generator=gen, seed=seed,
           n_moves=iters % step, move0=n_ckpt * step, chain0=state.chain0)
    B = sigT.shape[1]
    E_series = (torch.stack(Es, dim=1) if Es else
                torch.zeros((B, 0), dtype=torch.float32, device=E.device))
    set_route("kernel-site",
              impl="cuda" if sigT.device.type == "cuda" else "plain")
    state = MCState(sigma=sigT.t().contiguous(), aux=lfT.t().contiguous(),
                    E=E, accepted=acc, generator=gen, chain0=state.chain0)
    return E_series, state
