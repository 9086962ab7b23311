"""rrrMC: reduced-rejection-rate Monte Carlo (the package's namesake).

Per move:

1. pick spin i proportionally to w_i = min(1, e^{-beta dE0_i}) computed on
   the *inner* model (for single models, the model itself), z = sum w;
2. compute z' = the same sum as if i were flipped (the staged reverse
   probability);
3. accept with probability min(1, (z / z') e^{-beta dE1}), dE1 the
   residual energy change of a Double model (0 for single models: the
   reference's SingleGraph path).

The race kernel of the model's family (samplers/families.py: ops/rejfree.py
for Pairwise models, ops/perc.py for the perceptrons, ..., mode "rrr")
picks i by an exponential race and evaluates the test in a shifted log
domain, exact when every weight underflows float32; on a GraphQuant /
GraphRobustEnsemble composite (ops/replica.py) it runs the SingleGraph law
on the flat composite. The generic torch path (`make_rrr_step`) flips i on
a copy of the state, takes z' from one weight pass over the copy, tests
acceptance in the log domain and keeps the copy only where it accepts; on a
Double it runs the reference's DoubleGraph law. The reference's adaptive
direct/staged switch (`staged_thr`) selects between two implementations of
this same Markov kernel, so the option is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.model import Model
from ..utils.profiling import spanned
from .bkl import kernel_route, rejfree_mc
from .common import (DEFAULT_SEED, MCState, clone_aux, init_state,
                     run_with_hook, series_to_chain_major, set_route,
                     working_copy)
from .moves import (acceptance_weights, accept_factor,
                    categorical_from_weights, inner_view, select_state)


def make_rrr_move(model: Model, beta: float):
    """The generic rrr move over a batch of chains.

    move(sigma, aux, E, accepted, u_mv, u_acc) draws site i from the inner
    model's weights with the uniforms u_mv [B] (the weights' arithmetic in
    u_mv's dtype), flips i on a copy of (sigma, aux) to get z', accepts
    with probability min(1, (z / z') e^{-beta dE1}) by u_acc [B], and
    writes the copy into sigma and aux, and dE into E, only where it
    accepts. Returns (i, acc)."""
    inner, get_iaux = inner_view(model)
    is_double = model.inner is not None

    def weights(sigma, aux, dtype):
        dE0 = inner.delta_all(sigma, get_iaux(aux))
        return dE0, acceptance_weights(inner.to_physical(dE0).to(dtype),
                                       beta)

    def move(sigma, aux, E, accepted, u_mv, u_acc):
        B = sigma.shape[0]
        rows = torch.arange(B, device=sigma.device)
        dE0, w = weights(sigma, aux, u_mv.dtype)
        i, z = categorical_from_weights(u_mv, w)
        dE1 = model.residual_delta_one(sigma, aux, i) if is_double else None
        # the hypothetical flip, on a copy: rejected chains keep theirs
        s2, a2 = model.flip(sigma.clone(), clone_aux(aux), i,
                            torch.ones(B, dtype=torch.bool,
                                       device=sigma.device))
        z2 = weights(s2, a2, u_mv.dtype)[1].sum(-1)
        x = -beta * dE1 if is_double else torch.zeros_like(z)
        acc = accept_factor(u_acc, z / z2, x)
        select_state(acc, (s2, a2), (sigma, aux))
        d = dE0[rows, i]
        if is_double:
            d = inner.to_physical(d) + dE1
        E.add_(torch.where(acc, d, torch.zeros_like(d)).to(E.dtype))
        accepted.add_(acc.to(torch.int32))
        return i, acc

    return move


def make_rrr_step(model: Model, beta: float):
    """The move as `run_with_hook` takes it: step(state) draws its two
    uniforms a chain from the state's generator."""
    move = make_rrr_move(model, beta)

    def step(st: MCState):
        B = st.sigma.shape[0]
        dev = st.sigma.device
        u_mv = torch.rand(B, generator=st.generator, device=dev)
        u_acc = torch.rand(B, generator=st.generator, device=dev)
        move(st.sigma, st.aux, st.E, st.accepted, u_mv, u_acc)

    return step


@spanned("rrrmc.call.rrrMC")
def rrrMC(model: Model, beta: float, iters: int, *, step: int = 1,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          observer=None, hook=None, hook_every: int = 10,
          state: Optional[MCState] = None, backend: str = "auto",
          chunk_moves: int = 1024, device=None):
    """Reduced-rejection-rate MC (`iters` counts moves). Returns
    (Es [chains, iters // step], final MCState).

    observer(model, sigma, aux, E) replaces the checkpoint energies with
    any per-chain observable; hook(it, model, state) -> False stops early,
    called every `hook_every` checkpoints (standardMC's protocol). The
    routes are bklMC's: "kernel" (the race kernel of the model's family,
    `chunk_moves` moves a launch), "torch" (the generic path,
    `make_rrr_step`, on any model, Doubles included), "auto" (the kernel
    where it takes the call)."""
    if not math.isfinite(beta):
        raise ValueError(f"beta must be finite, given: {beta}")
    fam = kernel_route("rrrMC", model, backend=backend, hook=hook,
                       observer=observer, iters=iters)
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    if fam is not None:
        return rejfree_mc(model, fam, float(beta), "rrr", int(iters),
                          int(step), state, iters // step, chunk_moves)
    state, series = run_with_hook(model, working_copy(state), float(beta),
                                  make_rrr_step, iters // step, step,
                                  observer, hook, hook_every)
    set_route("torch")
    return series_to_chain_major(series), state
