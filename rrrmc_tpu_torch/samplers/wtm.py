"""wtmMC: rejection-free waiting-time method (Dall & Sibani).

Every spin carries an exponential firing time with mean
tau_i = max(1, e^{beta dE_i}); the earliest clock fires, that spin flips,
and the clocks are redrawn. Global time replaces the iteration counter;
`step` is measured in global time scaled by 1/N (the reference's
convention).

The race kernel of the model's family (samplers/families.py: ops/rejfree.py
for Pairwise models, ops/perc.py for the perceptrons, ...) redraws ALL
clocks each move, which by exponential memorylessness is distributionally
identical to the reference's neighbour-only redraw: the race scores are the
redraw, and the clock advances by the winning time exp(min score).

The generic torch path (`make_wtm_move`) keeps absolute firing times
[B, N] and redraws, after each flip, the fired spin's clock and those of
the spins `model.neighbor_table()` lists for it (the reference's update,
O(degree) draws a move); a model without a table redraws every clock.
Checkpoints are filled as bklMC's, with float global time as the
coordinate.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.model import Model
from ..utils.profiling import spanned
from .bkl import kernel_route, rejfree_mc, stream_mc
from .common import (DEFAULT_SEED, MCState, init_state, set_route,
                     working_copy)


def draw_times(u, model: Model, sigma, aux, beta, t_now):
    """Fresh absolute firing times t_now + Exp(mean tau_i),
    tau_i = max(1, e^{beta dE_i}), from uniforms u [B, N] (the reference's
    THeap init); arithmetic in u's dtype. t_now: [B]."""
    dE = model.to_physical(model.delta_all(sigma, aux)).to(u.dtype)
    log_tau = torch.clamp(beta * dE, min=0.0)
    return t_now[:, None] + (-torch.exp(log_tau) * torch.log1p(-u))


def redraw_table(model: Model):
    """[N, K + 1] int64 rows (i, the spins whose dE a flip of i changes),
    padded with the sentinel N, or None (every clock is redrawn)."""
    neigh = model.neighbor_table()
    if neigh is None:
        return None
    sites = torch.arange(model.N, device=neigh.device)[:, None]
    return torch.cat([sites, neigh.to(torch.int64)], dim=1)


def make_wtm_move(model: Model, beta: float, tmax: float):
    """The generic WTM move over a batch of chains.

    move(sigma, aux, E, accepted, t, times, u) advances, in place, every
    chain whose global time t [B] is below `tmax`: the spin i of the
    earliest clock in times [B, N + 1] (column N is the sink of the padding
    entries and is never read) fires at t = times[i] and flips; then the
    clocks of redraw_table's row i (the fired spin and its neighbour row,
    padding included) are redrawn from the uniforms u [B, K + 1] at the new
    time, or every clock from u [B, N] when the model has no table. Times
    take u's dtype. Returns i."""
    n = model.N
    table = redraw_table(model)

    def move(sigma, aux, E, accepted, t, times, u):
        active = t < tmax
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        i = torch.argmin(times[:, :n], dim=1)
        t_new = torch.where(active, times[rows, i], t)
        dE = model.delta_one(sigma, aux, i)
        model.flip(sigma, aux, i, active)
        E.add_(torch.where(active, dE, torch.zeros_like(dE)))
        if table is None:
            fresh = draw_times(u, model, sigma, aux, beta, t_new)
            times[:, :n] = torch.where(active[:, None], fresh, times[:, :n])
        else:
            idx = table[i]                             # [B, K + 1]
            dE_all = model.to_physical(model.delta_all(sigma, aux))
            dE_all = torch.cat([dE_all.to(times.dtype), dE_all.new_zeros(
                (dE_all.shape[0], 1), dtype=times.dtype)], dim=1)
            log_tau = torch.clamp(beta * dE_all.gather(1, idx), min=0.0)
            wt = -torch.exp(log_tau) * torch.log1p(-u)
            tgt = torch.where(active[:, None], idx, n)  # inactive: the sink
            times.scatter_(1, tgt, t_new[:, None] + wt)
        t.copy_(t_new)
        accepted.add_(active.to(torch.int32))
        return i

    return move


def _wtm_torch(model, beta, tmax, step_t, samples, state, chunk_moves,
               observer, hook):
    st = working_copy(state)
    dev = st.sigma.device
    B, n = st.sigma.shape
    dt = torch.float32
    t = torch.zeros(B, dtype=dt, device=dev)
    times = torch.empty((B, n + 1), dtype=dt, device=dev)
    times[:, n] = float("inf")
    u = torch.rand((B, n), generator=st.generator, device=dev, dtype=dt)
    times[:, :n] = draw_times(u, model, st.sigma, st.aux, beta, t)
    table = redraw_table(model)
    width = n if table is None else table.shape[1]
    move = make_wtm_move(model, beta, tmax)

    def advance():
        u = torch.rand((B, width), generator=st.generator, device=dev,
                       dtype=dt)
        move(st.sigma, st.aux, st.E, st.accepted, t, times, u)

    S = stream_mc(model, st, advance, t, tmax, step_t, samples, chunk_moves,
                  observer, hook, lambda x: float(x))
    set_route("torch")
    return S, st


@spanned("rrrmc.call.wtmMC")
def wtmMC(model: Model, beta: float, samples: int, *, step: float = 1.0,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          chunk_moves: int = 1024, hook=None, observer=None,
          state: Optional[MCState] = None, backend: str = "auto",
          device=None):
    """Waiting-time method; collects `samples` checkpoints spaced `step`
    (scaled by 1/N) in global time. Returns (Es [chains, samples], final
    MCState). hook(t, model, state) -> False stops early (once a chunk,
    with the chains' least global time); observer(model, sigma, aux, E)
    replaces the checkpoint energies with any per-chain observable. The
    routes are bklMC's: "kernel" (the race kernel), "torch" (the generic
    path, `make_wtm_move`), "auto" (the kernel where it takes the call)."""
    fam = kernel_route("wtmMC", model, backend=backend, hook=hook,
                       observer=observer)
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    step_t = float(step) / model.N
    tmax = step_t * samples
    if fam is not None:
        return rejfree_mc(model, fam, float(beta), "wtm", tmax, step_t,
                          state, samples, chunk_moves)
    return _wtm_torch(model, float(beta), tmax, step_t, samples, state,
                      chunk_moves, observer, hook)
