"""Shared sampler scaffolding: batched chain state, init, and the checkpoint
loop.

The reference advances ONE chain in a loop; here a batch of `chains`
independent chains advances in lockstep. Every per-move function takes the
whole batch, the time loop is a Python loop with a checkpoint emission every
`step` moves (the analog of the reference's `hook` / energy-series
mechanism). PyTorch runs eagerly: there is no jit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..core.model import Model, default_device, random_spins
from ..utils.profiling import spanned

#: arbitrary default seed, mirroring the reference's
DEFAULT_SEED = 167432777111 % (2 ** 31)

#: which execution path the LAST sampler call took: {"backend": "torch" |
#: "kernel-...", "impl": "cuda" | "plain", ...} plus kernel diagnostics
#: (acc / z_over_n tensors). experiments.runtest reports it.
LAST_ROUTE: dict = {}


def set_route(backend: str, **extra):
    LAST_ROUTE.clear()
    LAST_ROUTE["backend"] = backend
    LAST_ROUTE.update(extra)


@dataclasses.dataclass(frozen=True, eq=False)
class MCState:
    sigma: torch.Tensor      # [B, N] int8
    aux: Any                 # model aux, batched on axis 0
    E: torch.Tensor          # [B] internal units
    accepted: torch.Tensor   # [B] int32
    #: host-side draws (site choices, kernel seeds); advances in place, so a
    #: continuation run (state=) never replays an earlier segment's stream
    generator: torch.Generator
    #: the global id of chain 0: the kernels key chain b's Philox stream by
    #: chain0 + b, so a shard of a larger batch (parallel/mesh.py) draws
    #: what the same chains draw unsharded
    chain0: int = 0


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def init_state(model: Model, chains: int, seed: int = DEFAULT_SEED, C0=None,
               *, device=None) -> MCState:
    """Fresh state: random (or C0) spins, their aux and exact energies, on
    `device`: CUDA when none is given, as the builders, so a model built on
    the host needs device="cpu" here too."""
    device = default_device(device)
    gen = make_generator(seed, device)
    if C0 is None:
        sigma = random_spins(chains, model.N, generator=gen, device=device)
    else:
        sigma = torch.as_tensor(C0, dtype=torch.int8, device=device)
        if sigma.ndim == 1:
            sigma = sigma.expand(chains, model.N)
        if tuple(sigma.shape) != (chains, model.N):
            raise ValueError(f"invalid C0 shape {tuple(sigma.shape)}")
        sigma = sigma.contiguous()
    return MCState(sigma=sigma, aux=model.init_aux(sigma),
                   E=model.energy(sigma),
                   accepted=torch.zeros(chains, dtype=torch.int32,
                                        device=device),
                   generator=gen)


def rebind(model: Model, state: MCState) -> MCState:
    """Re-derive the aux cache and exact energies of `state.sigma` under a
    (re-parameterized) model, keeping spins, generator and counters: the
    annealing warm-start."""
    return dataclasses.replace(state, aux=model.init_aux(state.sigma),
                               E=model.energy(state.sigma))


def clone_aux(aux):
    """A copy of an aux state: a tensor, or a tuple of them (composites)."""
    if torch.is_tensor(aux):
        return aux.clone()
    if isinstance(aux, tuple):
        return tuple(clone_aux(a) for a in aux)
    return aux


def working_copy(state: MCState) -> MCState:
    """A copy whose tensors the samplers may update in place."""
    return dataclasses.replace(state, sigma=state.sigma.clone(),
                               aux=clone_aux(state.aux),
                               E=state.E.clone(),
                               accepted=state.accepted.clone())


def init_lfT(model: Model, sigma: torch.Tensor) -> torch.Tensor:
    """[N, B] site-major local fields for the site kernel: int32 for integer
    couplings (exact), float32 for float couplings."""
    return model.local_fields(sigma).t().contiguous()


@spanned("rrrmc.sync.kernel_seed")
def kernel_seed(generator: torch.Generator) -> int:
    """A 31-bit Philox seed drawn from the state's generator, so every
    sampler call (and every continuation) gets fresh kernel streams."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


#: entries of one `cached` store; the oldest is dropped beyond it
_CACHE_MAX = 8


def cached(store: dict, tensors: tuple, extra: tuple, build: Callable):
    """build(), cached in `store` under the identity of `tensors` (held in
    the entry, so their ids cannot be reused) and the hashable `extra`; the
    oldest entry is dropped beyond _CACHE_MAX. Lets repeated and
    checkpointed sampler calls reuse a runner's device tables."""
    key = tuple(id(t) for t in tensors) + tuple(extra)
    ent = store.get(key)
    if ent is None or any(a is not b for a, b in zip(ent[0], tensors)):
        if key not in store and len(store) >= _CACHE_MAX:
            store.pop(next(iter(store)))
        ent = (tensors, build())
        store[key] = ent
    return ent[1]


def physical_series(Es: list, B: int, device) -> torch.Tensor:
    """[B, K] from K checkpoints' [B] physical energies ([B, 0] for none)."""
    if not Es:
        return torch.zeros((B, 0), dtype=torch.float32, device=device)
    return torch.stack(Es, dim=1)


def default_observer(model: Model, sigma, aux, E):
    """Per-checkpoint observable: physical energy."""
    return model.to_physical(E)


def run_sweeps(model: Model, state: MCState, beta, make_step: Callable,
               n_checkpoints: int, moves_per_checkpoint: int,
               observer: Optional[Callable] = None):
    """Advance all chains; emit `observer` output every
    `moves_per_checkpoint` moves. make_step(model, beta) builds the batched
    move function step(state) that advances `state` in place. Returns
    (state, series [n_checkpoints, B, ...])."""
    obs_fn = observer or default_observer
    step = make_step(model, beta)
    series = []
    for _ in range(n_checkpoints):
        for _ in range(moves_per_checkpoint):
            step(state)
        # a copy: the observable may be the live state (the spins, or a
        # float E), which the next move updates in place
        series.append(obs_fn(model, state.sigma, state.aux, state.E).clone())
    if not series:
        o = obs_fn(model, state.sigma, state.aux, state.E)
        return state, o.new_zeros((0,) + tuple(o.shape))
    return state, torch.stack(series)


def series_to_chain_major(series: torch.Tensor) -> torch.Tensor:
    """[n_checkpoints, B, ...] -> [B, n_checkpoints, ...]."""
    return series.movedim(0, 1)


def run_with_hook(model: Model, state: MCState, beta, make_step,
                  n_checkpoints: int, moves_per_checkpoint: int,
                  observer, hook, hook_every: int):
    """Checkpoint loop with the reference's hook protocol:
    `hook(it, model, state)` is called on the host every `hook_every`
    checkpoints; returning False stops the run early (the series collected
    so far is returned)."""
    if hook is None or n_checkpoints == 0:
        return run_sweeps(model, state, beta, make_step, n_checkpoints,
                          moves_per_checkpoint, observer)
    parts = []
    done = 0
    while done < n_checkpoints:
        k = min(hook_every, n_checkpoints - done)
        state, series = run_sweeps(model, state, beta, make_step, k,
                                   moves_per_checkpoint, observer)
        parts.append(series)
        done += k
        if hook(done * moves_per_checkpoint, model, state) is False:
            break
    return state, torch.cat(parts, dim=0)
