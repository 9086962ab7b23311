"""Replica exchange (the JAX package's rrrmc_tpu/parallel/tempering.py):
parallel tempering over a beta ladder, and the generalized exchange over a
ladder of (model, beta) ensembles.

Parallel tempering. Configurations never move: each (slot, chain) holds a
ladder `rank`, and a swap exchanges ranks, not spins, so a swap round moves
O(T B) scalars (across processes one packed all_gather), never the T B N
spins. Pair (r, r + 1) swaps with probability min(1, exp((beta_{r+1} -
beta_r) (E_{r+1} - E_r))), even pairs on even rounds and odd pairs on odd
ones (`swap_ranks`, the JAX package's `_swap_ranks`).

A round on a sparse Pairwise model with N >= 8 is ONE launch of the site
kernel (ops/site.py) over the ladder's T B chains: sweeps_per_round N moves
on the permutation schedule (every sweep attempts each site once), chain
(t, b) at beta[rank[t, b]] * scale, read by the kernel chain by chain. The
state stays in the kernel's site-major [N, T B] layout for the whole call;
the CUDA kernel runs for a CUDA state, its plain version on the CPU. A
Pairwise model with N < 8 takes the colour-mask sweep in plain torch
(samplers/sweep.py's route (c)), each chain at its rank's beta, its
uniforms from the ladder's generator; such a ladder runs unsharded.

Draws. A PTState carries one generator, seeded seed ^ 0x5EED, the kernel
seed drawn from it at the first round (and again before the kernel's move
counter would pass 2^32), the move counter and the rounds run; each round
draws the swap uniforms u of the whole [T, B] ladder. So a run continued
from its state (a checkpoint's included) equals the same rounds run in one
call. Chain (t, b) draws its moves under key (seed, t B + b). A
shard of the T axis, of the chain axis, or of both (`mesh`) copies the
generator and takes its rows and columns of u, and its chains keep their
global ids (a launch covers a run of consecutive ids: the whole shard when
it holds every chain of its rungs, else one launch a rung), so any
sharding gives exactly the unsharded run. (The JAX package instead folds
the chain shard's index into the swap key, so its runs differ by
sharding.) Shards of one process run one after another; across processes
(`parallel/distributed.py`) each round gathers one packed [2 Tl, B] tensor
of energies and ranks (`torch.distributed.all_gather`).

The generalized exchange (`tempered_ensembles`) pins each slot to its
Hamiltonian and swaps configurations with the cross-energy rule

    ln A(r, r+1) = -beta_r     [H_r(x_{r+1})     - H_r(x_r)]
                   -beta_{r+1} [H_{r+1}(x_r)     - H_{r+1}(x_{r+1})]

which reduces to the beta-ladder rule for identical models. Each slot runs
a move kernel between swaps: the port's standardMC route for the slot's
model by default, `sweep_kernel` (one site-kernel launch of whole sweeps at
the slot's beta) for Pairwise ladders.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.dtypes import ftype
from ..core.model import default_device
from ..models.pairwise import Pairwise
from ..ops.site import SiteSampler
from ..samplers.common import (DEFAULT_SEED, LAST_ROUTE, MCState, cached,
                               init_state, kernel_seed, make_generator,
                               set_route)
from ..samplers.sweep import _run_color_masks, _run_site_sweep, color_masks
from .mesh import Mesh, copy_generator

#: the swap generators' seeds: seed ^ PT_SALT (parallel tempering) and
#: seed ^ ET_SALT (ensemble exchange), the JAX package's key salts
PT_SALT, ET_SALT = 0x5EED, 0x7E3B
#: the kernels' move counter is 32 bits: a call draws a fresh kernel seed
#: before a round would pass it
MOVE_LIMIT = 1 << 32


@dataclasses.dataclass(frozen=True, eq=False)
class PTState:
    sigma: torch.Tensor      # [T, B, N] int8, by slot
    aux: Any                 # [T, B, N] local fields, by slot
    E: torch.Tensor          # [T, B] internal units
    rank: torch.Tensor       # [T, B] int32: ladder rank held by (slot, chain)
    swap_acc: torch.Tensor   # [T, B] int32 accepted swap count
    #: kernel seeds and swap uniforms; seeded seed ^ PT_SALT
    generator: torch.Generator
    #: the kernels' seed (-1: none drawn yet) and next move counter, and
    #: the rounds run: a run continued from its state (state=) equals the
    #: same rounds run in one call
    kernel_seed: int = -1
    move0: int = 0
    rounds: int = 0


def _check_model(model):
    if not isinstance(model, Pairwise):
        raise TypeError(f"parallel_tempering needs a Pairwise model (the "
                        f"JAX package's), got {type(model).__name__}; "
                        f"flatten() a wrapper stack, or use "
                        f"tempered_ensembles")


def init_pt_state(model, betas, chains: int, seed: int = DEFAULT_SEED, *,
                  device=None) -> PTState:
    """Slot t's chains from init_state(model, chains, seed + 7919 t), every
    (slot, chain) at rank t, on `device` (CUDA when none is given)."""
    _check_model(model)
    device = default_device(device)
    T = len(betas)
    states = [init_state(model, chains, seed + 7919 * t, device=device)
              for t in range(T)]
    rank = torch.arange(T, dtype=torch.int32, device=device)[:, None]
    return PTState(sigma=torch.stack([s.sigma for s in states]),
                   aux=torch.stack([s.aux for s in states]),
                   E=torch.stack([s.E for s in states]),
                   rank=rank.expand(T, chains).contiguous(),
                   swap_acc=torch.zeros((T, chains), dtype=torch.int32,
                                        device=device),
                   generator=make_generator(seed ^ PT_SALT, device))


def swap_ranks(E_phys, rank, betas, u, parity: int):
    """One swap round over the whole ladder (the JAX package's
    `_swap_ranks` without its gather): E_phys [T, B] physical energies by
    slot, rank [T, B] int32, betas [T], u [T, B] uniforms (row r decides
    pair (r, r + 1)); pair (r, r + 1) with r % 2 == parity swaps where
    u < exp(min((beta_{r+1} - beta_r)(E_{r+1} - E_r), 0)), energies taken
    by rank. Returns (new rank [T, B], moved [T, B] bool)."""
    T, B = E_phys.shape
    by_rank = torch.zeros_like(E_phys).scatter_(0, rank.long(), E_phys)
    betas = torch.as_tensor(betas, device=E_phys.device).to(E_phys.dtype)
    zero_b = betas.new_zeros(1)
    dbeta = torch.cat([betas[1:] - betas[:-1], zero_b])
    dE = torch.cat([by_rank[1:] - by_rank[:-1], by_rank.new_zeros(1, B)])
    r = torch.arange(T, device=E_phys.device)
    lead = ((r % 2) == parity) & (r < T - 1)
    acc_pair = (u < torch.exp(torch.clamp(dbeta[:, None] * dE, max=0.0))) \
        & lead[:, None]
    rl = rank.long()
    up = acc_pair.gather(0, rl)
    down = acc_pair.gather(0, (rl - 1).clamp(min=0)) & (rl > 0)
    new = rank + up.to(torch.int32) - down.to(torch.int32)
    return new, up | down


def energies_by_rank(Es, ranks):
    """[rounds, T, B] slot-ordered -> rank-ordered (temperature series)."""
    Es = torch.as_tensor(Es)
    ranks = torch.as_tensor(ranks, device=Es.device)
    return torch.empty_like(Es).scatter_(1, ranks.long(), Es)


# ---- parallel tempering's shards ----

@dataclasses.dataclass
class _Group:
    """Local rungs [lo, hi) of a shard whose chains hold consecutive
    global ids from chain0: one launch. Site route: sig and lf are the
    kernel's site-major [N, n] state; mask route: chain-major [n, N]."""
    lo: int
    hi: int
    chain0: int
    sig: torch.Tensor
    lf: torch.Tensor
    E: torch.Tensor
    acc: torch.Tensor


@dataclasses.dataclass
class _Shard:
    """Rungs [t0, t0 + Tl) and chains [b0, b0 + Bl) of the ladder."""
    pos: tuple
    t0: int
    b0: int
    device: torch.device
    groups: list
    rank: torch.Tensor       # [Tl, Bl]
    swap_acc: torch.Tensor   # [Tl, Bl]
    generator: torch.Generator


def _shard(st: PTState, pos, t0, b0, B, site: bool) -> _Shard:
    """A shard of the state block `st` ([Tl, Bl, ...] tensors on their
    device) at rungs t0 and chains b0 of a ladder of B chains."""
    Tl, Bl, N = st.sigma.shape
    spans = ([(0, Tl, t0 * B)] if Bl == B else
             [(t, t + 1, (t0 + t) * B + b0) for t in range(Tl)])
    groups = []
    for lo, hi, c0 in spans:
        n = (hi - lo) * Bl
        sig = st.sigma[lo:hi].reshape(n, N)
        lf = st.aux[lo:hi].reshape(n, N)
        if site:
            sig, lf = sig.t(), lf.t()
        groups.append(_Group(lo, hi, c0, sig.contiguous(), lf.contiguous(),
                             st.E[lo:hi].reshape(n).clone(),
                             torch.zeros(n, dtype=torch.int32,
                                         device=sig.device)))
    return _Shard(pos, t0, b0, st.sigma.device, groups, st.rank.clone(),
                  st.swap_acc.clone(), st.generator)


def _block(st: PTState, t0, Tl, b0, Bl, device) -> PTState:
    """Rungs [t0, t0 + Tl) and chains [b0, b0 + Bl) of `st` on `device`,
    with a copy of its generator."""
    def cut(x):
        return x[t0:t0 + Tl, b0:b0 + Bl].to(device)
    return dataclasses.replace(
        st, sigma=cut(st.sigma), aux=cut(st.aux), E=cut(st.E),
        rank=cut(st.rank), swap_acc=cut(st.swap_acc),
        generator=copy_generator(st.generator, device))


def _shard_state(sh: _Shard, site: bool) -> PTState:
    """The shard's state as [Tl, Bl, ...] tensors."""
    Bl = sh.rank.shape[1]

    def rows(x):
        x = x.t() if site else x
        return x.reshape(-1, Bl, x.shape[-1])
    return PTState(
        sigma=torch.cat([rows(g.sig) for g in sh.groups]),
        aux=torch.cat([rows(g.lf) for g in sh.groups]),
        E=torch.cat([g.E.view(-1, Bl) for g in sh.groups]),
        rank=sh.rank, swap_acc=sh.swap_acc, generator=sh.generator)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """How a ladder of T x B chains is cut: blocks of Tl x Bl, the block
    of mesh position p at rungs index(p, axis) Tl and chains
    index(p, chain_axis) Bl (no mesh: one block)."""
    mesh: Optional[Mesh]
    axis: Optional[str]
    chain_axis: Optional[str]
    T: int
    B: int
    Tl: int
    Bl: int

    def origin(self, pos) -> tuple:
        if self.mesh is None:
            return 0, 0
        return (self.mesh.index(pos, self.axis) * self.Tl,
                self.mesh.index(pos, self.chain_axis) * self.Bl)


def _gather(shards: list, lay: _Layout, E_loc: list):
    """The whole ladder's physical energies and ranks, each [T, B], on the
    first shard's device: the shards' blocks, and across processes one
    packed all_gather of each rank's [n_local, 2 Tl, Bl] blocks."""
    dev = shards[0].device
    packed = [torch.cat([E, sh.rank.to(E.dtype)]) for sh, E in
              zip(shards, E_loc)]
    blocks = {sh.pos: p for sh, p in zip(shards, packed)}
    mesh = lay.mesh
    if mesh is not None and not mesh.is_local():
        import torch.distributed as dist

        mine = torch.stack(packed)
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        for r, part in enumerate(parts):
            pos = [p for p in mesh.positions() if int(mesh.ranks[p]) == r]
            for i, p in enumerate(pos):
                blocks[p] = part[i]
    T, Tl, Bl = lay.T, lay.Tl, lay.Bl
    full = torch.empty((2 * T, lay.B), dtype=packed[0].dtype, device=dev)
    for p, blk in blocks.items():
        t0, b0 = lay.origin(p)
        full[t0:t0 + Tl, b0:b0 + Bl] = blk[:Tl].to(dev)
        full[T + t0:T + t0 + Tl, b0:b0 + Bl] = blk[Tl:].to(dev)
    return full[:T], full[T:].to(torch.int32)


def _assemble(blocks: dict, lay: _Layout, t_dim: int, device):
    """The shards' blocks (rungs at dim t_dim, chains at t_dim + 1) joined
    into the process's part: the whole ladder when every position is
    local, else the one local block."""
    if len(blocks) == 1:
        return next(iter(blocks.values()))
    first = next(iter(blocks.values()))
    shape = list(first.shape)
    shape[t_dim], shape[t_dim + 1] = lay.T, lay.B
    out = torch.empty(shape, dtype=first.dtype, device=device)
    for p, blk in blocks.items():
        t0, b0 = lay.origin(p)
        idx = [slice(None)] * len(shape)
        idx[t_dim] = slice(t0, t0 + lay.Tl)
        idx[t_dim + 1] = slice(b0, b0 + lay.Bl)
        out[tuple(idx)] = blk.to(device)
    return out


def parallel_tempering(model: Pairwise, betas, n_rounds: int, *,
                       sweeps_per_round: int = 1, chains: int = 1,
                       seed: int = DEFAULT_SEED,
                       mesh: Optional[Mesh] = None, axis: str = "temp",
                       chain_axis: Optional[str] = None,
                       state: Optional[PTState] = None, device=None):
    """Replica-exchange sampling over the beta ladder.

    Returns (Es [n_rounds, T, B] physical energies by slot, ranks
    [n_rounds, T, B] ladder rank per slot after each round, final
    PTState); sort E by rank (`energies_by_rank`) for per-temperature
    series. `state=` continues a run exactly as one longer call would
    (the JAX package restarts its swap keys and parity); the state's
    generator advances in place. With `mesh` the T axis is sharded over
    mesh axis `axis` (T must divide) and, with `chain_axis`, the chains
    over that axis; each shard runs on its position's device (N >= 8
    only). A mesh whose positions are all this process's gives the whole
    ladder; a `distributed` mesh gives this rank's block
    (distributed.fetch_global joins it: dim=1 for Es and ranks, dim=0 for
    the state's tensors). LAST_ROUTE:
    "kernel-site-tempering" (impl "cuda" or "plain") or "torch" (the
    colour masks), with the call's site-kernel launches."""
    from ..ops.launch import LAUNCHES

    _check_model(model)
    betas_np = np.asarray([float(b) for b in np.asarray(betas).ravel()])
    T, N = len(betas_np), model.N
    site = N >= 8
    if mesh is not None:
        others = [a for a in mesh.axis_names if a not in (axis, chain_axis)
                  and mesh.shape[a] > 1]
        if others:
            raise ValueError(f"mesh axes {others} are neither the "
                             f"temperature nor the chain axis")
        local = mesh.local_positions()
    else:
        local = [()]
    nT = 1 if mesh is None else mesh.size(axis)
    nB = 1 if mesh is None else mesh.size(chain_axis)
    if T % nT or chains % nB:
        raise ValueError(f"T={T} and chains={chains} must split into "
                         f"{nT} x {nB} shards")
    if not site and nT * nB > 1:
        raise ValueError(f"parallel_tempering: N={N} < 8 takes the "
                         f"colour-mask sweep, whose uniforms come from the "
                         f"ladder's generator; it runs unsharded")
    lay = _Layout(mesh, axis, chain_axis, T, chains, T // nT, chains // nB)
    Tl, Bl = lay.Tl, lay.Bl
    if mesh is not None:
        dev0 = torch.device(mesh.devices[local[0]])
    else:
        dev0 = (default_device(device) if state is None
                else state.sigma.device)
    if state is None:
        state = init_pt_state(model, betas_np, chains, seed, device=dev0)
    whole = tuple(state.E.shape) == (T, chains)
    if not whole and (tuple(state.E.shape) != (Tl, Bl) or len(local) != 1):
        raise ValueError(f"state of shape {tuple(state.E.shape)} for a "
                         f"ladder of {T} x {chains} cut into {Tl} x {Bl}")
    models, shards = [], []
    for p in local:
        t0, b0 = lay.origin(p)
        dev = dev0 if mesh is None else torch.device(mesh.devices[p])
        blk = (state if not whole or (Tl, Bl) == (T, chains)
               else _block(state, t0, Tl, b0, Bl, dev))
        m = model if mesh is None else _on(model, dev)
        models.append(m)
        shards.append(_shard(blk, p, t0, b0, chains, site))

    # beta * scale in float64, then float32: a chain's threshold is that of
    # a one-beta launch at its rung
    betas_s = {sh.device: torch.tensor(betas_np * float(model.scale),
                                       dtype=torch.float32, device=sh.device)
               for sh in shards}
    betas_f = {sh.device: torch.tensor(betas_np, dtype=ftype(),
                                       device=sh.device) for sh in shards}
    runners = [SiteSampler(m, 1.0) if site else _cached_masks(m)
               for m in models]
    launches0 = LAUNCHES["site"]
    moves = sweeps_per_round * N
    seed, move0 = state.kernel_seed, state.move0
    Es = [[] for _ in shards]
    ranks = [[] for _ in shards]
    for r in range(n_rounds):
        if seed < 0 or move0 + moves > MOVE_LIMIT:
            seed = [kernel_seed(sh.generator) for sh in shards][0]
            move0 = 0
        E_loc = []
        for m, sh, run in zip(models, shards, runners):
            for g in sh.groups:
                rk = sh.rank[g.lo:g.hi].long().reshape(-1)
                if site:
                    run(g.sig, g.lf, g.E, g.acc, generator=sh.generator,
                        seed=seed, n_moves=moves, move0=move0,
                        chain0=g.chain0, sweep_schedule=True,
                        beta_s=betas_s[sh.device][rk])
                else:
                    out = _run_color_masks(m, betas_f[sh.device][rk], 1,
                                           sweeps_per_round, MCState(
                                               g.sig, g.lf, g.E, g.acc,
                                               sh.generator, g.chain0),
                                           masks=run)[1]
                    g.sig, g.lf, g.E = out.sigma, out.aux, out.E
            E = torch.cat([g.E for g in sh.groups]).view(Tl, Bl)
            E_loc.append(m.to_physical(E))
        us = [torch.rand((T, chains), generator=sh.generator,
                         device=sh.device, dtype=ftype()) for sh in shards]
        E_all, rank_all = _gather(shards, lay, E_loc)
        for k, (sh, u) in enumerate(zip(shards, us)):
            cols = slice(sh.b0, sh.b0 + Bl)
            new, moved = swap_ranks(E_all[:, cols].to(sh.device),
                                    rank_all[:, cols].to(sh.device),
                                    betas_f[sh.device], u[:, cols],
                                    (state.rounds + r) % 2)
            rows = slice(sh.t0, sh.t0 + Tl)
            sh.rank = new[rows].contiguous()
            sh.swap_acc = sh.swap_acc + moved[rows].to(torch.int32)
            Es[k].append(E_loc[k])
            ranks[k].append(sh.rank)
        move0 += moves

    dev_out = shards[0].device

    def series(lists, dtype):
        return _assemble({sh.pos: torch.stack(x) if x else torch.zeros(
            (0, Tl, Bl), dtype=dtype, device=sh.device)
            for sh, x in zip(shards, lists)}, lay, 1, dev_out)

    states = {sh.pos: _shard_state(sh, site) for sh in shards}

    def join(name):
        return _assemble({p: getattr(s, name) for p, s in states.items()},
                         lay, 0, dev_out)
    out = PTState(sigma=join("sigma"), aux=join("aux"), E=join("E"),
                  rank=join("rank"), swap_acc=join("swap_acc"),
                  generator=shards[0].generator, kernel_seed=seed,
                  move0=move0, rounds=state.rounds + n_rounds)
    impl = ("torch" if not site else
            "cuda" if dev_out.type == "cuda" else "plain")
    set_route("kernel-site-tempering" if site else "torch", impl=impl,
              launches=LAUNCHES["site"] - launches0, rounds=n_rounds,
              shards=len(shards))
    return series(Es, ftype()), series(ranks, torch.int32), out


def _on(model, device):
    from .mesh import to_device

    return to_device(model, device)


# ---- the generalized ensemble exchange ----

@dataclasses.dataclass(frozen=True, eq=False)
class ETState:
    slots: tuple             # T MCStates (each slot's chain batch, [B, ...])
    walker: torch.Tensor     # [T, B] int32: walker id held by the slot
    swap_acc: torch.Tensor   # [T, B] int32 accepted swaps
    #: the swap uniforms; seeded seed ^ ET_SALT
    generator: torch.Generator
    #: rounds run: round i of a continued run swaps the pairs of parity
    #: (rounds + i) % 2, as one longer call would
    rounds: int = 0


#: colourings of Pairwise slot models, keyed on the identity of J
_MASKS: dict = {}


def _cached_masks(model) -> torch.Tensor:
    return cached(_MASKS, (model.J,), (), lambda: (
        model.sweep_masks() if hasattr(model, "sweep_masks")
        else color_masks(model)))


def _sweep_prepare(model):
    """sweep_kernel's per-slot preparation, once a call: the site sampler
    (its bound on |lf| read once) for N >= 8, else the colour masks."""
    if not isinstance(model, Pairwise):
        raise TypeError("sweep_kernel needs Pairwise slots; rt.flatten() "
                        "wrapper stacks first")
    return SiteSampler(model, 1.0) if model.N >= 8 else _cached_masks(model)


def sweep_kernel(model, beta, n_moves: int, st: MCState,
                 prep=None) -> MCState:
    """Throughput move kernel for `tempered_ensembles`: whole sweeps of N
    attempted flips (n_moves rounded up to them) on a Pairwise slot. For
    N >= 8 one launch of the site kernel (the CUDA kernel for a CUDA
    state, its plain version on the CPU) at the slot's beta on the
    permutation schedule, as sweepMC's site-sweep route, `accepted`
    gaining the applied flips; below, the colour-mask sweep in plain torch.
    `prep` is `sweep_kernel.prepare(model)`, which tempered_ensembles
    calls once a slot."""
    if prep is None:
        prep = _sweep_prepare(model)
    sweeps = max(1, -(-int(n_moves) // model.N))
    if not isinstance(prep, SiteSampler):
        return _run_color_masks(model, float(beta), 1, sweeps, st,
                                masks=prep)[1]
    return _run_site_sweep(model, float(beta), 1, sweeps, st,
                           sampler=prep)[1]


#: tempered_ensembles calls it on each slot's model once a call and passes
#: the result as the kernel's fifth argument
sweep_kernel.prepare = _sweep_prepare


def metropolis_moves(model, beta, n_moves: int, st: MCState) -> MCState:
    """The default slot kernel: n_moves Metropolis moves of the port's
    standardMC route for the model (the site kernel for a Pairwise model,
    the torch route otherwise)."""
    from ..samplers.metropolis import standardMC

    return standardMC(model, float(beta), int(n_moves), step=int(n_moves),
                      state=st, backend="auto")[1]


def ensemble_swap(models, betas, slots, u, parity: int):
    """One configuration swap round over slot-pinned ensembles (the swap
    of the JAX package's `_ensemble_round`): pair (r, r + 1) with
    r % 2 == parity swaps where u[r] < exp(min(ln A, 0)), ln A the
    cross-energy rule of the module docstring in float64. u: [max(T-1, 1),
    B] uniforms. A swapped chain takes its partner's spins and the energy
    of them under its own slot's model; a slot where some chain swapped
    re-derives its aux. Returns (new slots, acc [max(T-1, 1), B] bool,
    E_phys [T, B] float32 of the slots before the swap)."""
    T = len(models)
    B = slots[0].sigma.shape[0]
    dev = slots[0].sigma.device
    E_phys = [m.to_physical(st.E).to(ftype()) for m, st in
              zip(models, slots)]
    acc = torch.zeros((max(T - 1, 1), B), dtype=torch.bool, device=dev)
    e_up, e_dn = {}, {}
    for r in range(T - 1):
        if r % 2 != parity:
            continue
        e_up[r] = models[r].energy(slots[r + 1].sigma)    # H_r(x_{r+1})
        e_dn[r] = models[r + 1].energy(slots[r].sigma)    # H_{r+1}(x_r)
        ln_a = (-float(betas[r]) * (
            models[r].to_physical(e_up[r]).double() - E_phys[r].double())
            - float(betas[r + 1]) * (
            models[r + 1].to_physical(e_dn[r]).double()
            - E_phys[r + 1].double()))
        acc[r] = u[r].to(dev) < torch.exp(ln_a.clamp(max=0.0))
    swapped = [torch.zeros(B, dtype=torch.bool, device=dev)
               for _ in range(T)]
    for r in e_up:
        swapped[r] = swapped[r] | acc[r]
        swapped[r + 1] = swapped[r + 1] | acc[r]
    any_swap = torch.stack(swapped).any(1).tolist()   # one host sync
    new = []
    for r, st in enumerate(slots):
        sigma, E = st.sigma, st.E
        if r in e_up:
            sigma = torch.where(acc[r][:, None], slots[r + 1].sigma, sigma)
            E = torch.where(acc[r], e_up[r], E)
        if r - 1 in e_up:
            sigma = torch.where(acc[r - 1][:, None], slots[r - 1].sigma,
                                sigma)
            E = torch.where(acc[r - 1], e_dn[r - 1], E)
        aux = models[r].init_aux(sigma) if any_swap[r] else st.aux
        new.append(dataclasses.replace(st, sigma=sigma, aux=aux, E=E))
    return tuple(new), acc, torch.stack(E_phys)


def exchange(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Rows of x [T, B] exchanged between slots r and r + 1 where acc[r]
    (the walkers' move under `ensemble_swap`)."""
    T = x.shape[0]
    out = x.clone()
    for r in range(T - 1):
        out[r] = torch.where(acc[r], x[r + 1], out[r])
        out[r + 1] = torch.where(acc[r], x[r], out[r + 1])
    return out


def swap_counts(acc: torch.Tensor, T: int) -> torch.Tensor:
    """[T, B] int32: 1 for each slot of a swapped pair."""
    moved = torch.zeros((T,) + tuple(acc.shape[1:]), dtype=torch.int32,
                        device=acc.device)
    for r in range(T - 1):
        moved[r] += acc[r].to(torch.int32)
        moved[r + 1] += acc[r].to(torch.int32)
    return moved


def tempered_ensembles(models, betas, n_rounds: int, *,
                       moves_per_round: Optional[int] = None,
                       chains: int = 1, seed: int = DEFAULT_SEED,
                       kernel: Optional[Callable] = None,
                       state: Optional[ETState] = None, device=None):
    """Replica exchange over a ladder of (model_r, beta_r) ensembles.

    models: T models on the same N (a re-parameterized family sharing one
    base, e.g. GraphQuant(Nk, M, g, beta, base) over Gammas, or T
    references to one model for a beta ladder). betas: [T] inverse
    temperatures (all equal for a coupling ladder). moves_per_round: the
    kernel's moves a slot between swaps (default N). kernel(model, beta,
    n_moves, MCState) -> MCState is the slot kernel (default
    `metropolis_moves`; `sweep_kernel` for Pairwise ladders); where it has
    a `.prepare(model)`, that is called once a slot and its result passed
    as a fifth argument. Slot t starts from init_state(models[t], chains,
    seed + 7919 t); the swap uniforms come from ETState.generator, seeded
    seed ^ 0x7E3B, so a run continued by `state=` equals the same rounds
    in one call.

    Returns (Es [n_rounds, T, B] physical energies by slot (slots are the
    rungs), walkers [n_rounds, T, B] after each swap round, final
    ETState)."""
    models = list(models)
    T = len(models)
    if T < 2:
        raise ValueError("tempered_ensembles needs at least 2 ensembles")
    N = models[0].N
    if any(m.N != N for m in models):
        raise ValueError("ladder models must share N")
    betas_f = [float(b) for b in np.asarray(betas).ravel()]
    if len(betas_f) != T:
        raise ValueError(f"{len(betas_f)} betas for {T} models")
    n_moves = int(moves_per_round) if moves_per_round else N
    if state is None:
        device = default_device(device)
        slots = tuple(init_state(m, chains, seed + 7919 * t, device=device)
                      for t, m in enumerate(models))
        walker = torch.arange(T, dtype=torch.int32,
                              device=device)[:, None].expand(T, chains)
        state = ETState(slots=slots, walker=walker.contiguous(),
                        swap_acc=torch.zeros((T, chains), dtype=torch.int32,
                                             device=device),
                        generator=make_generator(seed ^ ET_SALT, device))
    kernel = kernel or metropolis_moves
    prepare = getattr(kernel, "prepare", None)
    preps = [prepare(m) for m in models] if prepare else None
    B = state.walker.shape[1]
    dev = state.walker.device
    slots, walker, swap_acc = state.slots, state.walker, state.swap_acc
    Es, walkers = [], []
    for i in range(n_rounds):
        slots = tuple(
            kernel(m, b, n_moves, st) if preps is None else
            kernel(m, b, n_moves, st, preps[t])
            for t, (m, b, st) in enumerate(zip(models, betas_f, slots)))
        u = torch.rand((max(T - 1, 1), B), generator=state.generator,
                       device=dev, dtype=ftype())
        slots, acc, E_phys = ensemble_swap(models, betas_f, slots, u,
                                           (state.rounds + i) % 2)
        walker = exchange(walker, acc)
        swap_acc = swap_acc + swap_counts(acc, T)
        Es.append(E_phys)
        walkers.append(walker)
    empty = torch.zeros((0, T, B), device=dev)
    out = ETState(slots=slots, walker=walker, swap_acc=swap_acc,
                  generator=state.generator,
                  rounds=state.rounds + n_rounds)
    LAST_ROUTE["ensembles"] = T
    return (torch.stack(Es) if Es else empty,
            torch.stack(walkers) if walkers else empty.to(torch.int32), out)
