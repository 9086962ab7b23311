"""bklMC: rejection-free Bortz-Kalos-Lebowitz, the race-kernel loop shared
by bklMC / wtmMC / rrrMC, and the generic torch path of bklMC and wtmMC.

Semantics follow the reference: each move draws a geometric number of
virtually-rejected iterations `skip` with success probability z/N, then an
always-accepted move proportional to w_i = min(1, e^{-beta dE_i}); the
iteration counter advances by skip+1, so results are directly comparable
with standardMC at equal `iters`.

Chains advance different numbers of virtual iterations per move, so
checkpoints cannot be emitted in lockstep. Each chunk of moves records a
per-chain (coordinate, observable) stream, and checkpoint values are filled
by a batched searchsorted over the stream: the batch generalization of the
reference's checkpoint drain loop.

Two routes. The race kernel of the model's family (samplers/families.py):
the sparse one (ops/rejfree.py) for Pairwise models (for bkl on integer
fields within int8 the class kernel of ops/rejfree_classes.py takes its
place), the dense one (ops/rejfree_dense.py) for FullyConnected models,
the hypergraph ones (ops/pspin.py, ops/sat.py) for PSpin3 and K-SAT, the
perceptrons' (ops/perc.py) and the replica composites' (ops/replica.py);
it records energies only. The generic torch path (`make_bkl_move`, a
batched step of plain tensor ops on [B, N]) runs any model, takes hooks
and observers, and is what backend="torch" asks for (the JAX package's
"xla").
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.model import Model
from ..ops.rejfree import coord_dtype
from ..ops.rejfree_classes import classes_ok
from ..utils.profiling import annotate, spanned
from .common import (DEFAULT_SEED, MCState, default_observer, init_state,
                     kernel_seed, set_route, working_copy)
from .families import (ELIGIBLE, Family, family_of, inexact_reason,
                       resident_state)
from .moves import acceptance_weights, categorical_from_weights, geometric_skip

#: iteration targets above this would overflow the kernels' int32
#: coordinates
MAX_ITERS = 10 ** 9

#: bytes of per-move coordinate and observable streams one chunk of the
#: generic path may hold: a snapshot observer's stream is [chunk, B, N]
#: (1.3 GB of int8 at 128 chains of 10^4 spins and 1024 moves), so its
#: chunks are cut to fit
STREAM_BYTES = 1 << 28


def kernel_route(sampler: str, model, *, backend: str, hook, observer,
                 iters=None) -> Optional[Family]:
    """The model's family where the call runs on its race kernel, None
    where it takes the generic torch path. backend "kernel" raises unless
    the model's family has a race kernel, the call has no hook or observer
    and `iters` fits the kernels' coordinates; "torch" forces the generic
    path; "auto" takes the kernel for an eligible model with no hook or
    observer, and the generic path otherwise. An eligible call that "auto"
    would run on the kernel raises, as "kernel" does, where `iters` does
    not fit: it is not moved to the far slower generic path. A model whose
    own delta_all and flip are inexact (`families.inexact_reason`) is
    refused on every route."""
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"{sampler}: unknown backend {backend!r}")
    why = inexact_reason(model)
    if why is not None:
        raise NotImplementedError(
            f"{sampler}: {type(model).__name__} is refused on every route; "
            f"the samplers take {why}")
    fam = family_of(model)
    eligible = fam is not None
    plain_call = hook is None and observer is None
    if backend == "kernel":
        if not plain_call:
            raise NotImplementedError(
                f"{sampler}(backend='kernel') takes no hook or observer: "
                f"the race kernels record energies only (backend 'auto' or "
                f"'torch' runs the generic path)")
        if not eligible:
            raise NotImplementedError(
                f"{sampler}: {type(model).__name__} is not eligible for the "
                f"race kernels ({ELIGIBLE})")
    elif backend == "torch" or not (eligible and plain_call):
        return None
    if iters is not None and iters > MAX_ITERS:
        raise ValueError(f"{sampler}: iters must be <= {MAX_ITERS} on the "
                         f"kernel route (backend 'torch' runs the generic "
                         f"path at any length)")
    return fam


def fill_checkpoints(S, step, x_start, o_start, xs, os_):
    """Fill the checkpoint series S [B, K, ...] (checkpoint coordinate
    ns_k = (k+1)*step) with the observable in effect just before the first
    move whose post-move coordinate reaches ns_k: a move whose coordinate
    passes several checkpoints gives each of them its pre-move value.
    xs [chunk, B]: per-move coordinate streams (non-decreasing per chain);
    os_ [chunk, B, ...]: the post-move observable stream; x_start [B] and
    o_start [B, ...]: the values at the chunk start."""
    B, n_ckpt = S.shape[:2]
    with annotate("rrrmc.sync.checkpoint_step"):    # a copy from the host
        step_t = torch.tensor(step, dtype=xs.dtype, device=xs.device)
    ns = (torch.arange(1, n_ckpt + 1, dtype=xs.dtype, device=xs.device)
          * step_t)
    xb = xs.t().contiguous()
    idx = torch.searchsorted(xb, ns.expand(B, n_ckpt).contiguous(),
                             right=False)        # moves strictly before ns
    rows = torch.arange(B, device=xs.device)[:, None]
    # the value after move idx - 1, or the chunk start's where idx == 0
    # (indexed in place: no copy of the stream)
    vals = os_[(idx - 1).clamp(min=0), rows]
    trail = (1,) * (S.ndim - 2)
    vals = torch.where((idx == 0).view(idx.shape + trail),
                       o_start[:, None], vals)
    newly = (ns[None, :] > x_start[:, None]) & (ns[None, :] <= xb[:, -1:])
    return torch.where(newly.view(newly.shape + trail), vals.to(S.dtype), S)


@spanned("rrrmc.sync.chunk_test")
def chains_below(coord, target) -> bool:
    """Whether some chain's coordinate is still below `target`: the chunk
    loops' test, a host sync."""
    return bool(coord.min() < target)


def rejfree_mc(model, fam: Family, beta: float, mode: str, target, step,
               state: MCState, n_ckpt: int, chunk_moves: int):
    """Run the race kernel in chunks of `chunk_moves` moves until every
    chain's coordinate reaches `target`; one host sync per chunk.
    Returns (Es [B, n_ckpt] physical energies, final MCState); `accepted`
    gains the applied flips, and LAST_ROUTE holds acc, the summed z/N and
    `pick`. The model's family `fam` (`kernel_route`'s) picks the kernel
    (samplers/families.py): bkl takes the family's class kernel where its
    rule holds (`classes_ok`: integer sparse Pairwise fields within int8),
    pick "classes", and the race otherwise, pick "race"."""
    B = state.sigma.shape[0]
    dev = state.sigma.device
    with annotate("rrrmc.prep.resident_state"):
        seed = kernel_seed(state.generator)
        sigma = state.sigma.clone()
        lf, E = resident_state(fam, model, sigma, state.E)
        ct = coord_dtype(mode)
        coord = torch.zeros(B, dtype=ct, device=dev)
        acc = torch.zeros(B, dtype=torch.int32, device=dev)
        zacc = torch.zeros(B, dtype=torch.float32, device=dev)
        Es = torch.zeros((B, n_ckpt), dtype=torch.float32, device=dev)
        tables = fam.tables(model)
        race_kw = fam.race_kw(model)
        race, pick = fam.race, "race"
        if fam.classes is not None and classes_ok(
                model, mode, race_kw.get("field_bound"), dev):
            race, pick = fam.classes, "classes"
    k = 0
    while chains_below(coord, target):
        with annotate("rrrmc.chunk"):
            if fam.resync is not None:
                fam.resync(model, lf, E)
            x_start = coord.clone()
            e_start = model.to_physical(E)
            cs, es = race(
                sigma, lf, E, coord, acc, zacc, *tables, mode=mode,
                n_moves=chunk_moves, beta_s=beta * model.scale,
                target=target, seed=seed, move0=k * chunk_moves,
                chain0=state.chain0, **race_kw)
            with annotate("rrrmc.post.fill_checkpoints"):
                Es = fill_checkpoints(Es, step, x_start, e_start, cs,
                                      model.to_physical(es))
        k += 1
    set_route(f"kernel-rejfree-{fam.name}",
              impl="cuda" if dev.type == "cuda" else "plain", mode=mode,
              acc=acc, z_over_n=zacc, chunks=k, pick=pick)
    with annotate("rrrmc.post.init_aux"):
        aux = model.init_aux(sigma)
    return Es, MCState(sigma=sigma, aux=aux, E=E,
                       accepted=state.accepted + acc,
                       generator=state.generator, chain0=state.chain0)


def make_bkl_move(model: Model, beta: float, iters: int):
    """The generic BKL move over a batch of chains.

    move(sigma, aux, E, accepted, it, u_skip, u_mv) advances, in place,
    every chain whose coordinate it [B] (int64) is below `iters`: dE of
    every site, the weights min(1, e^{-beta dE}), the site i drawn from
    them with the uniforms u_mv [B], the skip drawn with u_skip [B] at
    p = z/N, and the masked flip; E gains dE_i, it gains skip + 1. The
    weights' arithmetic runs in the uniforms' dtype. Returns (i, skip)."""
    n = model.N

    def move(sigma, aux, E, accepted, it, u_skip, u_mv):
        active = it < iters
        dE = model.delta_all(sigma, aux)
        w = acceptance_weights(model.to_physical(dE).to(u_mv.dtype), beta)
        i, z = categorical_from_weights(u_mv, w)
        skip = geometric_skip(u_skip, z / n)
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        dEi = dE[rows, i]
        model.flip(sigma, aux, i, active)
        E.add_(torch.where(active, dEi, torch.zeros_like(dEi)))
        it.add_(torch.where(active, skip + 1, torch.zeros_like(skip)))
        accepted.add_(active.to(torch.int32))
        return i, skip

    return move


def stream_mc(model, st: MCState, move, coord, target, step, n_ckpt: int,
              chunk_moves: int, observer, hook, hook_coord):
    """The generic path's chunk loop, shared by bklMC and wtmMC: run
    move() (which advances st and the coordinate tensor `coord` [B] in
    place) in chunks until every chain's coordinate reaches `target`,
    recording per-move coordinate and observable streams and filling the
    checkpoint series from them (`fill_checkpoints`); one host sync per
    chunk. A chunk holds at most STREAM_BYTES of streams. hook(x, model,
    st), x = hook_coord(least coordinate), is called once a chunk;
    returning False stops the run. Returns the series [B, n_ckpt, ...]."""
    obs = observer or default_observer
    o0 = obs(model, st.sigma, st.aux, st.E)
    B = o0.shape[0]
    S = o0.new_zeros((B, n_ckpt) + tuple(o0.shape[1:]))
    per_move = (o0.numel() * o0.element_size()
                + coord.numel() * coord.element_size())
    chunk = max(1, min(chunk_moves, STREAM_BYTES // per_move))
    xs = coord.new_empty((chunk,) + tuple(coord.shape))
    os_ = o0.new_empty((chunk,) + tuple(o0.shape))
    while chains_below(coord, target):
        x_start = coord.clone()
        o_start = obs(model, st.sigma, st.aux, st.E).clone()
        for m in range(chunk):
            move()
            xs[m] = coord
            os_[m] = obs(model, st.sigma, st.aux, st.E)
        S = fill_checkpoints(S, step, x_start, o_start, xs, os_)
        if hook is not None and hook(hook_coord(coord.min()), model,
                                     st) is False:
            break
    return S


def _bkl_torch(model, beta, iters, step, state, chunk_moves, observer,
               hook):
    st = working_copy(state)
    dev = st.sigma.device
    B = st.sigma.shape[0]
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    move = make_bkl_move(model, beta, iters)

    def advance():
        u_skip = torch.rand(B, generator=st.generator, device=dev)
        u_mv = torch.rand(B, generator=st.generator, device=dev)
        move(st.sigma, st.aux, st.E, st.accepted, it, u_skip, u_mv)

    S = stream_mc(model, st, advance, it, iters, step, iters // step,
                  chunk_moves, observer, hook, lambda x: int(x))
    set_route("torch")
    return S, st


@spanned("rrrmc.call.bklMC")
def bklMC(model: Model, beta: float, iters: int, *, step: int = 1,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          chunk_moves: int = 1024, hook=None, observer=None,
          state: Optional[MCState] = None, backend: str = "auto",
          device=None):
    """Rejection-free BKL; `iters` counts virtual (rejected-inclusive)
    iterations. Returns (Es [chains, iters // step], final MCState).

    hook(it, model, state) -> False stops early (called once a chunk, with
    the chains' least coordinate). observer(model, sigma, aux, E) replaces
    the checkpoint energies with any per-chain observable ([B, ...]; the
    series is then [chains, iters // step, ...]), each checkpoint taking
    the value in effect at its coordinate exactly as energies do.

    backend "kernel": the race kernel of the model's family (families.py:
    the CUDA kernel for a CUDA state, its plain version on the CPU),
    `chunk_moves` moves a launch, raising for a hook, an observer, an
    ineligible model or iters > MAX_ITERS; "torch": the generic path
    (`make_bkl_move`) on any model; "auto": the kernel for an eligible
    model with no hook or observer (raising for iters > MAX_ITERS as
    "kernel" does), else the generic path."""
    fam = kernel_route("bklMC", model, backend=backend, hook=hook,
                       observer=observer, iters=iters)
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    if fam is not None:
        return rejfree_mc(model, fam, float(beta), "bkl", int(iters),
                          int(step), state, iters // step, chunk_moves)
    return _bkl_torch(model, float(beta), int(iters), int(step), state,
                      chunk_moves, observer, hook)
