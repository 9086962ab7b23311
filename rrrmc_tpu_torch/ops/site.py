"""Single-site Metropolis on sparse Pairwise models: the CUDA kernel
(csrc/site.cu), its launch plan, its plain torch version, and the
`SiteSampler` runner.

Source note. The kernel replaces rrrmc_tpu/ops/site_pallas.py::_site_kernel
(called by `_pallas_site`). On the H100 it is bound by latency, not by bytes
or operations: a move is a chain of dependent steps (the site, its spin and
field, exp and Philox, the K neighbour fields). The design takes them off
the card's memory and runs many of them side by side. `site_plan` picks the
route by size alone: where a chain's state fits in shared memory
("resident"), a block of W chains keeps its spins and its fields, in the
narrowest type that holds the model's bound on |lf| (`field_type`), resident
for the whole launch, one warp per chain. The schedule, shared by the batch,
is cut once a launch into groups of at most GROUP_MAX consecutive moves
whose closed neighbourhoods are pairwise disjoint (`site_groups`); such
moves commute exactly, so lane l of a chain's warp runs move l of a group
and the result equals the serial run bit for bit, float32 fields and E
included. What bounds it then is the groups a chain times a group's latency.
Where the state does not fit ("global"), one thread per chain keeps it in
global memory, the moves in order (the site-major [N, B] layout makes each
access one coalesced row segment).

Each chain reads its own beta * scale (a [B] tensor), so a tempering
ladder's T * B chains run as one launch, each with the thresholds of a
one-beta launch at its rung (parallel/tempering.py).

Semantics (as the TPU kernel): each chain is an exact Metropolis chain; the
site schedule is shared across the chain batch, so chains are not mutually
independent. Integer couplings keep exact int32 energies and local fields;
float couplings use float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import check_args, launch, prng
from .rejfree import FIELD_CODES, resident_dtype
from ..core.dtypes import is_integer
from ..utils.profiling import annotate, spanned

#: the most moves of a group (one a lane of a warp; csrc/site.cu kGroupMax)
GROUP_MAX = 32
#: chains a block the resident route may take (one warp each)
CHAIN_CHOICES = (8, 4, 2, 1)

BitsFn = Callable[[int, int], torch.Tensor]


def field_type(J: torch.Tensor, bound: Optional[int]) -> torch.dtype:
    """The resident type of the fields: float32 for float couplings, else
    the narrowest of int8 / int16 / int32 that holds every |lf| <= `bound`
    (None: int32)."""
    return resident_dtype(is_integer(J), bound)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def chain_bytes(N: int, field: torch.dtype) -> int:
    """Shared bytes of one chain on the resident route: N int8 spins, then
    N fields, each part 16-byte aligned (csrc/site.cu chain_bytes)."""
    return _align16(N) + _align16(N * field.itemsize)


def site_plan(N: int, B: int, field: torch.dtype, n_sm: int,
              info: Callable) -> dict:
    """The launch plan of B chains of N sites with resident fields of type
    `field`, by size alone. info(W, need) gives the resident kernel's
    [blocks per SM, registers, local bytes, static shared bytes, most
    dynamic shared bytes] at W warps and `need` dynamic bytes; info(0, 0)
    the global kernel's. Route "resident" when W = 1 chain fits in a
    block's shared memory: W the largest of CHAIN_CHOICES whose blocks all
    fit on the n_sm SMs at once and still occupy every SM; with too few
    chains to occupy them all, the smallest that fits at once (one chain an
    SM where it can); where no W fits at once, the W that holds the most
    chains at once. Else route "global", one thread per chain."""
    cb = chain_bytes(N, field)
    facts = {w: info(w, w * cb) for w in CHAIN_CHOICES}
    fits = [w for w in CHAIN_CHOICES
            if w * cb <= facts[w][4] and facts[w][0] > 0]
    if not fits:
        f = info(0, 0)
        return {"route": "global", "field": str(field).replace("torch.", ""),
                "chains": 32, "warps": 1, "smem": 0, "blocks_per_sm": f[0],
                "registers": f[1], "spill_bytes": f[2],
                "blocks": -(-B // 32)}

    def blocks(w):
        return -(-B // w)

    once = [w for w in fits if n_sm * facts[w][0] >= blocks(w)]
    if once:
        full = [w for w in once if blocks(w) >= n_sm]
        w = max(full) if full else min(once)
    else:
        w = max(fits, key=lambda w: (n_sm * facts[w][0] * w, w))
    f = facts[w]
    return {"route": "resident", "field": str(field).replace("torch.", ""),
            "chains": w, "warps": w, "smem": w * cb, "blocks_per_sm": f[0],
            "registers": f[1], "spill_bytes": f[2], "blocks": blocks(w)}


def site_groups(sites, neigh, N: int, cap: int = GROUP_MAX) -> np.ndarray:
    """The lengths of the schedule's groups, in order: walking the moves
    `sites` [n_moves], a group takes the next move unless it holds `cap`
    moves already or the move's closed neighbourhood {i} + neigh[i]
    (padding == N left out) meets the union of the group's. Moves of one
    group touch disjoint spins and fields, so they commute exactly."""
    rows = np.asarray(neigh.cpu() if torch.is_tensor(neigh) else neigh)
    out, group, n = [], set(), 0
    for i in np.asarray(sites.cpu() if torch.is_tensor(sites) else sites):
        closed = {int(i)} | {int(x) for x in rows[i] if x != N}
        if n == cap or group & closed:
            out.append(n)
            group, n = set(), 0
        group |= closed
        n += 1
    if n:
        out.append(n)
    return np.asarray(out, dtype=np.int64)


def walk_groups(glen) -> np.ndarray:
    """The group lengths from move 0 of a group-length table glen [n_moves]
    (glen[m]: the length of the group that starts at move m), as the
    kernel's warps walk it."""
    glen = np.asarray(glen.cpu() if torch.is_tensor(glen) else glen)
    out, m = [], 0
    while m < glen.shape[0]:
        out.append(int(glen[m]))
        m += int(glen[m])
    return np.asarray(out, dtype=np.int64)


def group_lengths(sites, neigh, N: int, cap: int = GROUP_MAX):
    """glen [n_moves] int32: the length of the greedy group of `site_groups`
    that would start at each move, as the kernel's cut finds it: move m's
    group ends before the first later move m + l (l < cap) whose closed
    neighbourhood meets that of a move in [m, m + l). Launches the cut
    kernel alone (not counted in launch.LAUNCHES) on CUDA tensors."""
    if sites.device.type != "cuda":
        raise ValueError(f"no cut kernel for device {sites.device}")
    from .cuda_build import check, library

    glen = torch.empty_like(sites)
    with torch.cuda.device(sites.device):
        err = library().rrrmc_site_cut(
            sites.data_ptr(), sites.shape[0], neigh.data_ptr(), N,
            neigh.shape[1], cap, glen.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(err, "site_cut launch")
    return glen


def chain_betas(beta_s, B: int, device) -> torch.Tensor:
    """[B] float32 beta * scale of every chain: `beta_s` itself when it is
    a [B] tensor (a tempering ladder's chain by chain), else one value
    filled B times."""
    if torch.is_tensor(beta_s) and beta_s.ndim == 1:
        if beta_s.shape[0] != B:
            raise ValueError(f"beta_s: expected [{B}], got "
                             f"{list(beta_s.shape)}")
        return beta_s.to(device=device, dtype=torch.float32).contiguous()
    return torch.full((B,), float(beta_s), dtype=torch.float32,
                      device=device)


def _check_args(sigT, lfT, E, acc, sites, neigh, J, betas):
    N, B = sigT.shape
    K = neigh.shape[1]
    dt = torch.int32 if is_integer(J) else torch.float32
    want = {"sigT": (sigT, (N, B), torch.int8), "lfT": (lfT, (N, B), dt),
            "E": (E, (B,), dt), "acc": (acc, (B,), torch.int32),
            "sites": (sites, (sites.shape[0],), torch.int32),
            "neigh": (neigh, (N, K), torch.int32), "J": (J, (N, K), dt),
            "beta_s": (betas, (B,), torch.float32)}
    check_args(want, sigT.device)


@spanned("rrrmc.op.site")
def site_chunk(sigT, lfT, E, acc, sites, neigh, J, *, seed: int,
               beta_s, move0: int = 0, chain0: int = 0,
               bits: Optional[BitsFn] = None,
               field_bound: Optional[int] = None) -> None:
    """Run the moves `sites` [n_moves] int32 on every chain, in place.

    sigT [N, B] int8 and lfT [N, B] (int32 for integer J, else float32) are
    site-major; E [B] gains the sum of accepted dE, acc [B] int32 the
    accepted count. neigh/J are the model's [N, K] tables (padding == N).
    beta_s = beta * model.scale: one float for every chain, or a [B]
    tensor of each chain's (`chain_betas`), which the kernel reads once a
    chain. Move m's acceptance bits are Philox word 0
    of counter (0, move0 + m, DRAW_SITE, 0) under key (seed, chain0 + b).
    `field_bound` bounds |lf| over every configuration (the family's
    half_bound; None: int32 resident fields for integer J).

    On a CUDA tensor this launches the kernel on `site_plan`'s route
    (launch.PLANS["site"]); on a CPU tensor it runs the plain version. `bits`
    (move, draw) -> [B] int32 replaces the generator and is taken by the
    plain version only."""
    betas = chain_betas(beta_s, sigT.shape[1], sigT.device)
    _check_args(sigT, lfT, E, acc, sites, neigh, J, betas)
    if sigT.device.type == "cpu":
        site_chunk_reference(sigT, lfT, E, acc, sites, neigh, J, seed=seed,
                             beta_s=betas, move0=move0, chain0=chain0,
                             bits=bits)
        return
    if sigT.device.type != "cuda":
        raise ValueError(f"no site kernel for device {sigT.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    N, B = sigT.shape
    dev = sigT.device
    field = field_type(J, field_bound)
    code = FIELD_CODES[field]
    dev_i = dev.index or 0
    plan = launch.record("site", site_plan(
        N, B, field, launch.sm_count(dev_i),
        launch.info("rrrmc_site_info", (code,), dev_i)))
    resident = plan["route"] == "resident"
    glen = torch.empty_like(sites) if resident else sites
    with torch.cuda.device(dev):
        err = lib.rrrmc_site_metropolis(
            sites.data_ptr(), sites.shape[0], neigh.data_ptr(), J.data_ptr(),
            N, neigh.shape[1], B, sigT.data_ptr(), lfT.data_ptr(),
            E.data_ptr(), acc.data_ptr(), seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, betas.data_ptr(), code,
            plan["chains"] if resident else 0, glen.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    launch.launched("site", err)


def site_chunk_reference(sigT, lfT, E, acc, sites, neigh, J, *, seed: int,
                         beta_s, move0: int = 0, chain0: int = 0,
                         bits: Optional[BitsFn] = None) -> None:
    """Plain torch version of the site kernel, move by move (same arguments
    and in-place contract as `site_chunk`; a [B] beta_s broadcasts over the
    chains, so each chain's threshold is the one-beta launch's at its
    beta)."""
    N, B = sigT.shape
    K = neigh.shape[1]
    dt = lfT.dtype
    dev = sigT.device
    beta = chain_betas(beta_s, B, dev)
    nb_rows = neigh.tolist()
    j_rows = J.tolist()
    dE_sum = torch.zeros(B, dtype=dt, device=dev)
    n_acc = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    n_moves = sites.shape[0]
    draws = (map(lambda m: bits(m, prng.DRAW_SITE), range(n_moves))
             if bits is not None else prng.per_move(
                 lambda lo, n: prng.draw_bits(seed, chain0, B, move0 + lo, n,
                                              prng.DRAW_SITE, dev),
                 n_moves, 256))
    for i, rb in zip(sites.tolist(), draws):
        s = sigT[i].to(dt)
        dE = 2 * s * lfT[i]
        p = torch.exp(-beta * dE.to(torch.float32))
        th = (p * 4294967296.0 - 2147483648.0).clamp(
            -2147483648.0, 2147483520.0).to(torch.int32)
        a = (dE <= 0) | (rb < th)
        d = torch.where(a, -2 * s, zero)
        sigT[i] = torch.where(a, -sigT[i], sigT[i])
        for k in range(K):
            nb = nb_rows[i][k]
            if nb < N:
                lfT[nb] += j_rows[i][k] * d
        dE_sum += torch.where(a, dE, zero)
        n_acc += a.to(torch.int32)
    E += dE_sum
    acc += n_acc


class SiteSampler:
    """Reusable single-site Metropolis runner for a Pairwise model (integer
    couplings: exact int32 energies; float couplings: float32 lf/E)."""

    #: moves per launch (bounds the device site table to 4 MB)
    MAX_MOVES = 1 << 20

    def __init__(self, model, beta: float):
        from ..models.pairwise import Pairwise

        if not isinstance(model, Pairwise):
            raise TypeError("SiteSampler requires a Pairwise model")
        self.N = model.N
        self.neigh = model.neigh.contiguous()
        self.J = model.J.contiguous()
        self.beta_s = float(beta) * model.scale
        # the bound on |lf| (samplers/families.py::half_bound's rule): the
        # largest row sum of |J| plus |h|; None for float couplings
        self.field_bound = None
        if is_integer(self.J):
            rows = (self.J.abs().to(torch.int64).sum(1)
                    + model.h.abs().to(torch.int64))
            with annotate("rrrmc.sync.field_bound"):
                self.field_bound = int(rows.max())

    def __call__(self, sigT, lfT, E, acc, *, generator: torch.Generator,
                 seed: int, n_moves: int, move0: int = 0, chain0: int = 0,
                 sweep_schedule: bool = False,
                 beta_s=None) -> None:
        """Advance every chain by `n_moves` moves, in place on the
        site-major sigT / lfT [N, B] and on E, acc [B]. The shared site
        schedule is drawn on the device from `generator`; Philox moves are
        numbered from `move0`, so consecutive calls with one seed continue
        the stream, and chain b draws under key (seed, chain0 + b). Every
        chain runs at the sampler's beta, or at `beta_s` (beta * scale):
        one value, or a [B] tensor of each chain's (a tempering ladder's).

        sweep_schedule=True makes the schedule a concatenation of random
        PERMUTATIONS of [0, N) (the JAX package's, from `seed`): every
        consecutive block of N moves from move0 = 0 attempts each site
        exactly once, also across calls (the permutation phase follows
        move0)."""
        N = self.N
        dev = sigT.device
        beta_s = chain_betas(self.beta_s if beta_s is None else beta_s,
                             sigT.shape[1], dev)
        done = 0
        while done < n_moves:
            m = min(self.MAX_MOVES, n_moves - done)
            with annotate("rrrmc.prep.site_schedule"):
                if sweep_schedule:
                    g0 = move0 + done
                    s0, s1 = g0 // N, (g0 + m - 1) // N
                    stream = np.concatenate([_perm_of(seed, s, N)
                                             for s in range(s0, s1 + 1)])
                    off = g0 - s0 * N
                    sites = torch.as_tensor(
                        stream[off:off + m].astype(np.int32), device=dev)
                else:
                    sites = torch.randint(0, N, (m,), generator=generator,
                                          device=dev, dtype=torch.int32)
            site_chunk(sigT, lfT, E, acc, sites, self.neigh, self.J,
                       seed=seed, beta_s=beta_s, move0=move0 + done,
                       chain0=chain0, field_bound=self.field_bound)
            done += m


def _perm_of(seed: int, s_idx: int, N: int) -> np.ndarray:
    """Deterministic permutation for global sweep s_idx (the JAX package's
    sweep schedule): a sweep split across calls regenerates identical
    entries."""
    rng = np.random.default_rng(((seed & 0x7FFFFFFF) << 20) ^ s_idx)
    return rng.permutation(N)
