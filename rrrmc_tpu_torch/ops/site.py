"""Single-site Metropolis on sparse Pairwise models: the CUDA kernel
(csrc/site.cu), its plain torch version, and the `SiteSampler` runner.

Source note. The kernel replaces rrrmc_tpu/ops/site_pallas.py::_site_kernel
(called by `_pallas_site`). On the H100 it is bound by latency, not by bytes
or operations: a move is a chain of dependent steps (read the site, read
sigma and lf, exp, Philox, read-modify-write K neighbour rows), and only B
threads exist. The design keeps every access coalesced instead: the layout is
site-major [N, B] and the site schedule is shared by the batch, so a warp's
32 threads touch one contiguous row segment per access, and blocks are one
warp wide so that a batch of B chains spreads over B/32 SMs. Later work
(ROADMAP.md) may give each chain its own schedule.

Semantics (as the TPU kernel): each chain is an exact Metropolis chain; the
site schedule is shared across the chain batch, so chains are not mutually
independent. Integer couplings keep exact int32 energies and local fields;
float couplings use float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import check_args, prng
from ..core.dtypes import is_integer

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

BitsFn = Callable[[int, int], torch.Tensor]


def _check_args(sigT, lfT, E, acc, sites, neigh, J):
    N, B = sigT.shape
    K = neigh.shape[1]
    dt = torch.int32 if is_integer(J) else torch.float32
    want = {"sigT": (sigT, (N, B), torch.int8), "lfT": (lfT, (N, B), dt),
            "E": (E, (B,), dt), "acc": (acc, (B,), torch.int32),
            "sites": (sites, (sites.shape[0],), torch.int32),
            "neigh": (neigh, (N, K), torch.int32), "J": (J, (N, K), dt)}
    check_args(want, sigT.device)


def site_chunk(sigT, lfT, E, acc, sites, neigh, J, *, seed: int,
               beta_s: float, move0: int = 0, chain0: int = 0,
               bits: Optional[BitsFn] = None) -> None:
    """Run the moves `sites` [n_moves] int32 on every chain, in place.

    sigT [N, B] int8 and lfT [N, B] (int32 for integer J, else float32) are
    site-major; E [B] gains the sum of accepted dE, acc [B] int32 the
    accepted count. neigh/J are the model's [N, K] tables (padding == N).
    beta_s = beta * model.scale. Move m's acceptance bits are Philox word 0
    of counter (0, move0 + m, DRAW_SITE, 0) under key (seed, chain0 + b).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version. `bits` (move, draw) -> [B] int32 replaces the generator
    and is taken by the plain version only."""
    global LAUNCHES
    _check_args(sigT, lfT, E, acc, sites, neigh, J)
    if sigT.device.type == "cpu":
        site_chunk_reference(sigT, lfT, E, acc, sites, neigh, J, seed=seed,
                             beta_s=beta_s, move0=move0, chain0=chain0,
                             bits=bits)
        return
    if sigT.device.type != "cuda":
        raise ValueError(f"no site kernel for device {sigT.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    N, B = sigT.shape
    with torch.cuda.device(sigT.device):
        err = lib.rrrmc_site_metropolis(
            sites.data_ptr(), sites.shape[0], neigh.data_ptr(), J.data_ptr(),
            N, neigh.shape[1], B, sigT.data_ptr(), lfT.data_ptr(),
            E.data_ptr(), acc.data_ptr(), seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, beta_s,
            0 if is_integer(J) else 1,
            torch.cuda.current_stream().cuda_stream)
    check(err, "site_metropolis launch")
    LAUNCHES += 1


def site_chunk_reference(sigT, lfT, E, acc, sites, neigh, J, *, seed: int,
                         beta_s: float, move0: int = 0, chain0: int = 0,
                         bits: Optional[BitsFn] = None) -> None:
    """Plain torch version of the site kernel, move by move (same arguments
    and in-place contract as `site_chunk`)."""
    N, B = sigT.shape
    K = neigh.shape[1]
    dt = lfT.dtype
    dev = sigT.device
    beta = torch.tensor(beta_s, dtype=torch.float32, device=dev)
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

    def __call__(self, sigT, lfT, E, acc, *, generator: torch.Generator,
                 seed: int, n_moves: int, move0: int = 0,
                 sweep_schedule: bool = False) -> None:
        """Advance every chain by `n_moves` moves, in place on the
        site-major sigT / lfT [N, B] and on E, acc [B]. The shared site
        schedule is drawn on the device from `generator`; Philox moves are
        numbered from `move0`, so consecutive calls with one seed continue
        the stream.

        sweep_schedule=True makes the schedule a concatenation of random
        PERMUTATIONS of [0, N) (the JAX package's, from `seed`): every
        consecutive block of N moves from move0 = 0 attempts each site
        exactly once, also across calls (the permutation phase follows
        move0)."""
        N = self.N
        dev = sigT.device
        done = 0
        while done < n_moves:
            m = min(self.MAX_MOVES, n_moves - done)
            if sweep_schedule:
                g0 = move0 + done
                s0, s1 = g0 // N, (g0 + m - 1) // N
                stream = np.concatenate([_perm_of(seed, s, N)
                                         for s in range(s0, s1 + 1)])
                off = g0 - s0 * N
                sites = torch.as_tensor(stream[off:off + m].astype(np.int32),
                                        device=dev)
            else:
                sites = torch.randint(0, N, (m,), generator=generator,
                                      device=dev, dtype=torch.int32)
            site_chunk(sigT, lfT, E, acc, sites, self.neigh, self.J,
                       seed=seed, beta_s=self.beta_s, move0=move0 + done)
            done += m


def _perm_of(seed: int, s_idx: int, N: int) -> np.ndarray:
    """Deterministic permutation for global sweep s_idx (the JAX package's
    sweep schedule): a sweep split across calls regenerates identical
    entries."""
    rng = np.random.default_rng(((seed & 0x7FFFFFFF) << 20) ^ s_idx)
    return rng.permutation(N)
