"""tau-extremal optimisation (EO) moves on sparse Pairwise models, EA
lattices included: the CUDA kernel (csrc/eo_sparse.cu), its plain torch
version, and the move loop and the order-statistic select shared with the
dense EO kernel's plain version (ops/eo_dense.py).

Source note. The kernel replaces rrrmc_tpu/ops/eo_pallas.py::
_eo_sparse_kernel (launched by `_pallas_eo_sparse_run`) and the lattice
branch of that file's `_eo_kernel` (`_pallas_eo_run` with dense=False): to
EO a LatticeEA is a sparse Pairwise with K = 2D and its padded tables, as the
lattice race was folded into the sparse race (ops/rejfree.py). Each chain's
spins, local fields and best spins stay resident in shared memory for the
whole launch (6 bytes a site, 60 KB at N = 10^4). The TPU found the order
statistic by up to 32 counting passes over the chain block, since Mosaic
has no gather; here integer keys of a range of at most HIST_MAX values are
counted in a shared histogram that each flip updates in O(K), so the select
is one block scan, and other keys take a four-pass radix select. It is
bound by the tie race's pass over the resident sites and the block barriers
of a move (csrc/eo.cuh).

The move (the TPU kernels' law, the same on every route of the port):
half_i = sigma_i lf_i and dE_i = 2 half_i; the rank is #{i : cdf_i < u}
with u from the Philox rank draw and cdf the float32 cast of the float64
cumulative k^-tau table; v is the (rank+1)-th smallest key (half for integer
couplings, the monotone int32 key of the float32 half otherwise, so -0.0
sorts below +0.0); among the sites whose key equals v the smallest score
min(bits_i, INT32_MAX - 1) wins, bits_i the signed Philox tie word, the
lowest index among equal scores; the winner flips unconditionally, and
E < Emin (strict) records Emin, sigma_min and itmin = move0 + m + 1.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import check_args, prng
from ..core.dtypes import is_integer

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

#: the most bins of the kernels' integer histogram select (kEoHistMax)
HIST_MAX = 4096
_I32_MAX = 2 ** 31 - 1

BitsFn = Callable[[int, int], torch.Tensor]


def hist_bins(integer: bool, half_max: Optional[int]) -> int:
    """The kernels' select: 2*half_max + 1 histogram bins for integer keys
    bounded by half_max when that is at most HIST_MAX, else 0 (the radix
    select)."""
    if not integer or half_max is None or 2 * half_max + 1 > HIST_MAX:
        return 0
    return 2 * int(half_max) + 1


def sort_key(half: torch.Tensor) -> torch.Tensor:
    """The select's int32 key: half itself for integers; for float32 the
    monotone key of its bits, b ^ ((b >> 31) & 0x7fffffff)."""
    if is_integer(half):
        return half
    b = half.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def select_rank_with_ties(key: torch.Tensor, rank: torch.Tensor,
                          tie_bits: torch.Tensor) -> torch.Tensor:
    """[B] index of the rank[b]-th smallest (0-based) entry of each row of
    key [B, N], uniformly random among equal values: the race of the scores
    min(tie_bits, INT32_MAX - 1) over the entries equal to it, the smallest
    score winning and the lowest index among equal scores."""
    v = key.sort(dim=1).values.gather(1, rank[:, None].long())
    imax = torch.tensor(_I32_MAX, dtype=torch.int32, device=key.device)
    score = torch.where(key == v, tie_bits.clamp(max=_I32_MAX - 1), imax)
    return score.argmin(dim=1)


def eo_draws(seed: int, chain0: int, B: int, N: int, move0: int,
             n_moves: int, device, bits: Optional[BitsFn] = None):
    """Iterators over the moves' rank draws [B] and tie-race bits [B, N]:
    the Philox streams of the moves move0 .. move0 + n_moves - 1, or
    bits(m, draw) where given."""
    if bits is not None:
        return (map(lambda m: bits(m, prng.DRAW_EO_RANK), range(n_moves)),
                map(lambda m: bits(m, prng.DRAW_EO_TIE), range(n_moves)))
    block = max(1, min(64, (1 << 18) // (B * N)))
    return (prng.per_move(lambda lo, n: prng.eo_rank_bits(
                seed, chain0, B, move0 + lo, n, device), n_moves, 256),
            prng.per_move(lambda lo, n: prng.eo_tie_bits(
                seed, chain0, B, N, move0 + lo, n, device), n_moves, block))


def _check_args(sigma, lf, E, emin, smin, itmin, cdf, tables: dict):
    B, N = sigma.shape
    dt = lf.dtype
    if dt not in (torch.int32, torch.float32):
        raise ValueError(f"lf: expected int32 or float32, got {dt}")
    want = {"sigma": (sigma, (B, N), torch.int8), "lf": (lf, (B, N), dt),
            "E": (E, (B,), dt), "emin": (emin, (B,), dt),
            "smin": (smin, (B, N), torch.int8),
            "itmin": (itmin, (B,), torch.int32),
            "cdf": (cdf, (N,), torch.float32), **tables}
    check_args(want, sigma.device)


def launch_args(sigma, lf, E, emin, smin, itmin):
    """The state's pointers, as both EO kernels take them."""
    return (sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), emin.data_ptr(),
            smin.data_ptr(), itmin.data_ptr())


def eo_sparse_chunk(sigma, lf, E, emin, smin, itmin, neigh, J, cdf, *,
                    n_moves: int, seed: int, half_max: Optional[int] = None,
                    move0: int = 0, chain0: int = 0,
                    bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place.

    sigma and smin [B, N] int8 and lf [B, N] (int32 for integer J, else
    float32) are chain-major; E and emin [B] (lf's dtype) and itmin [B]
    int32 are updated; neigh/J are the model's [N, K] tables (padding == N,
    J's dtype that of lf), cdf [N] float32 the rank table. For integer J,
    half_max bounds |sigma_i lf_i| over every configuration (the largest row
    sum of |J| plus |h|): the kernel then counts keys in a histogram when
    2*half_max + 1 <= HIST_MAX, else (and for float J) it takes the radix
    select.

    Random words are Philox under key (seed, chain0 + b), counter
    (word, move0 + m, draw, 0) (ops/prng.py: DRAW_EO_RANK, DRAW_EO_TIE). On
    a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version. `bits` (move, draw) -> int32 ([B] for the rank, [B, N]
    for the tie race) replaces the generator and is taken by the plain
    version only."""
    global LAUNCHES
    B, N = sigma.shape
    K = neigh.shape[1]
    _check_args(sigma, lf, E, emin, smin, itmin, cdf,
                {"neigh": (neigh, (N, K), torch.int32),
                 "J": (J, (N, K), lf.dtype)})
    if sigma.device.type == "cpu":
        return eo_sparse_chunk_reference(
            sigma, lf, E, emin, smin, itmin, neigh, J, cdf, n_moves=n_moves,
            seed=seed, half_max=half_max, move0=move0, chain0=chain0,
            bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no EO kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    dev = sigma.device
    nbins = hist_bins(is_integer(J), half_max)
    smem = lib.rrrmc_eo_sparse_smem(N, nbins)
    cap = lib.rrrmc_eo_sparse_max_smem(dev.index or 0)
    if smem > cap:
        raise NotImplementedError(
            f"the sparse EO kernel keeps a chain's spins, local fields and "
            f"best spins in shared memory: N={N} needs {smem} bytes, a block "
            f"may have {cap}")
    with torch.cuda.device(dev):
        err = lib.rrrmc_eo_sparse(
            *launch_args(sigma, lf, E, emin, smin, itmin), neigh.data_ptr(),
            J.data_ptr(), cdf.data_ptr(), N, K, B, n_moves,
            seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            nbins, 0 if is_integer(J) else 1,
            torch.cuda.current_stream().cuda_stream)
    check(err, "eo_sparse launch")
    LAUNCHES += 1


def eo_sparse_chunk_reference(sigma, lf, E, emin, smin, itmin, neigh, J, cdf,
                              *, n_moves: int, seed: int,
                              half_max: Optional[int] = None, move0: int = 0,
                              chain0: int = 0,
                              bits: Optional[BitsFn] = None):
    """Plain torch version of the sparse EO kernel (same arguments and
    in-place contract as `eo_sparse_chunk`; half_max, a choice of the
    kernel's select, changes nothing here)."""
    N, K = neigh.shape
    rows = torch.arange(sigma.shape[0], device=sigma.device)

    def flip_fields(lf, win, d):
        """The winner's K neighbours' fields += J[win, k] * d, in place."""
        nb = neigh[win].long()
        jr = J[win]
        for k in range(K):
            sel = nb[:, k] < N
            lf[rows[sel], nb[sel, k]] += jr[sel, k] * d[sel]

    eo_chunk_reference(sigma, lf, E, emin, smin, itmin, cdf, flip_fields,
                       n_moves=n_moves, seed=seed, move0=move0,
                       chain0=chain0, bits=bits)


def eo_chunk_reference(sigma, lf, E, emin, smin, itmin, cdf, flip_fields, *,
                       n_moves: int, seed: int, move0: int = 0,
                       chain0: int = 0, bits: Optional[BitsFn] = None):
    """The EO moves of the sparse and dense kernels' plain versions, over
    [B, N] tensors; `flip_fields(lf, win, d)` adds the flip of the winner
    win [B] (d = -2 sigma_win) to lf in place."""
    B, N = sigma.shape
    dev = sigma.device
    rows = torch.arange(B, device=dev)
    sig = sigma.to(lf.dtype)
    rank_draws, tie_draws = eo_draws(seed, chain0, B, N, move0, n_moves, dev,
                                     bits)
    for m in range(n_moves):
        half = sig * lf
        rank = torch.searchsorted(cdf, prng.to_uniform(next(rank_draws)))
        win = select_rank_with_ties(sort_key(half), rank, next(tie_draws))
        s_w = sig[rows, win]
        dE = 2 * half[rows, win]
        sig[rows, win] = -s_w
        flip_fields(lf, win, -2 * s_w)
        E += dE
        better = E < emin
        emin.copy_(torch.where(better, E, emin))
        smin.copy_(torch.where(better[:, None], sig.to(torch.int8), smin))
        itmin.copy_(torch.where(better, move0 + m + 1, itmin))
    sigma.copy_(sig.to(torch.int8))
