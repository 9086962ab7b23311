"""Race moves (bkl / wtm / rrr) on random K-SAT: the CUDA kernel
(csrc/rejfree_sat.cu, with csrc/sat.cuh), its plain torch version, and the
eligibility rule and tables of the SAT race and EO kernels (the EO kernel's
wrapper is ops/eo_sat.py).

Source note. The race kernel replaces
rrrmc_tpu/ops/sat_pallas.py::_rejfree_sat_kernel and the EO kernel that
file's _eo_sat_kernel. A chain keeps in shared memory its spins (int8), its
per-clause satisfied counts (uint8) and the exact energy change of
flipping each variable, dE (16 bits in the race, |dE| <= Cmax <= 32767:
3 bytes a variable and one a clause, 72 KB at N = 10^4, alpha = 4.2; int32
in the EO kernel, which adds the best spins). The TPU kernels
bit-packed the counts per variable and clause slot and recomputed dE from
them over all Cmax slots at every move, comparing every site's partner
columns to the winner, because Mosaic has no gather. Here the counts are
per clause, unpacked, and dE is kept incrementally: the flip of w moves the
counts of w's clauses by -sigma_w * TL[w] and, for each such clause, the dE
of its K variables by the difference of the clause's terms (+1 where the
variable is the sole satisfier, -1 where the clause is violated), O(Cmax K)
gathers from shared memory, by one warp with a lane per clause slot (the
race) or by the block with a thread per slot (EO), and shared atomics
where two clauses share a variable (32-bit atomics on the race's pairs of
16-bit dE). dE is derived from the counts once per launch. Between
launches the counts live in the caller's [B, Mc] int32 tensor (the model's
aux), written back in place.

The race weighs site i by beta * scale * max(dE_i, 0), as every race
kernel does, and a flip changes E by dE_w; the EO key is dE, |dE| <=
max_conn, so integer keys take a histogram of 2 max_conn + 1 bins. The race
kernel runs race.cuh's fused pass (`race_moves`: the race, min bE and z
from one evaluation of each variable, behind the score bound) with the
launch rule of ops/rejfree.py (`fused_plan`: 512 threads a chain at 128
chains), the Boltzmann terms from a table of exp(-beta_s k) over k = 0 ..
Cmax; the plain version sums z in the order of the T it is given. rrr
applies the flip tentatively and, when rejected, applies the same flip
again, which is exact. The race is bound by its fused pass over the
resident variables; the EO kernel by its passes, as the sparse one is.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import check_args, launch
from .rejfree import (BitsFn, MODES, THREADS, coord_dtype,
                      race_chunk_reference, race_plan)
from ..models.sat import delta_from_counts, flip_counts
from ..utils.profiling import spanned

#: the race kernel's bound on Cmax, which bounds |dE| (its 16-bit dE)
DE_MAX = 32767


def sat_rejfree_ok(model) -> bool:
    """Eligibility of a model for the SAT race and EO kernels (the JAX
    package's `sat_rejfree_ok` without its field-width caps K <= 7,
    Cmax <= 128 // (K - 1), N <= 16384: the shared-memory limit is checked at
    launch): a SATModel with N >= 8 whose every clause holds K distinct
    variables, the one rule a correct count update needs (each of a flip's
    slots moves its clause's count once)."""
    from ..models.sat import SATModel

    return (isinstance(model, SATModel) and model.N >= 8
            and distinct_variables(model))


def distinct_variables(model) -> bool:
    """Whether every clause of a SATModel holds K distinct variables."""
    srt = model.A.sort(dim=1).values
    return not bool((srt[:, 1:] == srt[:, :-1]).any())


def sat_tables(model) -> tuple:
    """The kernels' tables of a SATModel: (A, L, T, TL)."""
    return model.A, model.L, model.T, model.TL


def check_sat_args(sigma, sat, E, scalars: dict, A, L, T, TL):
    """check_args for the spins, counts, E, the wrapper's `scalars` and the
    model's tables."""
    B, N = sigma.shape
    Mc, K = A.shape
    Cmax = T.shape[1]
    i32 = torch.int32
    check_args({"sigma": (sigma, (B, N), torch.int8),
                "sat": (sat, (B, Mc), i32), "E": (E, (B,), i32),
                **scalars,
                "A": (A, (Mc, K), i32), "L": (L, (Mc, K), i32),
                "T": (T, (N, Cmax), i32), "TL": (TL, (N, Cmax), i32)},
               sigma.device)


def de_flip(T, TL):
    """(de_of, lf_flipped) of the plain race: the resident state is the
    counts, and dE is derived from them."""

    def de_of(sig, sat):
        return delta_from_counts(T, TL, sig, sat)

    def sat_flipped(sig, sat, win, d, do):
        return flip_counts(T, TL, sat.clone(), win, d // 2, do)

    return de_of, sat_flipped


@spanned("rrrmc.op.rejfree_sat")
def rejfree_sat_chunk(sigma, sat, E, coord, acc, zacc, A, L, T, TL, *,
                      mode: str, n_moves: int, beta_s: float, target,
                      seed: int, move0: int = 0, chain0: int = 0,
                      bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` race moves, in place: the contract
    of ops/rejfree.py::rejfree_sparse_chunk, with the satisfied counts sat
    [B, Mc] int32 in the place of lf, int32 E and the model's tables A, L
    [Mc, K] and T, TL [N, Cmax] (int32) in the place of neigh/J. On a CUDA
    tensor this launches the kernel with the launch rule's block size
    (`fused_plan`; a variable in more than 32767 clauses, beyond its 16-bit
    dE, is refused); on a CPU tensor it runs the plain version. Returns the
    per-move (coordinate, E) streams, each [n_moves, B]."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    B = sigma.shape[0]
    check_sat_args(sigma, sat, E, {
        "coord": (coord, (B,), coord_dtype(mode)),
        "acc": (acc, (B,), torch.int32),
        "zacc": (zacc, (B,), torch.float32)}, A, L, T, TL)
    if sigma.device.type == "cpu":
        return rejfree_sat_chunk_reference(
            sigma, sat, E, coord, acc, zacc, A, L, T, TL, mode=mode,
            n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
            move0=move0, chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no race kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    Cmax = T.shape[1]
    if Cmax > DE_MAX:
        raise NotImplementedError(
            f"the SAT race kernel keeps dE in 16 bits: a variable in "
            f"{Cmax} clauses exceeds its bound {DE_MAX}")
    from .cuda_build import library

    lib = library()
    N = sigma.shape[1]
    Mc, K = A.shape
    dev = sigma.device
    ct = coord_dtype(mode)
    threads = race_plan("rejfree_sat", "rrrmc_rejfree_sat_info",
                        (int(mode == "wtm"),), B, N,
                        lib.rrrmc_rejfree_sat_smem(N, Mc, Cmax), torch.int16,
                        dev.index or 0)["threads"]
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_sat(
            sigma.data_ptr(), sat.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            A.data_ptr(), L.data_ptr(), T.data_ptr(), TL.data_ptr(), N, Mc,
            K, Cmax, B, n_moves, seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF,
            chain0 & 0xFFFFFFFF, beta_s,
            int(target) if ct == torch.int32 else 0, float(target),
            MODES[mode], threads,
            torch.cuda.current_stream().cuda_stream)
    launch.launched("rejfree_sat", err)
    return cs, es


def rejfree_sat_chunk_reference(sigma, sat, E, coord, acc, zacc, A, L, T, TL,
                                *, mode: str, n_moves: int, beta_s: float,
                                target, seed: int, move0: int = 0,
                                chain0: int = 0,
                                bits: Optional[BitsFn] = None,
                                threads: int = THREADS):
    """Plain torch version of the SAT race kernel (same arguments, in-place
    contract and streams as `rejfree_sat_chunk`; z summed as the kernel's
    fused pass sums it with `threads` threads a block): dE is recomputed
    from the counts at every move."""
    de_of, sat_flipped = de_flip(T, TL)
    return race_chunk_reference(
        sigma, sat, E, coord, acc, zacc, sat_flipped, mode=mode,
        n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
        move0=move0, chain0=chain0, bits=bits, de_of=de_of, threads=threads)
