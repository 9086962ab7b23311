"""tau-EO moves on random K-SAT: the CUDA kernel's wrapper (csrc/eo_sat.cu,
with csrc/sat.cuh) and its plain torch version. ops/sat.py's source note
describes the design and holds the eligibility rule.

Source note. Replaces rrrmc_tpu/ops/sat_pallas.py::_eo_sat_kernel: the EO
select of csrc/eo.cuh ranking the variables by dE itself (its key policy
without the spin factor), |dE| <= Cmax (the width of the variable-major
table T), so 2 Cmax + 1 histogram bins, and the incremental count and dE update of ops/sat.py, each atomic
change of a dE moving one key between bins.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import require_smem
from .eo import BitsFn, eo_chunk_reference, key_bins
from .sat import check_sat_args, de_flip
from ..models.sat import flip_counts

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0


def eo_sat_chunk(sigma, sat, E, emin, smin, itmin, A, L, T, TL, cdf, *,
                 n_moves: int, seed: int, move0: int = 0, chain0: int = 0,
                 bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place: the contract of
    ops/eo.py::eo_sparse_chunk, with the satisfied counts sat [B, Mc] int32
    in the place of lf and the model's tables A, L, T, TL in the place of
    neigh/J. The key is dE, |dE| <= Cmax = T.shape[1]: the kernel counts
    the keys in 2 Cmax + 1 histogram bins."""
    global LAUNCHES
    B, N = sigma.shape
    check_sat_args(sigma, sat, E, {
        "emin": (emin, (B,), torch.int32),
        "smin": (smin, (B, N), torch.int8),
        "itmin": (itmin, (B,), torch.int32),
        "cdf": (cdf, (N,), torch.float32)}, A, L, T, TL)
    if sigma.device.type == "cpu":
        return eo_sat_chunk_reference(
            sigma, sat, E, emin, smin, itmin, A, L, T, TL, cdf,
            n_moves=n_moves, seed=seed, move0=move0, chain0=chain0,
            bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no EO kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    Mc, K = A.shape
    dev = sigma.device
    nbins = key_bins(T.shape[1], "SAT")
    require_smem(lib.rrrmc_eo_sat_smem(N, Mc, nbins),
                 lib.rrrmc_eo_sat_max_smem(dev.index or 0), N, "SAT EO")
    with torch.cuda.device(dev):
        err = lib.rrrmc_eo_sat(
            sigma.data_ptr(), sat.data_ptr(), E.data_ptr(), emin.data_ptr(),
            smin.data_ptr(), itmin.data_ptr(), A.data_ptr(), L.data_ptr(),
            T.data_ptr(), TL.data_ptr(), cdf.data_ptr(), N, Mc, K,
            T.shape[1], B, n_moves, seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF,
            chain0 & 0xFFFFFFFF, nbins,
            torch.cuda.current_stream().cuda_stream)
    check(err, "eo_sat launch")
    LAUNCHES += 1


def eo_sat_chunk_reference(sigma, sat, E, emin, smin, itmin, A, L, T, TL,
                           cdf, *, n_moves: int, seed: int, move0: int = 0,
                           chain0: int = 0, bits: Optional[BitsFn] = None):
    """Plain torch version of the SAT EO kernel (same arguments and in-place
    contract as `eo_sat_chunk`)."""
    de_of, _ = de_flip(T, TL)
    do = torch.ones(sigma.shape[0], dtype=torch.bool, device=sigma.device)

    def flip_fields(sig, sat, win, d):
        flip_counts(T, TL, sat, win, d // 2, do)

    eo_chunk_reference(sigma, sat, E, emin, smin, itmin, cdf, flip_fields,
                       n_moves=n_moves, seed=seed, move0=move0,
                       chain0=chain0, bits=bits, de_of=de_of)
