"""tau-EO moves on random K-SAT: the CUDA kernel's wrapper (csrc/eo_sat.cu,
with csrc/sat.cuh), its launch plan and its plain torch version. ops/sat.py's
source note describes the design and holds the eligibility rule.

Source note. Replaces rrrmc_tpu/ops/sat_pallas.py::_eo_sat_kernel. The
kernel runs the move loop of csrc/eo_chain.cuh, the sparse EO kernel's
(ops/eo.py), ranking the variables by dE itself: W warps a chain by
ops/eo.py::eo_plan (32 at 128 chains of GraphSAT(10^4, 3, 4.2)), the ranks
drawn ahead, the warp-level select over 2 Cmax + 1 exact histogram bins
(|dE| <= Cmax, the width of the variable-major table T) and the packed tie
race; dE resident as biased uint8 keys where Cmax <= 127, else biased
uint16 (`sat_key_type`), beside the clause counts (uint8) and the spins as
bits. The flip is ops/sat.py's incremental count and dE update by one warp,
each atomic change of a dE moving its key between bins.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import launch
from .eo import BitsFn, eo_chunk_reference, key_bins, planned
from .sat import check_sat_args, de_flip
from ..models.sat import flip_counts
from ..utils.profiling import spanned

#: the kernel's key types by its codes: dE biased by 128 in a uint8, by
#: 32768 in a uint16
SAT_KEY_CODES = {torch.uint8: 0, torch.uint16: 1}
#: the largest Cmax of the uint8 keys (sat.cuh: kDeByteMax)
BYTE_KEY_MAX = 127


def sat_key_type(cmax: int) -> torch.dtype:
    """The resident type of the SAT EO kernel's dE keys, |dE| <= Cmax:
    biased uint8 up to Cmax = 127, else biased uint16."""
    return torch.uint8 if cmax <= BYTE_KEY_MAX else torch.uint16


@spanned("rrrmc.op.eo_sat")
def eo_sat_chunk(sigma, sat, E, emin, smin, itmin, A, L, T, TL, cdf, *,
                 n_moves: int, seed: int, move0: int = 0, chain0: int = 0,
                 bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place: the contract of
    ops/eo.py::eo_sparse_chunk, with the satisfied counts sat [B, Mc] int32
    in the place of lf and the model's tables A, L, T, TL in the place of
    neigh/J. The key is dE, |dE| <= Cmax = T.shape[1]: the kernel counts
    the keys in 2 Cmax + 1 histogram bins, with the plan of
    ops/eo.py::eo_plan (launch.PLANS["eo_sat"])."""
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
    from .cuda_build import library

    lib = library()
    Mc, K = A.shape
    cmax = T.shape[1]
    nbins = key_bins(cmax, "SAT")
    key = sat_key_type(cmax)
    code = SAT_KEY_CODES[key]
    plan = planned("eo_sat", "rrrmc_eo_sat_info", (code,),
                   lambda w: lib.rrrmc_eo_sat_smem(N, Mc, code, nbins, w), N,
                   B, key, nbins, sigma.device, extra=Mc, label="SAT EO")
    with torch.cuda.device(sigma.device):
        err = lib.rrrmc_eo_sat(
            sigma.data_ptr(), sat.data_ptr(), E.data_ptr(), emin.data_ptr(),
            smin.data_ptr(), itmin.data_ptr(), A.data_ptr(), L.data_ptr(),
            T.data_ptr(), TL.data_ptr(), cdf.data_ptr(), N, Mc, K, cmax, B,
            n_moves, seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF,
            chain0 & 0xFFFFFFFF, code, nbins, plan["warps"],
            torch.cuda.current_stream().cuda_stream)
    launch.launched("eo_sat", err)


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
