"""tau-EO moves on the binary perceptrons: the CUDA kernel's wrapper
(csrc/eo_perc.cu, with csrc/perc.cuh) and its plain torch version.
ops/perc.py's source note describes the design and holds the eligibility
rule.

Source note. Replaces rrrmc_tpu/ops/perc_pallas.py::_eo_perc_kernel: the EO
select of csrc/eo.cuh ranking the sites by dE itself (its key policy without
the spin factor), recomputed from the stabilities at every move as the race
kernel computes it. Step and linear give integer keys with |dE| <= P (a
flip moves each pattern's loss by at most one), counted in a histogram of
2 P + 1 bins, refilled every move since every dE may change; above HIST_MAX
bins, and for xentr's float32 keys, the radix select. The TPU kernel ranked
by dE2 = 2 dE with a binary-search order statistic; the order and the ties
are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import require_smem
from .eo import BitsFn, eo_chunk_reference, hist_bins
from .perc import FAMILY_CODES, check_perc_args, de_flip, table_family

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0


def eo_perc_chunk(sigma, delta, E, emin, smin, itmin, xi4, xiT, loss, xb,
                  cdf, *, n_moves: int, seed: int, move0: int = 0,
                  chain0: int = 0, bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place: the contract of
    ops/eo.py::eo_sparse_chunk, with the stabilities delta [B, P] int32 in
    the place of lf, E and emin int32 (float32 for xentr) and the tables of
    ops/perc.py::perc_tables in the place of neigh/J (it reads xi4 and xiT,
    not the race kernel's bits xb). The key is dE: the
    kernel counts integer keys in 2 P + 1 histogram bins when that is at
    most HIST_MAX, else (and for xentr) it takes the radix select."""
    global LAUNCHES
    B, N = sigma.shape
    et = E.dtype
    fam, c = check_perc_args(sigma, delta, E, {
        "emin": (emin, (B,), et), "smin": (smin, (B, N), torch.int8),
        "itmin": (itmin, (B,), torch.int32),
        "cdf": (cdf, (N,), torch.float32)}, xi4, xiT, loss, xb)
    if sigma.device.type == "cpu":
        return eo_perc_chunk_reference(
            sigma, delta, E, emin, smin, itmin, xi4, xiT, loss, xb, cdf,
            n_moves=n_moves, seed=seed, move0=move0, chain0=chain0,
            bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no EO kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    P = xiT.shape[1]
    dev = sigma.device
    nbins = hist_bins(fam != "xentr", P)
    require_smem(lib.rrrmc_eo_perc_smem(N, P, nbins),
                 lib.rrrmc_eo_perc_max_smem(dev.index or 0), N,
                 "perceptron EO")
    with torch.cuda.device(dev):
        err = lib.rrrmc_eo_perc(
            sigma.data_ptr(), delta.data_ptr(), E.data_ptr(),
            emin.data_ptr(), smin.data_ptr(), itmin.data_ptr(),
            xi4.data_ptr(), xiT.data_ptr(), cdf.data_ptr(), N, P,
            xi4.shape[1] // 4, B, n_moves, seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, nbins,
            FAMILY_CODES[fam], c, torch.cuda.current_stream().cuda_stream)
    check(err, "eo_perc launch")
    LAUNCHES += 1


def eo_perc_chunk_reference(sigma, delta, E, emin, smin, itmin, xi4, xiT,
                            loss, xb, cdf, *, n_moves: int, seed: int,
                            move0: int = 0, chain0: int = 0,
                            bits: Optional[BitsFn] = None):
    """Plain torch version of the perceptron EO kernel (same arguments and
    in-place contract as `eo_perc_chunk`)."""
    N = sigma.shape[1]
    fam, c = table_family(loss, N)
    de_of, delta_flipped = de_flip(fam, c, xi4, xiT, N)
    do = torch.ones(sigma.shape[0], dtype=torch.bool, device=sigma.device)

    def flip_fields(sig, delta, win, d):
        delta.copy_(delta_flipped(sig, delta, win, d, do))

    eo_chunk_reference(sigma, delta, E, emin, smin, itmin, cdf, flip_fields,
                       n_moves=n_moves, seed=seed, move0=move0,
                       chain0=chain0, bits=bits, de_of=de_of)
