"""tau-EO moves on PSpin3 hypergraphs: the CUDA kernel's wrapper
(csrc/eo_sparse.cu instantiated with the hypergraph flip) and its plain
torch version. ops/pspin.py's source note describes the design and holds the
eligibility rule.

Source note. Replaces rrrmc_tpu/ops/eo_pallas.py::_eo_pspin_kernel: the
sparse EO kernel with the cavity sums c in the place of the local fields
(keys sigma_i c_i in [-K, K], 2K + 1 histogram bins) and the flip of
ops/pspin.py, whose 2K updates each move one key between bins.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import require_smem
from .eo import (BitsFn, _check_args, eo_chunk_reference, key_bins,
                 launch_args)
from ..models.pspin import flip_cavity

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0


def eo_pspin_chunk(sigma, c, E, emin, smin, itmin, A, cdf, *, n_moves: int,
                   seed: int, move0: int = 0, chain0: int = 0,
                   bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place: the contract of
    ops/eo.py::eo_sparse_chunk, with the cavity sums c [B, N] int32 in the
    place of lf and the partner table A [N, K, 2] int32 in the place of
    neigh/J. The keys sigma_i c_i lie in [-K, K]: the kernel counts them in
    2K + 1 histogram bins."""
    global LAUNCHES
    B, N = sigma.shape
    K = A.shape[1]
    _check_args(sigma, c, E, emin, smin, itmin, cdf,
                {"A": (A, (N, K, 2), torch.int32)})
    if c.dtype != torch.int32:
        raise ValueError(f"c: expected torch.int32, got {c.dtype}")
    if sigma.device.type == "cpu":
        return eo_pspin_chunk_reference(
            sigma, c, E, emin, smin, itmin, A, cdf, n_moves=n_moves,
            seed=seed, move0=move0, chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no EO kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    dev = sigma.device
    nbins = key_bins(K, "PSpin3")
    require_smem(lib.rrrmc_eo_sparse_smem(N, nbins),
                 lib.rrrmc_eo_sparse_max_smem(dev.index or 0), N,
                 "PSpin3 EO")
    with torch.cuda.device(dev):
        err = lib.rrrmc_eo_pspin(
            *launch_args(sigma, c, E, emin, smin, itmin), A.data_ptr(),
            cdf.data_ptr(), N, 2 * K, B, n_moves, seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, nbins,
            torch.cuda.current_stream().cuda_stream)
    check(err, "eo_pspin launch")
    LAUNCHES += 1


def eo_pspin_chunk_reference(sigma, c, E, emin, smin, itmin, A, cdf, *,
                             n_moves: int, seed: int, move0: int = 0,
                             chain0: int = 0,
                             bits: Optional[BitsFn] = None):
    """Plain torch version of the PSpin3 EO kernel (same arguments and
    in-place contract as `eo_pspin_chunk`)."""
    do = torch.ones(sigma.shape[0], dtype=torch.bool, device=sigma.device)

    def flip_fields(sig, c, win, d):
        flip_cavity(A, sig, c, win, d, do)

    eo_chunk_reference(sigma, c, E, emin, smin, itmin, cdf, flip_fields,
                       n_moves=n_moves, seed=seed, move0=move0,
                       chain0=chain0, bits=bits)
