"""tau-extremal optimisation (EO) moves on FullyConnected models: the CUDA
kernel (csrc/eo_dense.cu) and its plain torch version.

Source note. The kernel replaces the dense branch of
rrrmc_tpu/ops/eo_pallas.py::_eo_kernel (`_pallas_eo_run` with dense=True:
J resident in VMEM, integer N <= 4096, float N <= 2048) and that file's
_eo_stream_kernel (`_pallas_eo_stream_run`: J streamed from HBM, integer
N <= 32768, float N <= 16384). The TPU split them by VMEM size and
recomputed lf = J sigma every move; on the H100 J is read from device memory
or L2 at every N, and each chain keeps its spins, local fields and best
spins resident in shared memory (6 bytes a site) while a flip adds the
winner's row of J, as the dense race kernel does (ops/rejfree_dense.py). The
TPU's padding of N to a lane or window multiple is not needed. Integer keys
of a range of at most ops/eo.py::HIST_MAX values are counted in a shared
histogram that the row update keeps up to date; float keys take the radix
select. It is bound by the passes over the N resident sites per move and one
row of J per move.

The move is the sparse EO kernel's (ops/eo.py): the same rank draw, select,
tie race, streams and outputs. Integer J (|J| <= 127, read as int8) keeps
exact int32 local fields and energies; float J is float32, each move adding
its row of J to lf (one rounding per site and move, where the TPU kernels
recomputed lf).
"""

from __future__ import annotations

from typing import Optional

import torch

from .eo import (BitsFn, _check_args, eo_chunk_reference, hist_bins,
                 launch_args)
from ..core.dtypes import is_integer

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0


def eo_dense_chunk(sigma, lf, E, emin, smin, itmin, J, cdf, *, n_moves: int,
                   seed: int, half_max: Optional[int] = None, move0: int = 0,
                   chain0: int = 0, bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place: the contract of
    ops/eo.py::eo_sparse_chunk with the dense couplings J [N, N] (int8 with
    int32 lf and E, or float32 throughout; see
    ops/rejfree_dense.py::kernel_couplings) in place of the neighbour
    tables.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version. `bits` (move, draw) replaces the generator and is taken
    by the plain version only."""
    global LAUNCHES
    B, N = sigma.shape
    integer = is_integer(J)
    jt = torch.int8 if integer else torch.float32
    _check_args(sigma, lf, E, emin, smin, itmin, cdf,
                {"J": (J, (N, N), jt)})
    if integer != is_integer(lf):
        raise ValueError(f"J is {J.dtype} but lf is {lf.dtype}")
    if sigma.device.type == "cpu":
        return eo_dense_chunk_reference(
            sigma, lf, E, emin, smin, itmin, J, cdf, n_moves=n_moves,
            seed=seed, half_max=half_max, move0=move0, chain0=chain0,
            bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no EO kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    dev = sigma.device
    nbins = hist_bins(integer, half_max)
    smem = lib.rrrmc_eo_dense_smem(N, nbins)
    cap = lib.rrrmc_eo_dense_max_smem(dev.index or 0)
    if smem > cap:
        raise NotImplementedError(
            f"the dense EO kernel keeps a chain's spins, local fields and "
            f"best spins in shared memory: N={N} needs {smem} bytes, a block "
            f"may have {cap}")
    with torch.cuda.device(dev):
        err = lib.rrrmc_eo_dense(
            *launch_args(sigma, lf, E, emin, smin, itmin), J.data_ptr(),
            cdf.data_ptr(), N, B, n_moves, seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, nbins,
            0 if integer else 1, torch.cuda.current_stream().cuda_stream)
    check(err, "eo_dense launch")
    LAUNCHES += 1


def eo_dense_chunk_reference(sigma, lf, E, emin, smin, itmin, J, cdf, *,
                             n_moves: int, seed: int,
                             half_max: Optional[int] = None, move0: int = 0,
                             chain0: int = 0, bits: Optional[BitsFn] = None):
    """Plain torch version of the dense EO kernel (same arguments and
    in-place contract as `eo_dense_chunk`): the sparse kernel's plain moves
    with the winner's row of J added to lf."""

    def flip_fields(sig, lf, win, d):
        lf += d[:, None] * J[win].to(lf.dtype)

    eo_chunk_reference(sigma, lf, E, emin, smin, itmin, cdf, flip_fields,
                       n_moves=n_moves, seed=seed, move0=move0,
                       chain0=chain0, bits=bits)
