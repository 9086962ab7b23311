"""tau-extremal optimisation (EO) moves on FullyConnected models: the CUDA
kernel (csrc/eo_dense.cu), its launch plan and its plain torch version.

Source note. The kernel replaces the dense branch of
rrrmc_tpu/ops/eo_pallas.py::_eo_kernel (`_pallas_eo_run` with dense=True:
J resident in VMEM, integer N <= 4096, float N <= 2048) and that file's
_eo_stream_kernel (`_pallas_eo_stream_run`: J streamed from HBM, integer
N <= 32768, float N <= 16384). The TPU split them by VMEM size and
recomputed lf = J sigma every move; on the H100 J is read from device memory
or L2 at every N, so one kernel serves both. It runs the move loop of
csrc/eo_chain.cuh, the sparse EO kernel's (ops/eo.py): W warps a chain by
ops/eo.py::eo_plan with at most DENSE_SITES_PER_LANE sites a lane, each
chain's keys half = sigma lf resident in the type the bound on |half|
allows (ops/eo.py::key_type: int8 on the densified +-J RRG, int16 on
GraphSK(1024), with exact histogram bins; int32 or float32 with coarse
bins), its spins and best spins as bits, the ranks drawn ahead, the warp-
level select and the packed tie race. A flip adds the winner's row of J to
the keys: every warp of the chain reads the row as 16-byte vectors (16 int8
or 4 float32 couplings a lane), an all-zero int8 vector skipped, each
changed key moved between bins. The TPU's padding of N to a lane or window
multiple is not needed. It is bound by the winner's row of J at every
chain-move (from device memory where J is larger than L2), the tie race's
Philox calls and, on SK, whose every key moves at every move, the N bin
moves.

The move is the sparse EO kernel's (ops/eo.py): the same rank draw, select,
tie race, streams and outputs. Integer J (|J| <= 127, read as int8) keeps
exact int32 local fields and energies; float J is float32, each move adding
its row of J to lf (one rounding per site and move, where the TPU kernels
recomputed lf).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import launch
from .eo import (COARSE_BINS, DENSE_SITES_PER_LANE, KEY_CODES, BitsFn,
                 _check_args, coarse_map, eo_chunk_reference, hist_bins,
                 key_type, launch_args, planned)
from ..core.dtypes import is_integer
from ..utils.profiling import spanned



def dense_select(integer: bool, half_max: Optional[int]):
    """(key type, bins) of the dense EO kernel: ops/eo.py::key_type's
    resident type, 2 half_max + 1 exact bins for int8 and int16 keys, else
    COARSE_BINS coarse ones."""
    key = key_type(integer, half_max)
    return key, (hist_bins(True, half_max) if KEY_CODES[key] < 2
                 else COARSE_BINS)


@spanned("rrrmc.op.eo_dense")
def eo_dense_chunk(sigma, lf, E, emin, smin, itmin, J, cdf, *, n_moves: int,
                   seed: int, half_max: Optional[int] = None, move0: int = 0,
                   chain0: int = 0, bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place: the contract of
    ops/eo.py::eo_sparse_chunk with the dense couplings J [N, N] (int8 with
    int32 lf and E, or float32 throughout; see
    ops/rejfree_dense.py::kernel_couplings) in place of the neighbour
    tables.

    On a CUDA tensor this launches the kernel with the plan of
    ops/eo.py::eo_plan (launch.PLANS["eo_dense"]); on a CPU tensor it
    runs the plain
    version. `bits` (move, draw) replaces the generator and is taken
    by the plain version only."""
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
    from .cuda_build import library

    lib = library()
    key, nb = dense_select(integer, half_max)
    code = KEY_CODES[key]
    plan = planned("eo_dense", "rrrmc_eo_dense_info", (code,),
                   lambda w: lib.rrrmc_eo_dense_smem(N, code, nb, w), N, B,
                   key, nb, sigma.device, label="dense EO",
                   sites_per_lane=DENSE_SITES_PER_LANE)
    # the coarse bins span |lf| of the start, not J's row sums: a dense
    # row's |J| sum is some sqrt(N) times the fields' spread, and would
    # crowd the keys into a few bins
    lo, scale = (coarse_map(key, nb, half_max, None, lf)
                 if plan["select"] == "coarse" else (0.0, 0.0))
    with torch.cuda.device(sigma.device):
        err = lib.rrrmc_eo_dense(
            *launch_args(sigma, lf, E, emin, smin, itmin), J.data_ptr(),
            cdf.data_ptr(), N, B, n_moves, seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, code, nb, lo, scale,
            plan["warps"], torch.cuda.current_stream().cuda_stream)
    launch.launched("eo_dense", err)


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
