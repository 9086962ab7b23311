"""Rejection-free race moves (bkl / wtm / rrr) on FullyConnected models: the
CUDA kernel (csrc/rejfree_dense.cu), its plain torch version, and the
eligibility rule.

Source note. The kernel replaces
rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_dense_kernel (launched by
`_pallas_rejfree_dense_chunk`) and ::_rejfree_stream_kernel (launched by
`_pallas_rejfree_stream_chunk`). The TPU split them by whether J fits VMEM
and recomputed lf = J sigma every move, since Mosaic cannot address a row
per lane; on the H100 J is read from device memory or L2 in both cases, and
each chain keeps its spins and local fields resident in shared memory (5
bytes a site: 160 KB at N=32768 for integer J) while a flip adds the
winner's row of J, O(N) per move. It is bound by the arithmetic of the
passes over the resident sites, as the sparse kernel (ops/rejfree.py), plus
one row of J per applied flip. The TPU's padding of N to a lane or window
multiple is not needed: every site takes part in the race and in z.

The move is the sparse kernel's (ops/rejfree.py): the same race, the same
shifted log-sum-exp z in the same order of additions, the same Philox
streams and the same outputs. Integer J (|J| <= 127, read as int8, row sums
of |J| below 2^24) keeps exact int32 local fields and energies; float J is
float32, each applied move adding its row of J to lf (one rounding per site
and move, where the TPU kernels recomputed lf).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import check_args
from .rejfree import (MODES, BitsFn, coord_dtype, race_chunk_reference)
from ..core.dtypes import is_integer

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0


def dense_rejfree_ok(model) -> bool:
    """Eligibility of a model for the dense race kernel (the JAX package's
    `_dense_rejfree_ok` without its VMEM size caps: the shared-memory limit
    is checked at launch): a FullyConnected model with N >= 8 and either
    integer couplings |J| <= 127 with row sums of |J| below 2^24 and integer
    fields, or finite float couplings and fields."""
    from ..models.dense import FullyConnected

    if not (isinstance(model, FullyConnected) and model.N >= 8):
        return False
    if is_integer(model.J):
        return (is_integer(model.h) and model.j_max <= 127
                and model.half_max < (1 << 24))
    return bool(torch.isfinite(model.J).all() and torch.isfinite(model.h).all())


def kernel_couplings(model) -> torch.Tensor:
    """The couplings as the kernel reads them: int8 for integer J, float32
    otherwise (a no-op when the model already stores them so)."""
    dt = torch.int8 if is_integer(model.J) else torch.float32
    return model.J.to(dt).contiguous()


def _check_args(sigma, lf, E, coord, acc, zacc, J, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    B, N = sigma.shape
    integer = is_integer(J)
    dt = torch.int32 if integer else torch.float32
    want = {"sigma": (sigma, (B, N), torch.int8), "lf": (lf, (B, N), dt),
            "E": (E, (B,), dt), "coord": (coord, (B,), coord_dtype(mode)),
            "acc": (acc, (B,), torch.int32),
            "zacc": (zacc, (B,), torch.float32),
            "J": (J, (N, N), torch.int8 if integer else torch.float32)}
    check_args(want, sigma.device)


def rejfree_dense_chunk(sigma, lf, E, coord, acc, zacc, J, *, mode: str,
                        n_moves: int, beta2s: float, target, seed: int,
                        move0: int = 0, chain0: int = 0,
                        bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` race moves, in place: the contract
    of ops/rejfree.py::rejfree_sparse_chunk with the dense couplings J
    [N, N] (int8 with int32 lf and E, or float32 throughout; see
    `kernel_couplings`) in place of the neighbour tables. Returns the
    per-move streams (cs, es), each [n_moves, B].

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version. `bits` (move, draw) replaces the generator and is taken
    by the plain version only."""
    global LAUNCHES
    _check_args(sigma, lf, E, coord, acc, zacc, J, mode)
    if sigma.device.type == "cpu":
        return rejfree_dense_chunk_reference(
            sigma, lf, E, coord, acc, zacc, J, mode=mode, n_moves=n_moves,
            beta2s=beta2s, target=target, seed=seed, move0=move0,
            chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no race kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    B, N = sigma.shape
    dev = sigma.device
    smem = lib.rrrmc_rejfree_dense_smem(N)
    cap = lib.rrrmc_rejfree_dense_max_smem(dev.index or 0)
    if smem > cap:
        raise NotImplementedError(
            f"the dense race kernel keeps a chain's spins and local fields in "
            f"shared memory: N={N} needs {smem} bytes, a block may have {cap}")
    ct = coord_dtype(mode)
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=lf.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_dense(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            J.data_ptr(), N, B, n_moves, seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, beta2s,
            int(target) if ct == torch.int32 else 0, float(target),
            MODES[mode], 0 if is_integer(J) else 1,
            torch.cuda.current_stream().cuda_stream)
    check(err, "rejfree_dense launch")
    LAUNCHES += 1
    return cs, es


def rejfree_dense_chunk_reference(sigma, lf, E, coord, acc, zacc, J, *,
                                  mode: str, n_moves: int, beta2s: float,
                                  target, seed: int, move0: int = 0,
                                  chain0: int = 0,
                                  bits: Optional[BitsFn] = None):
    """Plain torch version of the dense race kernel (same arguments,
    in-place contract and streams as `rejfree_dense_chunk`): the sparse
    kernel's plain moves with the winner's row of J added to lf."""

    def lf_flipped(lf, win, d, do):
        """lf + d * J[win] in the chains where do, else lf."""
        return torch.where(do[:, None], lf + d[:, None] * J[win].to(lf.dtype),
                           lf)

    return race_chunk_reference(
        sigma, lf, E, coord, acc, zacc, lf_flipped, mode=mode,
        n_moves=n_moves, beta2s=beta2s, target=target, seed=seed,
        move0=move0, chain0=chain0, bits=bits)
