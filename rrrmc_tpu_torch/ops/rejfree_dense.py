"""Rejection-free race moves (bkl / wtm / rrr) on FullyConnected models: the
CUDA kernel (csrc/rejfree_dense.cu), its plain torch version, and the
eligibility rule.

Source note. The kernel replaces
rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_dense_kernel (launched by
`_pallas_rejfree_dense_chunk`) and ::_rejfree_stream_kernel (launched by
`_pallas_rejfree_stream_chunk`). The TPU split them by whether J fits VMEM
and recomputed lf = J sigma every move, since Mosaic cannot address a row
per lane; on the H100 J is read from device memory or L2 in both cases, and
each chain keeps its local fields and spins resident in shared memory while
a flip adds the winner's row of J, O(N) per move. The kernel runs on the
fused race pass of the sparse kernel (csrc/race.cuh::race_moves) with its
launch rule (ops/rejfree.py::fused_plan): the block size T from the chains
and the sites a thread, the fields resident in the narrowest type the
family's bound on |lf| allows (`field_bound`, samplers/families.py: int8 on
a densified +-J RRG, int16 on GraphSK(1024), int32 above 32767 and, for
the dense race, above TABLE_MAX - 1 (`dense_field`: int8 and int16 fields
read each site's Boltzmann term from a table of the bound + 1 terms),
float32 for float J), the spins as bits, so that a site takes 1.125 to
4.125 bytes (every N of the earlier 5-byte layout, about 46 400 sites,
still fits; up to 55 000 with int32 or float32 fields at 256 threads).
rrr flips tentatively, as the sparse kernel: it saves the fields its flip
overwrites in shared memory where they fit beside the state at both block
sizes (plan "saved": "shared"), else in a global scratch row a chain
("global"), and puts them back if the flip is refused, so that every move
reads the winner's row once from device memory or L2. It is bound by the
arithmetic of the pass over the resident sites, as the sparse kernel, plus
one row of J a move. The TPU's padding of N to a lane or window multiple
is not needed: every site takes part in the race and in z.

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

from . import check_args, launch
from .rejfree import (FIELD_CODES, FUSED_THREADS, MODES, THREADS, BitsFn,
                      coord_dtype, race_chunk_reference, race_plan,
                      resident_dtype)
from ..core.dtypes import is_integer
from ..utils.profiling import spanned

#: where rrr keeps the fields its tentative flip overwrites (the kernel's
#: codes): bkl and wtm keep none
SAVED = {"none": 0, "shared": 1, "global": 2}
#: the most terms of the kernel's exp table: int8 and int16 fields read
#: expf(-2 beta_s h) for h in [0, bound] from it, so int16 fields are kept
#: only up to this bound + 1 (4096 terms, 16 KB), int32 above
TABLE_MAX = 4096


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


def dense_field(integer: bool, bound: Optional[int]) -> torch.dtype:
    """The dense race's resident field type: ops/rejfree.py's
    resident_dtype, but int32 where an int16 bound's exp table would pass
    TABLE_MAX terms."""
    field = resident_dtype(integer, bound)
    if field == torch.int16 and bound + 1 > TABLE_MAX:
        return torch.int32
    return field


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


@spanned("rrrmc.op.rejfree_dense")
def rejfree_dense_chunk(sigma, lf, E, coord, acc, zacc, J, *, mode: str,
                        n_moves: int, beta_s: float, target, seed: int,
                        move0: int = 0, chain0: int = 0,
                        bits: Optional[BitsFn] = None,
                        field_bound: Optional[int] = None):
    """Advance every chain by `n_moves` race moves, in place: the contract
    of ops/rejfree.py::rejfree_sparse_chunk with the dense couplings J
    [N, N] (int8 with int32 lf and E, or float32 throughout; see
    `kernel_couplings`) in place of the neighbour tables, and
    beta_s = beta * model.scale. `field_bound` bounds |lf| over every
    configuration (the family's half_bound; None: int32 resident fields
    for integer J). Returns the per-move streams (cs, es), each
    [n_moves, B].

    On a CUDA tensor this launches the kernel with the launch rule's block
    size (ops/rejfree.py::fused_plan); on a CPU tensor it runs the plain
    version. `bits` (move, draw) replaces the generator and is taken by the
    plain version only."""
    _check_args(sigma, lf, E, coord, acc, zacc, J, mode)
    if sigma.device.type == "cpu":
        return rejfree_dense_chunk_reference(
            sigma, lf, E, coord, acc, zacc, J, mode=mode, n_moves=n_moves,
            beta_s=beta_s, target=target, seed=seed, move0=move0,
            chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no race kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import library

    lib = library()
    B, N = sigma.shape
    dev = sigma.device
    ct = coord_dtype(mode)
    field = dense_field(is_integer(J), field_bound)
    tab_n = field_bound + 1 if field in (torch.int8, torch.int16) else 0
    dev_i = dev.index or 0
    head = (FIELD_CODES[field], int(mode == "wtm"))

    def smem(saved):
        return lib.rrrmc_rejfree_dense_smem(N, field.itemsize,
                                            SAVED[saved], tab_n)

    # rrr saves the fields its tentative flip overwrites in shared memory
    # where they fit beside the state at every block size, else in a
    # global scratch row a chain
    saved = "none"
    if mode == "rrr":
        saved = "shared" if all(
            smem("shared") <= launch.facts("rrrmc_rejfree_dense_info", head,
                                           t, 0, dev_i)[4]
            for t in FUSED_THREADS) else "global"
    T = race_plan("rejfree_dense", "rrrmc_rejfree_dense_info", head, B, N,
                  smem(saved), field, dev_i, saved=saved)["threads"]
    scratch = None
    if saved == "global":
        stride = -(-N * field.itemsize // 16) * 16
        scratch = torch.empty((B, stride), dtype=torch.uint8, device=dev)
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=lf.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_dense(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            J.data_ptr(), None if scratch is None else scratch.data_ptr(),
            N, B, n_moves, seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF,
            chain0 & 0xFFFFFFFF, 2.0 * beta_s,
            int(target) if ct == torch.int32 else 0, float(target),
            MODES[mode], T, FIELD_CODES[field], SAVED[saved], tab_n,
            torch.cuda.current_stream().cuda_stream)
    launch.launched("rejfree_dense", err)
    return cs, es


def rejfree_dense_chunk_reference(sigma, lf, E, coord, acc, zacc, J, *,
                                  mode: str, n_moves: int, beta_s: float,
                                  target, seed: int, move0: int = 0,
                                  chain0: int = 0,
                                  bits: Optional[BitsFn] = None,
                                  threads: int = THREADS):
    """Plain torch version of the dense race kernel (same arguments,
    in-place contract and streams as `rejfree_dense_chunk`; z summed as
    the kernel's fused pass sums it with `threads` threads a block): the
    sparse kernel's plain moves with the winner's row of J added to lf."""

    def lf_flipped(sig, lf, win, d, do):
        """lf + d * J[win] in the chains where do, else lf."""
        return torch.where(do[:, None], lf + d[:, None] * J[win].to(lf.dtype),
                           lf)

    return race_chunk_reference(
        sigma, lf, E, coord, acc, zacc, lf_flipped, mode=mode,
        n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
        move0=move0, chain0=chain0, bits=bits, threads=threads)
