"""Checkerboard Metropolis sweeps on an even-L integer LatticeEA: the CUDA
kernel (csrc/sweep.cu), its plain torch version, and the `Sweeper` runner.

Source note. The kernel replaces rrrmc_tpu/ops/sweep_pallas.py::_sweep_kernel
(called by `_pallas_sweep`). On the H100 it is bound by ALU work, not bytes:
per attempted flip a few integer divisions for the periodic neighbour
indices, a quarter of a Philox call and six coupling reads that hit L1/L2.
The design keeps each chain's spins resident in shared memory for all
n_sweeps (one thread block per chain; N bytes, 4 KB at L=16, D=3), so global
memory sees one read and one write of sigma per launch, and draws its bits
from a counter-based Philox in place of the TPU's hardware generator. It does
not copy the TPU layout (chains on lanes, sublane rolls with wrap masks):
neighbours are addressed directly.

Contract (the JAX kernel's): sigma [B, N] int8 and E [B] int32 advance by
n_sweeps sweeps; a sweep updates the even-parity sites, then the odd ones;
the move at site i is accepted iff half = sigma_i*lf_i <= 0 or bits < th,
th from the int32 `accept_thresholds` table when max_half <= 64, else
clip(exp(-beta2s*half)*2^32 - 2^31, -2^31, 2147483520). E gains the summed
2*half of the accepted moves in int32. Random bits: ops/prng.py::sweep_bits,
with sweeps numbered from `sweep0`, so a run split into launches draws the
bits of one launch of all its sweeps.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import check_args, prng
from ..core.dtypes import is_integer
from ..models.lattice import LatticeEA, parity

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0
#: the threshold table is used when every |half| is at most this
TABLE_MAX = 64

BitsFn = Callable[[int, int], torch.Tensor]


def dir_tables(model):
    """(Jp [N, D] or [N, D + 1], Jm [N, D]) int32 numpy tables:
    Jp[:, d] = Jd[d] is the coupling of the edge i -> i + e_d,
    Jm[:, d] = roll(Jd[d], 1, axis=d) that of i - e_d -> i; the field h is
    appended to Jp as column D when any field is non-zero."""
    Jd = model.Jd.cpu().numpy()
    n, D = model.N, model.D
    Jp = np.empty((n, D), dtype=np.int32)
    Jm = np.empty((n, D), dtype=np.int32)
    for d in range(D):
        Jp[:, d] = Jd[d].reshape(n)
        Jm[:, d] = np.roll(Jd[d], 1, axis=d).reshape(n)
    h = model.h.cpu().numpy().astype(np.int32).reshape(n, 1)
    if np.any(h):
        Jp = np.concatenate([Jp, h], axis=1)
    return Jp, Jm


def max_half(Jp: np.ndarray, Jm: np.ndarray) -> int:
    """The largest |sigma*lf| of any site: the sum of |Jp| + |Jm| (the h
    column included) per site."""
    return int((np.abs(Jp).sum(axis=1) + np.abs(Jm).sum(axis=1)).max())


def accept_thresholds(beta2s: float, n: int) -> np.ndarray:
    """int32 thresholds th[v - 1] for half = v in 1..n, computed in float64:
    accept iff bits < th with bits ~ U(int32), i.e. with probability
    e^(-beta2s*v)."""
    v = np.arange(1, n + 1, dtype=np.float64)
    p = np.exp(-float(beta2s) * v)
    return np.clip(p * 4294967296.0 - 2147483648.0,
                   -2147483648.0, 2147483520.0).astype(np.int32)


def _check_args(sigma, E, Jp, Jm, th, L, D):
    B, N = sigma.shape
    if L % 2 or L <= 2 or N != L ** D:
        raise ValueError(f"the checkerboard sweep needs an even L > 2 and "
                         f"N = L^D, got L={L}, D={D}, N={N}")
    DP = Jp.shape[1]
    if DP not in (D, D + 1):
        raise ValueError(f"Jp must have D or D + 1 columns, got {DP}")
    want = {"sigma": (sigma, (B, N), torch.int8),
            "E": (E, (B,), torch.int32),
            "Jp": (Jp, (N, DP), torch.int32), "Jm": (Jm, (N, D), torch.int32),
            "th": (th, (th.shape[0],), torch.int32)}
    check_args(want, sigma.device)


def sweep_chunk(sigma, E, Jp, Jm, th, *, L: int, D: int, n_sweeps: int,
                beta2s: float, seed: int, sweep0: int = 0, chain0: int = 0,
                bits: Optional[BitsFn] = None) -> None:
    """Advance every chain by `n_sweeps` checkerboard sweeps, in place on
    sigma [B, N] int8 and E [B] int32. Jp / Jm are the `dir_tables` (a field
    column in Jp when it has D + 1 columns); th [max_half] int32 holds the
    `accept_thresholds`, and an empty th selects the exp path.
    beta2s = 2 * beta * model.scale.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version. `bits` (sweep, colour) -> [B, N] int32 replaces the
    generator and is taken by the plain version only."""
    global LAUNCHES
    _check_args(sigma, E, Jp, Jm, th, L, D)
    if sigma.device.type == "cpu":
        sweep_chunk_reference(sigma, E, Jp, Jm, th, L=L, D=D,
                              n_sweeps=n_sweeps, beta2s=beta2s, seed=seed,
                              sweep0=sweep0, chain0=chain0, bits=bits)
        return
    if sigma.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    B, N = sigma.shape
    n_th = th.shape[0]
    smem = lib.rrrmc_sweep_smem(N, n_th)
    cap = lib.rrrmc_sweep_max_smem(sigma.device.index or 0)
    if smem > cap:
        raise NotImplementedError(
            f"the sweep kernel keeps a chain's spins in shared memory: "
            f"N={N} needs {smem} bytes, a block may have {cap}")
    with torch.cuda.device(sigma.device):
        err = lib.rrrmc_sweep(
            sigma.data_ptr(), E.data_ptr(), Jp.data_ptr(), Jm.data_ptr(),
            th.data_ptr(), L, D, B, n_th, int(Jp.shape[1] == D + 1),
            n_sweeps, seed & 0xFFFFFFFF, sweep0 & 0xFFFFFFFF,
            chain0 & 0xFFFFFFFF, beta2s,
            torch.cuda.current_stream().cuda_stream)
    check(err, "sweep launch")
    LAUNCHES += 1


def sweep_chunk_reference(sigma, E, Jp, Jm, th, *, L: int, D: int,
                          n_sweeps: int, beta2s: float, seed: int,
                          sweep0: int = 0, chain0: int = 0,
                          bits: Optional[BitsFn] = None) -> None:
    """Plain torch version of the sweep kernel, one colour step at a time
    over [B, N] tensors (same arguments and in-place contract as
    `sweep_chunk`)."""
    B, N = sigma.shape
    dev = sigma.device
    lat = (B,) + (L,) * D
    even = torch.as_tensor(parity(L, D) == 0, device=dev)
    jp = [Jp[:, d].reshape((L,) * D) for d in range(D)]
    jm = [Jm[:, d].reshape((L,) * D) for d in range(D)]
    h = Jp[:, D] if Jp.shape[1] == D + 1 else None
    beta = torch.tensor(beta2s, dtype=torch.float32, device=dev)
    n_th = th.shape[0]
    s = sigma.to(torch.int32)
    dE = torch.zeros(B, dtype=torch.int32, device=dev)
    for sw in range(sweep0, sweep0 + n_sweeps):
        for colour, mask in ((0, even), (1, ~even)):
            sv = s.view(lat)
            lf = None
            for d in range(D):
                t = (jp[d] * torch.roll(sv, -1, d + 1)
                     + jm[d] * torch.roll(sv, 1, d + 1))
                lf = t if lf is None else lf + t
            lf = lf.reshape(B, N)
            if h is not None:
                lf = lf + h
            half = s * lf
            if n_th:
                thresh = th[(half.clamp(1, n_th) - 1).long()]
            else:
                p = torch.exp(-beta * half.to(torch.float32))
                thresh = (p * 4294967296.0 - 2147483648.0).clamp(
                    -2147483648.0, 2147483520.0).to(torch.int32)
            rb = (bits(sw, colour) if bits is not None else
                  prng.sweep_bits(seed, chain0, B, N, sw, colour, dev))
            acc = mask & ((half <= 0) | (rb < thresh))
            s = torch.where(acc, -s, s)
            dE += 2 * torch.where(acc, half, 0).sum(dim=1, dtype=torch.int32)
    sigma.copy_(s.to(torch.int8))
    E += dE


class Sweeper:
    """Reusable checkerboard runner for an even-L integer LatticeEA (fields
    allowed): builds the direction tables and the threshold table once on
    the model's device (the JAX package's PallasSweeper)."""

    def __init__(self, model, beta: float):
        if not sweep_eligible(model):
            raise ValueError(
                f"the checkerboard sweep needs a LatticeEA with integer "
                f"couplings and fields and an even L, got "
                f"{type(model).__name__}"
                + (f" L={model.L}" if isinstance(model, LatticeEA) else ""))
        dev = model.device
        Jp, Jm = dir_tables(model)
        mh = max_half(Jp, Jm)
        self.table = 0 < mh <= TABLE_MAX
        self.beta2s = 2.0 * float(beta) * model.scale
        self.Jp = torch.as_tensor(Jp, device=dev)
        self.Jm = torch.as_tensor(Jm, device=dev)
        self.th = torch.as_tensor(
            accept_thresholds(self.beta2s, mh if self.table else 0),
            device=dev)
        self.L, self.D = model.L, model.D

    def __call__(self, sigma, E, *, seed: int, n_sweeps: int,
                 sweep0: int = 0, chain0: int = 0,
                 bits: Optional[BitsFn] = None) -> None:
        """Advance sigma [B, N] int8 / E [B] int32 by n_sweeps sweeps, in
        place (sweeps numbered from sweep0 in the Philox stream)."""
        sweep_chunk(sigma, E, self.Jp, self.Jm, self.th, L=self.L, D=self.D,
                    n_sweeps=n_sweeps, beta2s=self.beta2s, seed=seed,
                    sweep0=sweep0, chain0=chain0, bits=bits)


def sweep_eligible(model) -> bool:
    """A LatticeEA with integer couplings and fields and an even L: the
    models the checkerboard kernel takes."""
    return (isinstance(model, LatticeEA) and is_integer(model.Jd)
            and is_integer(model.h) and model.L % 2 == 0)
