"""Checkerboard Metropolis sweeps on an even-L integer LatticeEA: the CUDA
kernel (csrc/sweep.cu), its launch plan, its plain torch version, and the
`Sweeper` runner.

Source note. The kernel replaces rrrmc_tpu/ops/sweep_pallas.py::_sweep_kernel
(called by `_pallas_sweep`). On the H100 it is bound by operations, not
bytes: per attempted flip a quarter of a Philox call, the 2D neighbour
products, the threshold and the compare. The design keeps the spins of a
block of C chains resident in shared memory for all n_sweeps, interleaved
by chain ([N][C] bytes), and runs the C chains in step: the lanes of a site
take its C chains, four a lane where the couplings allow it (`swar_ok`:
one 4-byte load of a neighbour's spins and one product-add serve four
chains) or one, so each load of the site's row (its neighbours, couplings
and field, `site_rows`, built once a launch with no division left for the
sweep loop) serves all of them. D = 2 and 3 take the row into registers
with D a constant; any other D reads it entry by entry. `sweep_plan`
picks C and the lane layout from the chains and the card; global memory
sees one read and one write of sigma per launch, and the last launch of a
call one write of the local fields. Random bits come from a
counter-based Philox in place of the TPU's hardware generator. It does not
copy the TPU layout (chains on lanes, sublane rolls with wrap masks):
neighbours are addressed directly.

Contract (the JAX kernel's): sigma [B, N] int8 and E [B] int32 advance by
n_sweeps sweeps; a sweep updates the even-parity sites, then the odd ones;
the move at site i is accepted iff half = sigma_i*lf_i <= 0 or bits < th,
th from the int32 `accept_thresholds` table when max_half <= 64, else
clip(exp(-beta2s*half)*2^32 - 2^31, -2^31, 2147483520). E gains the summed
2*half of the accepted moves in int32. Random bits: ops/prng.py::sweep_bits,
with sweeps numbered from `sweep0`, so a run split into launches draws the
bits of one launch of all its sweeps. Given `aux` [B, N] int32, a launch
also writes the final spins' local fields h + sum J s into it (the kernel's
epilogue, from the spins still in shared memory), the model's
`local_fields` bit for bit; sigma and E do not depend on it.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import check_args, launch, prng
from ..core.dtypes import is_integer
from ..models.lattice import LatticeEA, parity
from ..utils.profiling import spanned

#: the threshold table is used when every |half| is at most this
TABLE_MAX = 64
#: the largest sum of |J| around a site that the four-chains-a-lane kernel
#: takes (csrc/sweep.cu kSwar)
SWAR_MAX = 127
#: chains a block the plan may take (lanes per site: a power of two)
CHAIN_CHOICES = (32, 16, 8, 4, 2, 1)
#: the plan takes the largest C whose busiest SM holds at most this many
#: times the fewest chains any C gives it
LOAD_SLACK = 1.1
#: threads a block (at most csrc/sweep.cu kMaxThreads)
THREADS = 1024

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


def row_len(D: int) -> int:
    """Ints of a row of `site_rows` (csrc/sweep.cu row_len): the site, 2D
    neighbours, their 2D couplings and two constants, padded to 16
    bytes."""
    return -(-(4 * D + 3) // 4) * 4


@functools.lru_cache(maxsize=8)
def neighbour_table(L: int, D: int) -> np.ndarray:
    """[2, N/2, 1 + 2D] int32: for colour c and pair k (sites 2k and 2k + 1,
    one of each colour on an even-L lattice), the site i of colour c and
    its periodic neighbours i + e_0, i - e_0, i + e_1, ... (row-major sites,
    e_d along array axis d, the last axis of stride 1)."""
    n = L ** D
    idx = np.arange(n).reshape((L,) * D)
    nb = [np.roll(idx, -sh, axis=d).reshape(n)
          for d in range(D) for sh in (1, -1)]
    even = 2 * np.arange(n // 2)
    par = parity(L, D)
    out = np.empty((2, n // 2, 1 + 2 * D), dtype=np.int32)
    for c in (0, 1):
        site = even + (par[even] != c)
        out[c, :, 0] = site
        for j, t in enumerate(nb):
            out[c, :, 1 + j] = t[site]
    return out


class SiteRows(NamedTuple):
    """The kernel's rows (`site_rows`) and the lane layout they are built
    for: `swar` True for four chains a lane, False for one."""
    data: torch.Tensor
    swar: bool


def site_rows(Jp: torch.Tensor, Jm: torch.Tensor, L: int, D: int,
              swar: bool = False) -> SiteRows:
    """The kernel's rows, data [2, N/2, row_len(D)] int32 on Jp's device:
    per colour and pair the `neighbour_table` row, then the couplings of
    the 2D edges in its order (Jp[i, d] toward i + e_d, Jm[i, d] from
    i - e_d), then two constants, then zeros: h (Jp's column D, 0 without
    one) and 0; or, for the four-chains-a-lane kernel (`swar`, where
    `swar_ok`), A = h + sum J + 2K and K * 0x01010101 with K = sum |J|."""
    tab = torch.as_tensor(neighbour_table(L, D), device=Jp.device)
    site = tab[..., 0].long()
    J = torch.stack([Jp[site, d] if sh == 0 else Jm[site, d]
                     for d in range(D) for sh in (0, 1)], dim=-1)
    h = (Jp[site, D] if Jp.shape[1] == D + 1 else
         torch.zeros_like(site, dtype=torch.int32))
    last = torch.zeros_like(h)
    if swar:
        K = J.abs().sum(-1, dtype=torch.int32)
        h = h + J.sum(-1, dtype=torch.int32) + 2 * K
        last = K * 0x01010101
    pad = torch.zeros(site.shape + (row_len(D) - 3 - 4 * D,),
                      dtype=torch.int32, device=Jp.device)
    return SiteRows(torch.cat([tab, J, h[..., None], last[..., None], pad],
                              dim=-1).contiguous(), swar)


def swar_ok(Jp: np.ndarray, Jm: np.ndarray, D: int) -> bool:
    """Whether the four-chains-a-lane kernel takes these direction tables:
    every site's sum of |J| over its 2D edges at most SWAR_MAX, so that
    each chain's byte of the packed sum stays in [0, 255]."""
    K = np.abs(Jp[:, :D]).sum(axis=1) + np.abs(Jm).sum(axis=1)
    return int(K.max(initial=0)) <= SWAR_MAX


def _chain_load(B: int, C: int, n_sm: int) -> int:
    """The most chains one SM holds over the launch: the blocks a SM, at
    most, times the chains of a block."""
    return -(-(-(-B // C)) // n_sm) * min(C, B)


def site_bytes(C: int) -> int:
    """Shared bytes a site of a block of C chains: the C spins, and from 4
    chains 4 spare bytes that spread a warp's sites over the banks
    (csrc/sweep.cu)."""
    return C + 4 if C >= 4 else C


def sweep_plan(N: int, B: int, n_th: int, n_sm: int, info: Callable,
               swar: bool = False) -> dict:
    """The launch plan of B chains of N sites with an n_th-entry threshold
    table. info(T, smem, swar) gives the instantiation's [blocks per SM,
    registers, local bytes, static shared bytes, most dynamic shared bytes]
    at T threads and `smem` dynamic bytes. With `swar` (couplings that
    allow it, `swar_ok`) the lanes take four chains each where a block of
    at least 4 chains fits, else one. C, the chains a block, is the
    largest of CHAIN_CHOICES (each site's row then serves the most chains)
    whose blocks leave at most LOAD_SLACK times the fewest chains any C
    leaves on the busiest SM. A block holds n_th int32 thresholds and
    N * site_bytes(C) spin bytes."""
    T = THREADS
    for four in ((True, False) if swar else (False,)):
        choices = [c for c in CHAIN_CHOICES if c >= 4 or not four]
        need = {c: n_th * 4 + N * site_bytes(c) for c in choices}
        facts = {c: info(T, need[c], four) for c in choices}
        fits = [c for c in choices
                if need[c] <= facts[c][4] and facts[c][0] > 0]
        if fits:
            break
    else:
        launch.require_smem(min(need.values()), facts[choices[-1]][4], N,
                            "sweep")
        raise NotImplementedError(f"sweep: no block fits ({facts})")
    least = min(_chain_load(B, c, n_sm) for c in fits)
    C = max(c for c in fits if _chain_load(B, c, n_sm) <= LOAD_SLACK * least)
    f = facts[C]
    return {"chains": C, "threads": T, "smem": need[C],
            "lanes": "4 chains" if four else "1 chain", "swar": four,
            "blocks": -(-B // C), "blocks_per_sm": f[0], "registers": f[1],
            "spill_bytes": f[2]}


def _check_args(sigma, E, Jp, Jm, th, L, D, aux):
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
    if aux is not None:
        want["aux"] = (aux, (B, N), torch.int32)
    check_args(want, sigma.device)


@spanned("rrrmc.op.sweep")
def sweep_chunk(sigma, E, Jp, Jm, th, *, L: int, D: int, n_sweeps: int,
                beta2s: float, seed: int, sweep0: int = 0, chain0: int = 0,
                bits: Optional[BitsFn] = None,
                rows: Optional[SiteRows] = None,
                aux: Optional[torch.Tensor] = None) -> None:
    """Advance every chain by `n_sweeps` checkerboard sweeps, in place on
    sigma [B, N] int8 and E [B] int32. Jp / Jm are the `dir_tables` (a field
    column in Jp when it has D + 1 columns); th [max_half] int32 holds the
    `accept_thresholds`, and an empty th selects the exp path.
    beta2s = 2 * beta * model.scale.

    On a CUDA tensor this launches the kernel (`sweep_plan`,
    launch.PLANS["sweep"])
    on `rows`, these tables' `site_rows` in either lane layout (built
    here, for one chain a lane, when not given); on a CPU tensor it runs
    the plain version. `bits` (sweep, colour) -> [B, N]
    int32 replaces the generator and is taken by the plain version only.
    `aux` [B, N] int32, when given, receives the final spins' local
    fields."""
    _check_args(sigma, E, Jp, Jm, th, L, D, aux)
    if sigma.device.type == "cpu":
        sweep_chunk_reference(sigma, E, Jp, Jm, th, L=L, D=D,
                              n_sweeps=n_sweeps, beta2s=beta2s, seed=seed,
                              sweep0=sweep0, chain0=chain0, bits=bits,
                              aux=aux)
        return
    if sigma.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import library

    lib = library()
    B, N = sigma.shape
    dev = sigma.device
    n_th = th.shape[0]
    if rows is None:
        rows = site_rows(Jp, Jm, L, D)
    check_args({"rows": (rows.data, (2, N // 2, row_len(D)), torch.int32)},
               dev)

    dev_i = dev.index or 0
    plan = launch.record("sweep", sweep_plan(
        N, B, n_th, launch.sm_count(dev_i),
        lambda T, smem, four: launch.facts(
            "rrrmc_sweep_info", (D, int(n_th > 0), int(four)), T, smem,
            dev_i), rows.swar))
    if plan["swar"] != rows.swar:  # four chains a lane do not fit
        rows = site_rows(Jp, Jm, L, D)
    with torch.cuda.device(dev):
        err = lib.rrrmc_sweep(
            sigma.data_ptr(), E.data_ptr(), rows.data.data_ptr(),
            th.data_ptr(), None if aux is None else aux.data_ptr(),
            L, D, B, n_th, int(plan["swar"]), plan["chains"].bit_length() - 1,
            plan["threads"], n_sweeps,
            seed & 0xFFFFFFFF, sweep0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            beta2s, torch.cuda.current_stream().cuda_stream)
    launch.launched("sweep", err)


def sweep_chunk_reference(sigma, E, Jp, Jm, th, *, L: int, D: int,
                          n_sweeps: int, beta2s: float, seed: int,
                          sweep0: int = 0, chain0: int = 0,
                          bits: Optional[BitsFn] = None,
                          aux: Optional[torch.Tensor] = None) -> None:
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

    def fields(s):
        sv = s.view(lat)
        lf = None
        for d in range(D):
            t = (jp[d] * torch.roll(sv, -1, d + 1)
                 + jm[d] * torch.roll(sv, 1, d + 1))
            lf = t if lf is None else lf + t
        lf = lf.reshape(B, N)
        return lf if h is None else lf + h

    for sw in range(sweep0, sweep0 + n_sweeps):
        for colour, mask in ((0, even), (1, ~even)):
            half = s * fields(s)
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
    if aux is not None:
        aux.copy_(fields(s))


class Sweeper:
    """Reusable checkerboard runner for an even-L integer LatticeEA (fields
    allowed): builds the direction tables, the threshold table and the
    kernel's rows once on the model's device (the JAX package's
    PallasSweeper)."""

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
        self.rows = site_rows(self.Jp, self.Jm, self.L, self.D,
                              swar_ok(Jp, Jm, self.D))

    def __call__(self, sigma, E, *, seed: int, n_sweeps: int,
                 sweep0: int = 0, chain0: int = 0,
                 bits: Optional[BitsFn] = None,
                 aux: Optional[torch.Tensor] = None) -> None:
        """Advance sigma [B, N] int8 / E [B] int32 by n_sweeps sweeps, in
        place (sweeps numbered from sweep0 in the Philox stream); `aux`
        [B, N] int32, when given, receives the final local fields."""
        sweep_chunk(sigma, E, self.Jp, self.Jm, self.th, L=self.L, D=self.D,
                    n_sweeps=n_sweeps, beta2s=self.beta2s, seed=seed,
                    sweep0=sweep0, chain0=chain0, bits=bits, rows=self.rows,
                    aux=aux)


def sweep_eligible(model) -> bool:
    """A LatticeEA with integer couplings and fields and an even L: the
    models the checkerboard kernel takes."""
    return (isinstance(model, LatticeEA) and is_integer(model.Jd)
            and is_integer(model.h) and model.L % 2 == 0)
