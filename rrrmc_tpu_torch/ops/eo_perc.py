"""tau-EO moves on the binary perceptrons: the CUDA kernel's wrapper
(csrc/eo_perc.cu, with csrc/perc.cuh and csrc/eo_group.cuh), its launch
plan and its plain torch version. ops/perc.py's source note describes the
design and holds the eligibility rule.

Source note. Replaces rrrmc_tpu/ops/perc_pallas.py::_eo_perc_kernel: the
EO select ranking the sites by dE itself (eo.cuh's key policy without the
spin factor), recomputed from the stabilities at every move as the race
kernel computes it, from the same pattern bits xb (ops/perc.py::
pack_patterns): in shared memory where they fit beside the state, else in
global memory (the plan's "patterns"). Step and linear give integer keys
with |dE| <= P (a flip moves each pattern's loss by at most one), counted
in a histogram of 2 P + 1 bins in the same pass that computes dE, and
raced among the groups of four sites that hold a member by every warp at
once; above HIST_MAX bins, and for xentr's float32 keys, eo.cuh's block
radix select and tie race. The TPU kernel ranked by dE2 = 2 dE with a
binary-search order statistic; the order and the ties are the same.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import launch
from .eo import (TIE_QUEUE, BitsFn, _align16, eo_chunk_reference,
                 hist_bins)
from .perc import FAMILY_CODES, check_perc_args, de_flip, table_family
from ..utils.profiling import spanned

#: threads a chain (one block; csrc/eo.cuh kEoThreads)
THREADS = 256


def eo_perc_bytes(N: int, P: int, fam: str, nb: int, sx: bool) -> int:
    """Dynamic shared bytes of the perceptron EO kernel's block
    (csrc/eo_perc.cu layout): the pattern bits where `sx`, dE, the spins
    and best spins, the stabilities, g's state, the select's counters (two
    sets of nb bins and their super-bins, or 256 radix counters for nb =
    0), the warps' queues, slots and partial totals."""
    W = -(-P // 32)
    warps = THREADS // 32
    nsup = -(-nb // 32) if nb > 32 else 0
    return ((_align16(4 * W * N) if sx else 0) + _align16(16 * -(-N // 4))
            + 2 * _align16(N) + _align16(4 * P)
            + _align16(4 * W * (32 if fam == "xentr" else 2))
            + (2 * _align16(4 * nb) if nb else _align16(4 * 256))
            + 2 * _align16(4 * nsup) + 4 * TIE_QUEUE * warps
            + _align16(16 * warps) + _align16(8 * warps))


def eo_perc_plan(N: int, P: int, fam: str, info: Callable) -> dict:
    """The launch plan of the perceptron EO kernel: THREADS a chain, the
    select (a histogram of 2 P + 1 bins for step and linear up to HIST_MAX,
    else the radix select) and the pattern bits in shared memory where the
    block fits with them, else in global memory (none fits:
    NotImplementedError). info(sx, need) gives the instantiation's [blocks
    per SM, registers, local bytes, static shared bytes, most dynamic
    shared bytes] at `need` dynamic bytes."""
    nb = hist_bins(fam != "xentr", P)
    for sx in (True, False):
        need = eo_perc_bytes(N, P, fam, nb, sx)
        f = info(int(sx), need)
        if need <= f[4] and f[0] > 0:
            return {"threads": THREADS,
                    "patterns": "shared" if sx else "global",
                    "select": "histogram" if nb else "radix", "bins": nb,
                    "smem": need, "blocks_per_sm": f[0], "registers": f[1],
                    "spill_bytes": f[2]}
    launch.require_smem(need, f[4], N, "perceptron EO")
    raise NotImplementedError(f"perceptron EO: no block fits ({f})")


@spanned("rrrmc.op.eo_perc")
def eo_perc_chunk(sigma, delta, E, emin, smin, itmin, xi4, xiT, loss, xb,
                  cdf, *, n_moves: int, seed: int, move0: int = 0,
                  chain0: int = 0, bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place: the contract of
    ops/eo.py::eo_sparse_chunk, with the stabilities delta [B, P] int32 in
    the place of lf, E and emin int32 (float32 for xentr) and the tables of
    ops/perc.py::perc_tables in the place of neigh/J: the kernel reads the
    pattern bits xb (perc_tables builds them from the patterns xi4 holds;
    their shape and dtype are checked here), the plain version xi4 and
    xiT. The key is dE: the kernel counts integer
    keys in 2 P + 1 histogram bins when that is at most HIST_MAX, else (and
    for xentr) it takes the radix select."""
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
    from .cuda_build import library

    lib = library()
    P = xiT.shape[1]
    dev = sigma.device
    code = FAMILY_CODES[fam]
    hist = int(hist_bins(fam != "xentr", P) > 0)
    plan = eo_perc_plan(N, P, fam, lambda sx, need: launch.facts(
        "rrrmc_eo_perc_info", (code, hist, sx), THREADS, need,
        dev.index or 0))
    sx = int(plan["patterns"] == "shared")
    nbins = plan["bins"]
    if lib.rrrmc_eo_perc_smem(N, P, code, nbins, sx) != plan["smem"]:
        raise RuntimeError("eo_perc: the kernel's shared bytes differ from "
                           "the plan's")
    launch.record("eo_perc", {"kernel": "eo_perc", **plan})
    with torch.cuda.device(dev):
        err = lib.rrrmc_eo_perc(
            sigma.data_ptr(), delta.data_ptr(), E.data_ptr(),
            emin.data_ptr(), smin.data_ptr(), itmin.data_ptr(),
            xb.data_ptr(), cdf.data_ptr(), N, P, B, n_moves,
            seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            nbins, code, c, sx, torch.cuda.current_stream().cuda_stream)
    launch.launched("eo_perc", err)


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
