"""Sequential Metropolis sweeps on the replica composites (GraphQuant's ring,
GraphRobustEnsemble's star) over a dense base: the CUDA kernel
(csrc/replica_sweep.cu), its plain torch version, and the `ReplicaSweeper`
runner of `sweepMC_quant`.

Source note. The kernel replaces
rrrmc_tpu/ops/quant_pallas.py::_ring_sweep_kernel (launched by
`_pallas_ring_sweep`). The TPU kernel decided windows of 128 spins inside
one replica block against f32 fields scaled by sb and committed each window
with a rank-128 matmul. Here spans never cross a replica block; a span's
Philox words and extra terms are derived once a spin, and a warp decides 32
consecutive spins of its chain at once, resuming after the first accepting
lane (exact sequential Metropolis, since every spin's bits are fixed by its
counter). An integer base keeps exact int32 fields (the TPU kept f32 ones)
and runs the dense sweep's block-synchronous scheme (ops/sk.py): a block of
BLOCK_CHAINS chains on the same span, corrections from the span's diagonal
block of J in shared memory, and at the span's end one int8 tensor-core
product commits the block's flips to the mover's block of the base fields
(J symmetric).
A float base keeps float32 fields and the plain version's sums: spans of
SPAN spins, one warp a chain, its flips committed in site order on the
CUDA cores. `sweep_plan` states the launch; csrc/replica_sweep.cu says
what bounds it.

Contract: sigma [B, N] int8 (N = Nk * M, replica-major), lf [B, N] the base
fields (ops/replica.py::replica_state; int32 for an integer base, float32
otherwise), E [B] float32 physical and acc [B] int32 advance in place by
n_sweeps sweeps of the N spins in order. Spin j = (i, k) is accepted iff
dE <= 0 or bits < th, dE ops/replica.py's identity with the fields
corrected by the span's earlier flips, th = clip(exp(-beta dE) 2^32 - 2^31)
in float32 (the TPU kernel's threshold); its bits are word j % 4 of Philox
counter (j // 4, t, DRAW_REPLICA_SWEEP, 0) in sweep t, sweeps numbered from
`sweep0`. E gains each accepted dE in site order; acc counts the flips.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import check_args, launch, prng
from .replica import ReplicaTables, replica_base, replica_tables
from .sk import (BLOCK_CHAINS, BLOCK_SPAN, check_symmetric, load_width,
                 span_stride)
from ..core.dtypes import is_integer
from ..utils.profiling import spanned

#: spins decided between two commits of a float base's fields (the
#: plain version's span, and the float kernel's: its float32 sums follow it;
#: an integer base's sums are exact, so its kernel's span, ops/sk.py's
#: BLOCK_SPAN, gives the plain version's result too)
SPAN = 512
#: chains (warps) of a float base's block
FLOAT_CHAINS = 8

#: (sweep) -> [B, N] int32 bits of one sweep, replacing the generator
SweepBitsFn = Callable[[int], torch.Tensor]


def replica_sweep_ok(model) -> bool:
    """A Quant / RE composite whose base is a FullyConnected model with
    integer |J| <= 127 (read as int8), integer fields and every |field| below
    2^24 (exact in float32), or finite float couplings and fields: the sweep
    kernel reads the base's dense rows."""
    from ..models.dense import FullyConnected
    from .sk import sk_sweep_eligible

    base = replica_base(model)
    if not isinstance(base, FullyConnected):
        return False
    if is_integer(base.J):
        return sk_sweep_eligible(base) and base.half_max < (1 << 24)
    return bool(torch.isfinite(base.J).all() and torch.isfinite(base.h).all())


def sweep_plan(Nk: int, B: int, integer: bool, *,
               aligned16: bool = True) -> dict:
    """The composite sweep kernel's launch plan (csrc/replica_sweep.cu,
    which takes the chains and the span as constants). An integer base:
    ops/sk.py's BLOCK_CHAINS chains a block, spans of BLOCK_SPAN spins (a
    replica block's Nk below it), the span's diagonal block of J (span x
    stride int8) and per chain 14 bytes a spin of the stride in shared
    memory, J loads of 16, 4 or 1 bytes, the commit an int8 tensor-core
    product ("mma"). A float base: FLOAT_CHAINS chains, spans of SPAN (the
    plain version's, whose float32 sums the kernel repeats), 15 bytes a
    spin of the stride a chain, rows in 16-byte loads where Nk % 4 == 0,
    the commit on the CUDA cores ("scalar")."""
    if integer:
        span = min(Nk, BLOCK_SPAN)
        sp = span_stride(span)
        return {"chains": BLOCK_CHAINS, "span": span, "stride": sp,
                "loads": load_width(Nk, aligned16),
                "smem": span * sp + BLOCK_CHAINS * sp * 14,
                "blocks": -(-B // BLOCK_CHAINS), "path": "mma"}
    span = min(Nk, SPAN)
    sp = span_stride(span)
    return {"chains": FLOAT_CHAINS, "span": span, "stride": sp,
            "loads": 4 if Nk % 4 == 0 and aligned16 else 1,
            "smem": FLOAT_CHAINS * sp * 15,
            "blocks": -(-B // FLOAT_CHAINS), "path": "scalar"}


def _check_args(sigma, lf, E, acc, tab):
    B, N = sigma.shape
    Nk, M = tab.Nk, tab.M
    if tab.term not in ("ring", "star") or tab.neigh is not None:
        raise ValueError("the sweep takes a ring or star composite over a "
                         "dense base")
    if N != Nk * M:
        raise ValueError(f"sigma has {N} spins, the composite {Nk} x {M}")
    integer = is_integer(lf)
    want = {"sigma": (sigma, (B, N), torch.int8),
            "lf": (lf, (B, N), torch.int32 if integer else torch.float32),
            "E": (E, (B,), torch.float32), "acc": (acc, (B,), torch.int32),
            "params": (tab.params, (2 + M,), torch.float32),
            "J": (tab.J, (Nk, Nk),
                  torch.int8 if integer else torch.float32)}
    check_args(want, sigma.device)


@spanned("rrrmc.op.replica_sweep")
def replica_sweep_chunk(sigma, lf, E, acc, tab: ReplicaTables, *,
                        beta: float, n_sweeps: int, seed: int,
                        sweep0: int = 0, chain0: int = 0,
                        bits: Optional[SweepBitsFn] = None,
                        checked: bool = False) -> None:
    """Advance every chain by `n_sweeps` composite sweeps, in place (the
    module docstring's contract); `tab` the dense `replica_tables`.

    On a CUDA tensor this launches the kernel (`sweep_plan`). For an
    integer base it needs a symmetric J, checked before the launch unless
    `checked` says that the caller has checked it (as `ReplicaSweeper` does
    once, when it is built); the float kernel reads J's rows as the plain
    version does and needs no symmetry. On a CPU tensor it runs the plain
    version. `bits` (sweep) -> [B, N] int32 replaces the generator and is
    taken by the plain version only."""
    _check_args(sigma, lf, E, acc, tab)
    if sigma.device.type == "cpu":
        replica_sweep_chunk_reference(sigma, lf, E, acc, tab, beta=beta,
                                      n_sweeps=n_sweeps, seed=seed,
                                      sweep0=sweep0, chain0=chain0,
                                      bits=bits)
        return
    if sigma.device.type != "cuda":
        raise ValueError(f"no replica sweep kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    integer = is_integer(lf)
    if integer and not checked:
        check_symmetric(tab.J, "replica sweep")
    from .cuda_build import library
    lib = library()
    B = sigma.shape[0]
    dev = sigma.device.index or 0
    plan = sweep_plan(tab.Nk, B, integer,
                      aligned16=tab.J.data_ptr() % 16 == 0
                      and lf.data_ptr() % 16 == 0
                      and sigma.data_ptr() % 4 == 0)
    launch.require_smem(plan["smem"],
                        launch.max_smem("rrrmc_replica_sweep_max_smem", dev),
                        tab.Nk, "replica sweep")
    launch.record("replica_sweep", plan)
    with torch.cuda.device(sigma.device):
        err = lib.rrrmc_replica_sweep(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), acc.data_ptr(),
            tab.J.data_ptr(), tab.params.data_ptr(), tab.Nk, tab.M, B,
            n_sweeps, float(beta), seed & 0xFFFFFFFF, sweep0 & 0xFFFFFFFF,
            chain0 & 0xFFFFFFFF, 0 if integer else 1,
            int(tab.term == "star"), plan["loads"],
            torch.cuda.current_stream().cuda_stream)
    launch.launched("replica_sweep", err)


def _extra(tab, sig, k, i0, i1):
    """[B, i1 - i0] float32 extra term of block k's spins i0..i1 - 1 at the
    spins sig [B, N] int32: c4 (s_{k-1} + s_{k+1}) for the ring (inside the
    parentheses of dE), s fk[(mu - s + M - 1) >> 1] for the star."""
    M, Nk = tab.M, tab.Nk
    blocks = sig.view(sig.shape[0], M, Nk)[:, :, i0:i1]
    if tab.term == "ring":
        r = blocks[:, (k + 1) % M] + blocks[:, (k - 1) % M]
        return tab.params[1] * r.to(torch.float32)
    s = blocks[:, k]
    mu = blocks.sum(dim=1, dtype=torch.int32)
    fk = tab.params[2:]
    return s.to(torch.float32) * fk[((mu - s + M - 1) >> 1).long()]


def replica_sweep_chunk_reference(sigma, lf, E, acc, tab: ReplicaTables, *,
                                  beta: float, n_sweeps: int, seed: int,
                                  sweep0: int = 0, chain0: int = 0,
                                  bits: Optional[SweepBitsFn] = None) -> None:
    """Plain torch version of the composite sweep kernel, span by span as
    the kernel (same arguments and in-place contract as
    `replica_sweep_chunk`): the same float32 operations in the same order,
    the commit summing the span's flips in site order."""
    B, N = sigma.shape
    M, Nk = tab.M, tab.Nk
    dev = sigma.device
    lt = lf.dtype
    sb = tab.params[0]
    star = tab.term == "star"
    span = min(Nk, SPAN)
    sig = sigma.to(torch.int32)
    Jt = tab.J.to(lt)
    for t in range(sweep0, sweep0 + n_sweeps):
        rb = bits(t) if bits is not None else prng.race_bits(
            seed, chain0, B, N, t, 1, dev, draw=prng.DRAW_REPLICA_SWEEP)[0]
        for k in range(M):
            for i0 in range(0, Nk, span):
                i1 = min(Nk, i0 + span)
                lo = k * Nk + i0
                extra = _extra(tab, sig, k, i0, i1)
                lfw = lf[:, lo:lo + i1 - i0].clone()
                delta = torch.zeros((B, i1 - i0), dtype=lt, device=dev)
                for q in range(i1 - i0):
                    s = sig[:, lo + q]
                    sf = s.to(torch.float32)
                    tq = sb * lfw[:, q].to(torch.float32)
                    dE = (2 * sf * tq + extra[:, q] if star
                          else 2 * sf * (tq + extra[:, q]))
                    p = torch.exp(-beta * dE)
                    x = (p * 4294967296.0 - 2147483648.0).clamp(
                        -2147483648.0, 2147483520.0)
                    ok = (dE <= 0) | (rb[:, lo + q] < x.to(torch.int32))
                    d = torch.where(ok, -2 * s, 0).to(lt)
                    delta[:, q] = d
                    sig[:, lo + q] = torch.where(ok, -s, s)
                    lfw[:, q + 1:] += d[:, None] * Jt[i0 + q, i0 + q + 1:i1]
                    E += torch.where(ok, dE, 0.0)
                    acc += ok.to(torch.int32)
                a = torch.zeros((B, Nk), dtype=lt, device=dev)
                for q in range(i1 - i0):
                    a += delta[:, q:q + 1] * Jt[i0 + q]
                lf[:, k * Nk:(k + 1) * Nk] += a
    sigma.copy_(sig.to(torch.int8))


class ReplicaSweeper:
    """Reusable sweep runner for an eligible Quant / RE composite: the
    dense tables, built once on the model's device (the JAX package's
    PallasRingSweeper). Refuses an integer base whose couplings are not
    symmetric: that kernel's commit reads J[span, n] as J[n, span]; its
    launches then skip the wrapper's check."""

    def __init__(self, model, beta: float):
        if not replica_sweep_ok(model):
            raise ValueError(
                f"the replica sweep kernel needs a GraphQuant or "
                f"GraphRobustEnsemble composite over a FullyConnected base "
                f"with integer |J| <= 127 or float couplings, got "
                f"{type(model).__name__}")
        self.beta = float(beta)
        (self.tab,) = replica_tables(model)
        if is_integer(self.tab.J):
            check_symmetric(self.tab.J, "replica sweep")

    def __call__(self, sigma, lf, E, acc, *, seed: int, n_sweeps: int,
                 sweep0: int = 0, chain0: int = 0,
                 bits: Optional[SweepBitsFn] = None) -> None:
        replica_sweep_chunk(sigma, lf, E, acc, self.tab, beta=self.beta,
                            n_sweeps=n_sweeps, seed=seed, sweep0=sweep0,
                            chain0=chain0, bits=bits, checked=True)
