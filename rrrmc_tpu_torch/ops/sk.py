"""Dense (SK) Metropolis sweeps on an integer FullyConnected model: the CUDA
kernel (csrc/sk_sweep.cu), its plain torch version, and the `SKSweeper`
runner.

Source note. The kernel replaces rrrmc_tpu/ops/sk_pallas.py::_sk_kernel and
::_sk_kernel_hbm (both launched by `_pallas_sk`). The TPU kept J in VMEM or
streamed it from HBM by size; on the H100 J is read from device memory or L2
in both cases, so one kernel serves both. A block of BLOCK_CHAINS chains
(one warp each) walks the sweep in spans of BLOCK_SPAN sites (N below it),
all its chains on the same span. A span's Philox words are drawn once a
site and resolved against the threshold table at once (hmax(u), the number
of entries above the word: the decision becomes one compare); a warp
decides 32 consecutive sites at once, the first accepting
lane's flip corrects the later sites' fields from the span's diagonal block
of J in shared memory and evaluation resumes after it (exact sequential
Metropolis, since every site's bits are fixed by its counter); at the
span's end the block commits all its chains' flips with one int8
tensor-core product, J being symmetric. `sweep_plan` states the launch:
the block's chains, the span and the shared memory. What bounds it:
csrc/sk_sweep.cu.

Contract (the JAX kernels'): sigma [B, N] int8, lf [B, N] int32 and
E [B] int32 advance in place by n_sweeps sweeps. A sweep visits sites
0..N-1 in windows of WINDOW = 128; site k of window w is decided against its
field plus the corrections of the window's earlier accepted flips, accepted
iff half = sigma_k lf_k <= 0 or bits < th[half - 1] (`accept_thresholds`:
the TPU kernel's float32 threshold, tabulated); after each window
lf += J[window, :]^T delta. E gains 2*half per accepted flip. The random
bits are ops/prng.py::sk_bits at window step t = sweep * n_win + w, sweeps
numbered from `sweep0`. `accepted` is not counted, as on the TPU route.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import check_args, launch, prng
from ..core.dtypes import is_integer
from ..utils.profiling import spanned

#: sites of one window (the TPU kernel's W): one Philox window step each
WINDOW = 128
#: the span of the integer sweep kernels, N (or a replica block's Nk)
#: below it (csrc/sweep_block.cuh::kSpanMax)
BLOCK_SPAN = 256
#: chains (warps) of a block of the integer sweep kernels
#: (csrc/sweep_block.cuh::kChains)
BLOCK_CHAINS = 16
#: sites of one K chunk of the commit's tensor-core product
CHUNK = 64
_INT32_MIN = -2 ** 31

BitsFn = Callable[[int, int], torch.Tensor]


def accept_thresholds(beta_s: float, half_max: int) -> np.ndarray:
    """int32 thresholds th[v - 1] for half = v = 1, 2, ...: the TPU kernel's
    float32 arithmetic p = exp(-beta_s * 2v), clip(p * 2^32 - 2^31), in
    numpy float32. The table ends before its first INT32_MIN entry (no bits
    lie below it: a larger half is always rejected) or at half_max."""
    v2 = (2 * np.arange(1, int(half_max) + 1)).astype(np.float32)
    with np.errstate(under="ignore"):
        p = np.exp(-np.float32(beta_s) * v2)
    t = p * np.float32(4294967296.0) - np.float32(2147483648.0)
    th = np.clip(t, np.float32(-2147483648.0),
                 np.float32(2147483520.0)).astype(np.int32)
    ends = np.flatnonzero(th == _INT32_MIN)
    return th[:ends[0]] if ends.size else th


def check_thresholds(th: np.ndarray) -> None:
    """Raise unless the table does not increase (beta >= 0): what the
    kernel's decision needs. With hmax(u) = #{v : th[v - 1] > u} over such
    a table, u < th[half - 1] iff half <= hmax(u) for 1 <= half <= len(th);
    a larger half is always rejected and a half <= 0 always accepted, so
    the decision is the one compare half <= hmax(u)."""
    if th.size and bool((np.diff(th.astype(np.int64)) > 0).any()):
        raise ValueError("the dense sweep kernel needs thresholds that do not "
                         "increase with half (beta >= 0)")


def check_symmetric(J: torch.Tensor, what: str) -> None:
    """Raise unless J [n, n] is symmetric: the kernels' commits read
    J[span, n] as J[n, span], both operands along their rows."""
    if J.dim() != 2 or J.shape[0] != J.shape[1] or not torch.equal(J, J.T):
        raise ValueError(f"the {what} kernel needs symmetric couplings")


def span_stride(span: int) -> int:
    """The stride of a span's per-chain arrays: the span rounded up to a
    commit chunk (csrc/sweep_block.cuh::span_stride)."""
    return -(-span // CHUNK) * CHUNK


def load_width(n: int, aligned16: bool = True) -> int:
    """The commit's J loads: 16 bytes where rows of n int8 entries are
    16-byte aligned, 4 where they are 4-byte aligned, else single bytes
    (`aligned16`: J's and the fields' base pointers are 16-byte aligned and
    the spins' 4-byte aligned; from 4 bytes the few-flip commit reads 4
    fields at once and a span's spins and fields load 4 a lane)."""
    if n % 16 == 0 and aligned16:
        return 16
    return 4 if n % 4 == 0 and aligned16 else 1


def sweep_plan(N: int, B: int, n_th: int, *,
               aligned16: bool = True) -> dict:
    """The dense sweep kernel's launch plan (csrc/sk_sweep.cu, which
    takes the chains and the span as constants): BLOCK_CHAINS chains a
    block (warps past B stay for the block's barriers), the span (sites
    between two commits: BLOCK_SPAN, or N below it), the block's dynamic
    shared memory (the span's diagonal block of J, span x stride int8, and
    per chain 6 + hmax bytes a site of the stride), hmax in 2 bytes where
    the table fits 16 bits, the commit's J loads, and its path: the int8
    tensor-core product ("mma")."""
    span = min(N, BLOCK_SPAN)
    hbytes = 2 if n_th <= 0xFFFF else 4
    sp = span_stride(span)
    return {"chains": BLOCK_CHAINS, "span": span, "stride": sp,
            "hmax_bytes": hbytes, "loads": load_width(N, aligned16),
            "smem": span * sp + BLOCK_CHAINS * sp * (6 + hbytes),
            "blocks": -(-B // BLOCK_CHAINS), "path": "mma"}


def sk_sweep_eligible(model) -> bool:
    """An integer FullyConnected model with |J| <= 127 (the kernel reads J
    as int8) and integer fields."""
    from ..models.dense import FullyConnected

    return (isinstance(model, FullyConnected) and model.N > 0
            and is_integer(model.J) and is_integer(model.h)
            and model.j_max <= 127)


def _check_args(sigma, lf, E, J8, th):
    B, N = sigma.shape
    want = {"sigma": (sigma, (B, N), torch.int8),
            "lf": (lf, (B, N), torch.int32), "E": (E, (B,), torch.int32),
            "J8": (J8, (N, N), torch.int8),
            "th": (th, (th.shape[0],), torch.int32)}
    check_args(want, sigma.device)


@spanned("rrrmc.op.sk_sweep")
def sk_sweep_chunk(sigma, lf, E, J8, th, *, n_sweeps: int, seed: int,
                   sweep0: int = 0, chain0: int = 0,
                   bits: Optional[BitsFn] = None,
                   checked: bool = False) -> None:
    """Advance every chain by `n_sweeps` dense sweeps, in place on sigma
    [B, N] int8, lf [B, N] int32 and E [B] int32. J8 [N, N] int8 holds the
    couplings, th the `accept_thresholds`.

    On a CUDA tensor this launches the kernel (`sweep_plan`), which needs a
    symmetric J8 and a th that does not increase: both are checked before
    the launch unless `checked` says that the caller has checked them (as
    `SKSweeper` does once, when it is built). On a CPU tensor it runs the
    plain version, which needs neither. `bits` (sweep, window) -> [B, W]
    int32 replaces the generator and is taken by the plain version only."""
    _check_args(sigma, lf, E, J8, th)
    if sigma.device.type == "cpu":
        sk_sweep_chunk_reference(sigma, lf, E, J8, th, n_sweeps=n_sweeps,
                                 seed=seed, sweep0=sweep0, chain0=chain0,
                                 bits=bits)
        return
    if sigma.device.type != "cuda":
        raise ValueError(f"no dense sweep kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    if not checked:
        check_symmetric(J8, "dense sweep")
        check_thresholds(th.cpu().numpy())
    from .cuda_build import library

    lib = library()
    B, N = sigma.shape
    dev = sigma.device.index or 0
    plan = sweep_plan(N, B, th.shape[0],
                      aligned16=J8.data_ptr() % 16 == 0
                      and lf.data_ptr() % 16 == 0
                      and sigma.data_ptr() % 4 == 0)
    launch.require_smem(plan["smem"], launch.max_smem("rrrmc_sk_max_smem",
                                                      dev), N, "dense sweep")
    launch.record("sk_sweep", plan)
    with torch.cuda.device(sigma.device):
        err = lib.rrrmc_sk_sweep(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), J8.data_ptr(),
            th.data_ptr(), th.shape[0], N, B, n_sweeps, seed & 0xFFFFFFFF,
            sweep0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, plan["hmax_bytes"],
            plan["loads"], torch.cuda.current_stream().cuda_stream)
    launch.launched("sk_sweep", err)


def sk_sweep_chunk_reference(sigma, lf, E, J8, th, *, n_sweeps: int,
                             seed: int, sweep0: int = 0, chain0: int = 0,
                             bits: Optional[BitsFn] = None) -> None:
    """Plain torch version of the dense sweep kernel, window by window as
    the TPU kernel (same arguments and in-place contract as
    `sk_sweep_chunk`). The rank-W commit is a float64 product cast back,
    exact for int8 couplings."""
    B, N = sigma.shape
    dev = sigma.device
    n_win = -(-N // WINDOW)
    n_th = th.shape[0]
    th_ext = torch.cat([th, torch.tensor([_INT32_MIN], dtype=torch.int32,
                                         device=dev)])
    Jd = J8.to(torch.float64)
    s_all = sigma.to(torch.int32)
    dE = torch.zeros(B, dtype=torch.int32, device=dev)
    for sw in range(sweep0, sweep0 + n_sweeps):
        for w in range(n_win):
            lo, hi = w * WINDOW, min(N, (w + 1) * WINDOW)
            rb = (bits(sw, w) if bits is not None else prng.sk_bits(
                seed, chain0, B, WINDOW, sw * n_win + w, dev))
            Jw = J8[lo:hi, lo:hi].to(torch.int32)
            s = s_all[:, lo:hi].clone()
            lfw = lf[:, lo:hi].clone()
            delta = torch.zeros_like(s)
            for k in range(hi - lo):
                half = s[:, k] * lfw[:, k]
                # th[half - 1] for 1 <= half <= n_th, INT32_MIN beyond
                idx = torch.where(half > n_th, n_th, half.clamp(min=1) - 1)
                acc = (half <= 0) | (rb[:, k] < th_ext[idx.long()])
                d = torch.where(acc, -2 * s[:, k], 0)
                delta[:, k] = d
                s[:, k] += d
                lfw += d[:, None] * Jw[k][None, :]
                dE += torch.where(acc, 2 * half, 0)
            s_all[:, lo:hi] = s
            lf += (delta.to(torch.float64) @ Jd[lo:hi]).to(torch.int32)
    sigma.copy_(s_all.to(torch.int8))
    E += dE


class SKSweeper:
    """Reusable dense-sweep runner for an eligible FullyConnected model
    (fields allowed: they ride the lf seed): the int8 couplings and the
    threshold table, built once on the model's device (the JAX package's
    PallasSKSweeper). Refuses couplings that are not symmetric and a
    table that increases, on which the kernel would be wrong; its launches
    then skip the wrapper's checks."""

    def __init__(self, model, beta: float):
        if not sk_sweep_eligible(model):
            raise ValueError(
                f"the dense sweep kernel needs a FullyConnected model with "
                f"integer couplings |J| <= 127 and integer fields, got "
                f"{type(model).__name__}")
        self.beta_s = float(beta) * model.scale
        self.J8 = model.J.to(torch.int8).contiguous()
        check_symmetric(self.J8, "dense sweep")
        th = accept_thresholds(self.beta_s, int(model.half_max))
        check_thresholds(th)
        self.th = torch.as_tensor(th, device=model.device)

    def __call__(self, sigma, lf, E, *, seed: int, n_sweeps: int,
                 sweep0: int = 0, chain0: int = 0,
                 bits: Optional[BitsFn] = None) -> None:
        """Advance sigma [B, N] int8, lf [B, N] int32 and E [B] int32 by
        n_sweeps sweeps in place (sweeps numbered from sweep0 in the Philox
        stream)."""
        sk_sweep_chunk(sigma, lf, E, self.J8, self.th, n_sweeps=n_sweeps,
                       seed=seed, sweep0=sweep0, chain0=chain0, bits=bits,
                       checked=True)
