"""Race moves (bkl / wtm / rrr) on the binary perceptrons: the CUDA kernel
(csrc/rejfree_perc.cu, with csrc/perc.cuh), its plain torch version, and the
family rule, eligibility and tables of the perceptron race and EO kernels
(the EO kernel's wrapper is ops/eo_perc.py).

Source note. The race kernel replaces
rrrmc_tpu/ops/perc_pallas.py::_rejfree_perc_kernel and the EO kernel that
file's _eo_perc_kernel. Both compute, at every move, the energy change of
every flip from the chain's stabilities Delta [P] (models/perceptron.py):

    dE2_i = tot + sigma_i (xi^T g)_i,   dE_i = dE2_i / 2,
    g_a = gm_a - gp_a,  tot = sum_a (gm_a + gp_a),

with gm and gp elementwise in Delta (no table): step gm = (Delta == 1),
gp = -(Delta == -1); linear gm = (Delta < 2), gp = -(Delta < 0); xentr
gm = sp(-c (Delta - 2)) - sp(-c Delta), gp the +2 shift, sp the stable
softplus max(x, 0) + log1p(exp(-|x|)) and c = 2 lam / sqrt(N) recovered from
the loss table. The integer families give dE = dE2 >> 1, exactly (dE2 is
even); xentr dE = dE2 * 0.5 in float32. A flip of w moves the stabilities by
-2 sigma_w xi[:, w].

Both kernels take the patterns as bits: they are +-1 (the
model's formula assumes it: N odd makes Delta odd; `perc_rejfree_ok` refuses
other patterns), so `perc_tables` packs them once per sampler call into xb
[ceil(P/32), N] words, word-major, bit a % 32 of xb[a // 32, i] set where
xi_ai = +1, 64 KB at N = 1023, P = 511, which the kernels keep in shared
memory (read from global memory where they do not fit beside the state:
the plan's "patterns", "shared" or "global"; the EO kernel's plan,
ops/eo_perc.py, likewise). After each flip the race kernel rebuilds
g's state from the stabilities by warp ballots, as 0/1 masks m over the
patterns: step one plane [Delta == 1] | [Delta == -1], linear two,
[Delta < 2] and [Delta < 0], with g their sum; over +-1 patterns
sum_a xi_ai m_a = 2 popc(x_i & m) - popc(m), exact integer arithmetic of
ceil(P/32) AND + POPC a plane and a site. Xentr keeps g in float32 and adds
+-g_a in pattern order, the sign taken from the bit, which equals
float(xi_ai) g_a. dE is computed by the site of race.cuh's fused pass
itself (`race_moves`, the launch rule of ops/rejfree.py: 256 threads a
chain, 1023 sites being too few a thread for 512), so the int8 pattern
stream from L2 that set the earlier kernel's pace is gone; rrr's z' takes a
second pass, and a rejected flip is undone exactly (integer stabilities).
The EO kernel (csrc/eo_perc.cu, 256 threads a chain) keeps dE [N] (int32,
float32 for xentr), the spins, the stabilities (int32) and g's state in
shared memory and computes every dE from the bits at every move, four
sites a thread, counting it in the select's histogram in the same pass;
the flip's column is one word of bits a warp. The TPU kernels padded to
128 rows and ran the product and the rank-1 stability update on their
MXU.

The plain version takes the block size (`threads`) for z's order and
xentr's tot, and computes the product from the int8 patterns, never from
the bits: it is the kernel's independent check.

The race weighs site i by beta * scale * max(dE_i, 0), the port's
convention, which gives the same float32 score as the TPU's
beta * scale / 2 * max(dE2_i, 0): the halving is exact. Xentr's running E
drifts by float32 rounding; the samplers resync it from the stabilities
(`perc_resync`) at every chunk boundary, before the chunk's start value is
recorded, as the JAX package's run loop does.

The plain version computes g, tot and the product as the kernel does, the
float product in the kernel's order, so it agrees with the kernel bit for
bit on every family where torch's float32 exp and log1p round as CUDA's
expf and log1pf do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import check_args, launch
from .rejfree import (BitsFn, FUSED_THREADS, MODES, THREADS, block_sum,
                      coord_dtype, race_chunk_reference, race_plan)
from ..core.dtypes import is_integer
from ..utils.profiling import spanned

#: the kernels' family codes
FAMILY_CODES = {"step": 0, "linear": 1, "xentr": 2}


def table_family(loss_table: torch.Tensor, N: int):
    """(family, c) of a loss table over Delta = -N, -N + 2, ..., N: "step",
    "linear" or "xentr" (then c = 2 lam / sqrt(N), recovered from the entry
    at Delta = -1 as the JAX package recovers it and checked against the
    whole table), or (None, 0.0). Computed from the N + 1 entries at every
    call: nothing is cached on the patterns (the JAX package's family cache
    keyed on id(xi) gives two models sharing one xi the first one's
    family)."""
    tab = loss_table.detach().cpu().numpy()
    d = np.arange(-N, N + 1, 2)
    if tab.shape != d.shape:
        return None, 0.0
    if np.issubdtype(tab.dtype, np.integer):
        if np.array_equal(tab, (d < 0).astype(tab.dtype)):
            return "step", 0.0
        if np.array_equal(tab, np.where(d < 0, (-d - 1) // 2 + 1,
                                        0).astype(tab.dtype)):
            return "linear", 0.0
        return None, 0.0
    i = np.searchsorted(d, -1)
    if i < len(d) and d[i] == -1 and tab[i] > 0:
        c = float(np.log(np.expm1(tab[i])))
        x = -c * d.astype(np.float64)
        ref = np.where(x > 60, x, np.log1p(np.exp(np.minimum(x, 60))))
        if c > 0 and np.allclose(tab, ref, rtol=1e-4, atol=1e-6):
            return "xentr", c
    return None, 0.0


def perc_family(model) -> Optional[str]:
    """"step", "linear" or "xentr" for a Perceptron whose table is one of
    the three builders', else None."""
    from ..models.perceptron import Perceptron

    if not isinstance(model, Perceptron):
        return None
    return table_family(model.loss_table, model.N)[0]


def perc_rejfree_ok(model) -> bool:
    """Eligibility of a model for the perceptron race and EO kernels (the
    JAX package's `perc_rejfree_ok` without its TPU caps on N, P and N P:
    the shared-memory limit is checked at launch): a Perceptron with
    N >= 8, N odd (the elementwise g of the step family assumes odd
    stabilities; the JAX rule omits it, and its kernels give a wrong dE at
    even N), +-1 patterns (the model's formula assumes them, and the race
    kernel holds one bit a pattern entry; the JAX kernels take any int8)
    and a recognised family. The pattern check reads the device once."""
    from ..models.perceptron import Perceptron

    return (isinstance(model, Perceptron) and model.N >= 8
            and model.N % 2 == 1 and model.P >= 1
            and perc_family(model) is not None
            and plus_minus_one(model.xi))


def plus_minus_one(xi: torch.Tensor) -> bool:
    """Whether every pattern entry is +1 or -1."""
    return bool(((xi == 1) | (xi == -1)).all())


def pack_patterns(xi: torch.Tensor) -> torch.Tensor:
    """The race kernel's pattern bits of xi [P, N], which must be +-1 (a
    ValueError otherwise): xb [ceil(P/32), N] int32 (the kernel reads
    uint32), word-major, bit a % 32 of xb[a // 32, i] set where xi[a, i] =
    +1; bits past P are 0."""
    if not plus_minus_one(xi):
        raise ValueError("the perceptron race kernel takes +-1 patterns")
    P, N = xi.shape
    W = -(-P // 32)
    bits = torch.zeros((32 * W, N), dtype=torch.int64, device=xi.device)
    bits[:P] = (xi > 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=xi.device)
    words = (bits.view(W, 32, N) << shifts[:, None]).sum(1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32).contiguous()


def perc_tables(model) -> tuple:
    """The kernels' tables of a Perceptron: (xi [P, 4 ceil(N/4)] int8, zero
    past N; xi^T [N, P] int8; the loss table, which gives the family; the
    kernels' pattern bits, `pack_patterns(model.xi)`, which the plain
    versions do not read)."""
    P, N = model.xi.shape
    xi4 = torch.zeros((P, -(-N // 4) * 4), dtype=torch.int8,
                      device=model.xi.device)
    xi4[:, :N] = model.xi
    return (xi4, model.xi.t().contiguous(), model.loss_table,
            pack_patterns(model.xi))


def perc_state(model, sigma, E):
    """The kernels' resident state: the stabilities [B, P] int32 and a copy
    of E in the table's dtype (int32, float32 for xentr)."""
    return (model.init_aux(sigma).contiguous(),
            E.to(model.loss_table.dtype).clone())


def perc_resync(model, delta, E) -> None:
    """Xentr only: E = the energy of the stabilities, in place (the float32
    running E drifts; the integer families' E is exact)."""
    if not is_integer(E):
        E.copy_(model.energy_of(delta))


def check_perc_args(sigma, delta, E, scalars: dict, xi4, xiT, loss, xb):
    """check_args for the spins, stabilities, E, the wrapper's `scalars`
    and the tables; returns (family, c)."""
    B, N = sigma.shape
    P = xiT.shape[1]
    fam, c = table_family(loss, N)
    if fam is None or N % 2 != 1:
        raise ValueError("the perceptron kernels take an odd N and a step, "
                         "linear or xentr loss table")
    et = torch.float32 if fam == "xentr" else torch.int32
    check_args({"sigma": (sigma, (B, N), torch.int8),
                "delta": (delta, (B, P), torch.int32), "E": (E, (B,), et),
                **scalars,
                "xi4": (xi4, (P, -(-N // 4) * 4), torch.int8),
                "xiT": (xiT, (N, P), torch.int8),
                "loss": (loss, (N + 1,), et),
                "xb": (xb, (-(-P // 32), N), torch.int32)}, sigma.device)
    return fam, c


def g_terms(fam: str, c: float, delta: torch.Tensor):
    """(gm, gp) [B, P] of the stabilities, elementwise as the kernels
    compute them (int32; float32 for xentr)."""
    if fam == "step":
        return (delta == 1).to(torch.int32), -(delta == -1).to(torch.int32)
    if fam == "linear":
        return (delta < 2).to(torch.int32), -(delta < 0).to(torch.int32)
    nc = -torch.tensor(c, dtype=torch.float32, device=delta.device)
    d = delta.to(torch.float32)

    def sp(x):
        return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))

    sp0 = sp(nc * d)
    return sp(nc * (d - 2.0)) - sp0, sp(nc * (d + 2.0)) - sp0


def de_flip(fam: str, c: float, xi4, xiT, N: int, threads: int = THREADS):
    """(de_of, delta_flipped) of the plain versions: de_of(sig, delta) the
    [B, N] energy changes from the stabilities (the kernels' arithmetic:
    the float product adds xi_ai g_a over a in turn, tot is summed in the
    order of a block of `threads` threads), delta_flipped(sig, delta, win,
    d, do) a copy of the stabilities with the winner win [B] flipped
    (d = -2 sigma_win) where do."""
    xi = xi4[:, :N]
    xf = xi.to(torch.float32)
    P = xi.shape[0]

    def de_of(sig, delta):
        gm, gp = g_terms(fam, c, delta)
        g = gm - gp
        if fam != "xentr":
            tot = (gm + gp).sum(-1, dtype=torch.int32)
            proj = (g.to(torch.float64) @ xi.to(torch.float64)).to(
                torch.int32)
            return (tot[:, None] + sig.to(torch.int32) * proj) >> 1
        tot = block_sum(gm + gp, threads)
        B = sig.shape[0]
        proj = torch.zeros((B, N), dtype=torch.float32, device=sig.device)
        # the terms xi_ai g_a (exact: xi = +-1) of a block of patterns at a
        # time, at most 2^26 of them, then added in turn
        step = max(1, (1 << 26) // (B * N))
        for a0 in range(0, P, step):
            terms = xf[a0:a0 + step] * g[:, a0:a0 + step, None]
            for a in range(terms.shape[1]):
                proj.add_(terms[:, a])
        return (tot[:, None] + sig.to(torch.float32) * proj) * 0.5

    def delta_flipped(sig, delta, win, d, do):
        upd = torch.where(do, d.to(torch.int32), 0)
        return delta + upd[:, None] * xiT[win].to(torch.int32)

    return de_of, delta_flipped


@spanned("rrrmc.op.rejfree_perc")
def rejfree_perc_chunk(sigma, delta, E, coord, acc, zacc, xi4, xiT, loss,
                       xb, *, mode: str, n_moves: int, beta_s: float, target,
                       seed: int, move0: int = 0, chain0: int = 0,
                       bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` race moves, in place: the contract
    of ops/rejfree.py::rejfree_sparse_chunk, with the stabilities delta
    [B, P] int32 in the place of lf, E int32 (float32 for xentr) and the
    tables of `perc_tables` in the place of neigh/J (xb the bits of xi4's
    +-1 patterns, which the kernel reads in their place). beta_s = beta *
    model.scale. On a CUDA tensor this launches the kernel with the launch
    rule's block size, the bits in shared memory where they fit beside the
    state, else in global memory (the plan's "patterns"), and the step
    and linear families' exp table over |dE| <= P; on a CPU tensor it runs
    the plain version. Returns the per-move (coordinate, E) streams, each
    [n_moves, B]."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    B, N = sigma.shape
    fam, c = check_perc_args(sigma, delta, E, {
        "coord": (coord, (B,), coord_dtype(mode)),
        "acc": (acc, (B,), torch.int32),
        "zacc": (zacc, (B,), torch.float32)}, xi4, xiT, loss, xb)
    if sigma.device.type == "cpu":
        return rejfree_perc_chunk_reference(
            sigma, delta, E, coord, acc, zacc, xi4, xiT, loss, xb, mode=mode,
            n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
            move0=move0, chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no race kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import library

    lib = library()
    P = xiT.shape[1]
    dev = sigma.device
    code = FAMILY_CODES[fam]
    n_ez = 0 if fam == "xentr" else P + 1
    wtm = int(mode == "wtm")
    dev_i = dev.index or 0

    def need(sx):
        return lib.rrrmc_rejfree_perc_smem(N, P, code, n_ez, sx)

    # the pattern bits in shared memory where some block size fits them
    sx = int(any(need(1) <= f[4] and f[0] > 0 for f in (
        launch.facts("rrrmc_rejfree_perc_info", (code, wtm, 1), t, need(1),
                     dev_i) for t in FUSED_THREADS)))
    threads = race_plan("rejfree_perc", "rrrmc_rejfree_perc_info",
                        (code, wtm, sx), B, N, need(sx),
                        torch.int16 if N <= 32767 else torch.int32, dev_i,
                        patterns="shared" if sx else "global")["threads"]
    ct = coord_dtype(mode)
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=E.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_perc(
            sigma.data_ptr(), delta.data_ptr(), E.data_ptr(),
            coord.data_ptr(), acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(),
            es.data_ptr(), xb.data_ptr(), N, P, B, n_moves,
            seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            beta_s, int(target) if ct == torch.int32 else 0, float(target),
            MODES[mode], code, c, n_ez, threads, sx,
            torch.cuda.current_stream().cuda_stream)
    launch.launched("rejfree_perc", err)
    return cs, es


def rejfree_perc_chunk_reference(sigma, delta, E, coord, acc, zacc, xi4,
                                 xiT, loss, xb, *, mode: str, n_moves: int,
                                 beta_s: float, target, seed: int,
                                 move0: int = 0, chain0: int = 0,
                                 bits: Optional[BitsFn] = None,
                                 threads: int = THREADS):
    """Plain torch version of the perceptron race kernel (same arguments,
    in-place contract and streams as `rejfree_perc_chunk`; z and xentr's
    tot summed as a block of `threads` threads sums them): dE is
    recomputed from the stabilities at every move, the product from the
    int8 patterns (xb is not read)."""
    fam, c = table_family(loss, sigma.shape[1])
    de_of, delta_flipped = de_flip(fam, c, xi4, xiT, sigma.shape[1],
                                   threads)
    return race_chunk_reference(
        sigma, delta, E, coord, acc, zacc, delta_flipped, mode=mode,
        n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
        move0=move0, chain0=chain0, bits=bits, de_of=de_of, threads=threads)
