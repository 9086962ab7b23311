"""Helpers of the tests that hold the PyTorch port (rrrmc_tpu_torch) against
the JAX package: carrying models across, and the random bits the JAX Pallas
kernels draw in interpret mode, so both sides run on identical bits."""

from __future__ import annotations

import importlib
import os
from contextlib import contextmanager

import numpy as np
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import prng

#: rrrmc_tpu/ops/prng.py's GOLD and per-kernel salt multiplier
_GOLD = -1640531527
_SALT_MUL = 1000003
#: the port's builders and samplers run on the card unless asked: the CPU
#: tests ask for the host
CPU = {"device": "cpu"}


def host(mod) -> dict:
    """Keywords that put a builder of `mod` on the CPU: device="cpu" for
    the port, none for the JAX package."""
    return CPU if mod is pt else {}


def port_model(jm):
    """The port's Pairwise with the JAX model's exact tables."""
    return pt.pairwise_from_arrays(
        np.asarray(jm.neigh), np.asarray(jm.J), np.asarray(jm.h),
        np.asarray(jm.offset), N=jm.N, K=jm.K, scale=jm.scale,
        classes=jm.classes, device="cpu")


def port_lattice(jm):
    """The port's LatticeEA with the JAX LatticeEA's couplings and fields."""
    return pt.lattice_from_arrays(np.asarray(jm.Jd), np.asarray(jm.h), jm.L,
                                  jm.D, jm.scale, jm.classes, device="cpu")


def port_pspin(jm):
    """The port's PSpin3 with the JAX model's partner table."""
    return pt.pspin_from_arrays(np.asarray(jm.A), jm.N, jm.K, device="cpu")


def port_sat(jm):
    """The port's SATModel with the JAX model's clauses."""
    return pt.sat_from_arrays(jm.N, np.asarray(jm.A), np.asarray(jm.L),
                              device="cpu")


def port_perceptron(jm):
    """The port's Perceptron with the JAX model's patterns and loss table
    (a float64 table of an x64 run is stored as float32)."""
    return pt.perceptron_from_arrays(np.asarray(jm.xi),
                                     np.asarray(jm.loss_table), N=jm.N,
                                     P=jm.P, scale=jm.scale, device="cpu")


def port_composite(jm):
    """The port's composite over the JAX base's exact tables."""
    jb = jm.resid_m.base
    if hasattr(jb, "neigh"):
        base = port_model(jb)
    else:
        base = pt.fully_connected_from_arrays(np.asarray(jm.resid_m.base.J),
                                              np.asarray(jb.h),
                                              scale=jb.scale, **CPU)
    if type(jm).__name__ == "QuantModel":
        return pt.replica_from_arrays("quant", base, M=jm.M,
                                      coupling=jm.Gamma, beta=jm.beta)
    return pt.replica_from_arrays("re", base, M=jm.M,
                                  coupling=jm.inner_m.gamma,
                                  beta=jm.inner_m.beta_p)


def random_sigma(rng: np.random.Generator, B: int, N: int) -> np.ndarray:
    return (rng.integers(0, 2, (B, N)) * 2 - 1).astype(np.int8)


def _fmix(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def interpret_bits(shape, salt: int) -> np.ndarray:
    """numpy copy of rrrmc_tpu/ops/prng.py::random_bits in interpret mode:
    int32 bits of a 2-D `shape` for an int32 `salt`."""
    with np.errstate(over="ignore"):
        i0 = np.arange(shape[0], dtype=np.uint32)[:, None]
        i1 = np.arange(shape[1], dtype=np.uint32)[None, :]
        s = np.uint32(np.int64(salt) & 0xFFFFFFFF)
        x = (i0 * np.uint32(0x9E3779B1) + i1 * np.uint32(0x85EBCA77)
             + _fmix(s * np.uint32(0xC2B2AE3D) + np.uint32(0x27D4EB2F)))
        return _fmix(x).view(np.int32)


def _salt0(seed: int) -> int:
    """seed_p * 1000003 in int32 arithmetic, seed_p = program_seed(seed, 0)."""
    wrap = lambda v: (v + 2 ** 31) % 2 ** 32 - 2 ** 31  # noqa: E731
    return wrap(wrap(seed * _GOLD) * _SALT_MUL)


def site_bits(seed: int, B: int):
    """bits(m, draw) of the JAX site kernel (one block of B chains): salt
    salt0 + m, row 0 of a [1, B] draw."""
    s0 = _salt0(seed)
    return lambda m, d: torch.from_numpy(
        interpret_bits((1, B), s0 + m)[0].copy())


def race_bits(seed: int, B: int, N: int, NP: int, skip_salt: int = 2):
    """bits(m, draw) of the JAX sparse race kernel (one block of B chains):
    salts 3m (race, [NP, B] sliced to the N physical rows and transposed to
    the port's [B, N]), 3m + 1 (rrr accept) and 3m + skip_salt (bkl skip)."""
    s0 = _salt0(seed)

    def bits(m, d):
        if d == 0:
            b = interpret_bits((NP, B), s0 + 3 * m)[:N].T
        else:
            off = skip_salt if d == prng.DRAW_SKIP else d
            b = interpret_bits((1, B), s0 + 3 * m + off)[0]
        return torch.from_numpy(np.ascontiguousarray(b))

    return bits


def lattice_race_bits(seed: int, B: int, N: int):
    """bits(m, draw) of the JAX lattice race kernel (`_rejfree_kernel`): as
    the sparse kernel's with NP = N, but its bkl skip is drawn at salt
    3m + 1, the rrr acceptance's salt (the two modes never share a move)."""
    return race_bits(seed, B, N, N, skip_salt=1)


def sweep_bits(seed: int, B: int, N: int):
    """bits(sweep, colour) of the JAX checkerboard sweep kernel (one block
    of B chains): salt salt0 + 2 * sweep + colour, one [N, B] draw per
    colour step, transposed to the port's [B, N]."""
    s0 = _salt0(seed)
    return lambda sw, c: torch.from_numpy(np.ascontiguousarray(
        interpret_bits((N, B), s0 + 2 * sw + c).T))


def sk_bits(seed: int, B: int, N: int, W: int = 128):
    """bits(sweep, window) of the JAX dense sweep kernel (one block of B
    chains, both its variants): salt salt0 + sweep * n_win + w, one [W, B]
    draw per window (rows past N belong to padding spins), transposed to the
    port's [B, W]."""
    s0 = _salt0(seed)
    n_win = -(-N // W)
    return lambda sw, w: torch.from_numpy(np.ascontiguousarray(
        interpret_bits((W, B), s0 + sw * n_win + w).T))


def dense_race_bits(seed: int, B: int, N: int, NP: int):
    """bits(m, draw) of the JAX dense race kernel (`_rejfree_dense_kernel`):
    the race at salt 3m, a [NP, B] draw sliced to the N physical rows; the
    rrr acceptance and the bkl skip both at salt 3m + 1."""
    return race_bits(seed, B, N, NP, skip_salt=1)


def stream_race_bits(seed: int, B: int, N: int, NP: int, W: int):
    """bits(m, draw) of the JAX streamed race kernel
    (`_rejfree_stream_kernel`): move m draws from msalt = salt0 +
    m * (n_blk + 2), n_blk = NP // W; race block w at msalt + w, one [W, B]
    draw each, stacked and sliced to the N physical rows; the rrr acceptance
    and the bkl skip both at msalt + n_blk."""
    s0 = _salt0(seed)
    n_blk = NP // W

    def bits(m, d):
        msalt = s0 + m * (n_blk + 2)
        if d == prng.DRAW_RACE:
            b = np.concatenate([interpret_bits((W, B), msalt + w)
                                for w in range(n_blk)])[:N].T
        else:
            b = interpret_bits((1, B), msalt + n_blk)[0]
        return torch.from_numpy(np.ascontiguousarray(b))

    return bits


def eo_bits(seed: int, B: int, N: int):
    """bits(m, draw) of the JAX EO kernels (one block of B chains; the
    lattice, dense, streamed and sparse variants draw alike): the rank at
    salt salt0 + 2m, a [1, B] draw, and the tie race at salt0 + 2m + 1, an
    [NP, B] draw whose N physical rows are transposed to the port's
    [B, N] (a row's bits do not depend on NP)."""
    s0 = _salt0(seed)

    def bits(m, d):
        if d == prng.DRAW_EO_RANK:
            b = interpret_bits((1, B), s0 + 2 * m)[0]
        else:
            b = interpret_bits((N, B), s0 + 2 * m + 1).T
        return torch.from_numpy(np.ascontiguousarray(b))

    return bits


def jax_random_bits(jprng, shape, salt: int) -> np.ndarray:
    """rrrmc_tpu/ops/prng.py::random_bits(shape, salt) drawn inside a
    one-step Pallas kernel, `jprng` that module reloaded in interpret mode
    (`pallas_interpret`): what a JAX kernel draws at that salt."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    s32 = int(np.array(salt & 0xFFFFFFFF, np.uint32).view(np.int32))

    def kernel(o_ref):
        o_ref[...] = jprng.random_bits(shape, jnp.int32(s32))

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        interpret=jprng.interpret_params())())


@contextmanager
def pallas_interpret(*modules):
    """RRRMC_PALLAS_INTERPRET=1 with the given JAX modules reloaded (as the
    JAX package's own kernel tests do), restored afterwards."""
    old = os.environ.get("RRRMC_PALLAS_INTERPRET")
    os.environ["RRRMC_PALLAS_INTERPRET"] = "1"
    mods = [importlib.reload(importlib.import_module(m)) for m in modules]
    try:
        yield mods
    finally:
        if old is None:
            os.environ.pop("RRRMC_PALLAS_INTERPRET")
        else:
            os.environ["RRRMC_PALLAS_INTERPRET"] = old
        for m in modules:
            importlib.reload(importlib.import_module(m))


# --- plain models of the dense sweep kernels' parts (csrc/sk_sweep.cu,
# csrc/replica_sweep.cu, csrc/sweep_block.cuh) -------------------------------


def hmax_table(u: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """hmax(u) = #{v : th[v - 1] > u} of each word u (int64, u's shape),
    over a table that does not increase (the kernel's binary search)."""
    neg = -th.to(torch.int64)
    return torch.searchsorted(neg, -u.to(torch.int64).contiguous(),
                              right=False)


def _bytes16(row: torch.Tensor, c: int) -> torch.Tensor:
    """row[c .. c + 15], zero past its end (the kernel's load16)."""
    out = torch.zeros(16, dtype=torch.int64)
    part = row[c:c + 16]
    out[:part.shape[0]] = part
    return out


def blocked_commit_reference(lf, dlt, J, col0: int, length: int, *,
                             off: int = 0) -> None:
    """A plain model of the kernel's commit (csrc/sweep_block.cuh), tile by
    tile, in place on lf [B, L] int32: lf[b, off + n] += sum_k dlt[b, k]
    J[n, col0 + k] for the n rows of J [n, ld] int8, k < length, through
    mma.m16n8k32's fragment layouts. Blocks of sk.BLOCK_CHAINS chains (the
    last one ragged), two 8-chain tiles each; a warp's 16-row tile of n;
    lane (g, t) loads sites 16t..16t+15 of each 64-site chunk from rows
    n0 + g and n0 + g + 8 and the same 16 of its chain's row of dlt
    [B, stride] int8 (0 past `length`), which become its k = 4t..4t+3 and
    16+4t..16+4t+3 of two products. For a symmetric J this is
    lf += dlt[:, :length] J[col0:col0 + length, :]."""
    from rrrmc_tpu_torch.ops.sk import BLOCK_CHAINS as chains, CHUNK

    B, sp = dlt.shape
    nrows, ld = J.shape
    Jn = J.to(torch.int64)
    out = lf.to(torch.int64)
    nchunks = -(-length // CHUNK)
    for cb in range(0, B, chains):
        dl = torch.zeros((chains, sp), dtype=torch.int64)
        nb = min(chains, B - cb)
        dl[:nb] = dlt[cb:cb + nb].to(torch.int64)
        dl[:, length:] = 0
        for n0 in range(0, nrows, 16):
            for tile in range(chains // 8):
                D = torch.zeros((16, 8), dtype=torch.int64)
                for kc in range(nchunks):
                    for prod in range(2):
                        A = torch.zeros((16, 32), dtype=torch.int64)
                        Bm = torch.zeros((32, 8), dtype=torch.int64)
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            c = CHUNK * kc + 16 * t
                            ra = Jn[min(n0 + g, nrows - 1)]
                            rb = Jn[min(n0 + g + 8, nrows - 1)]
                            a16 = _bytes16(ra[:ld], col0 + c)
                            h16 = _bytes16(rb[:ld], col0 + c)
                            d16 = dl[8 * tile + g, c:c + 16]
                            p = 8 * prod
                            regs = (a16[p:p + 4], h16[p:p + 4],
                                    a16[p + 4:p + 8], h16[p + 4:p + 8])
                            # a_i: row g (i < 4, 8 <= i < 12) or g + 8;
                            # column 4t + i % 4, plus 16 from i = 8
                            for i in range(16):
                                row = g + (8 if (i // 4) % 2 else 0)
                                col = 4 * t + (i & 3) + (16 if i >= 8 else 0)
                                A[row, col] = regs[i // 4][i % 4]
                            # b_i: row 4t + i % 4, plus 16 from i = 4;
                            # column g
                            for i in range(8):
                                Bm[4 * t + (i & 3) + (16 if i >= 4 else 0),
                                   g] = d16[p + i]
                        D += A @ Bm
                # c_i: row g (i < 2) or g + 8, column 2t + i % 2
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for i in range(4):
                        r = g + (8 if i >= 2 else 0)
                        ch = cb + 8 * tile + 2 * t + (i & 1)
                        if ch < B and n0 + r < nrows:
                            out[ch, off + n0 + r] += D[r, 2 * t + (i & 1)]
    lf.copy_(out.to(lf.dtype))


def group_lengths_reference(sites, neigh, N: int, cap: int = 32):
    """Plain version of the site kernel's cut (ops/site.py::group_lengths,
    same arguments and result, its groups at most 32 moves): prev[p], the
    latest of the 31 moves before p whose closed neighbourhood meets p's,
    then each glen from it."""
    s = sites.cpu().numpy().astype(np.int64)
    rows = neigh.cpu().numpy()
    n = s.shape[0]
    closed = np.concatenate([s[:, None], rows[s]], axis=1)   # [n, K + 1]
    prev = np.full(n, -1, dtype=np.int64)
    for off in range(1, min(32, n)):
        a, b = closed[off:], closed[:-off]
        meet = ((a[:, :, None] == b[:, None, :])
                & (b != N)[:, None, :]).any(axis=(1, 2))
        p = np.arange(off, n)
        new = meet & (prev[off:] < 0)
        prev[p[new]] = p[new] - off
    m = np.arange(n)
    glen = np.minimum(cap, n - m)
    for ell in range(cap - 1, 0, -1):
        inside = m + ell < n
        hit = np.zeros(n, dtype=bool)
        hit[inside] = prev[m[inside] + ell] >= m[inside]
        glen = np.where(hit, np.minimum(glen, ell), glen)
    return torch.as_tensor(glen.astype(np.int32))


def ranks_ahead(seed: int, chain0: int, B: int, cdf: torch.Tensor,
                move0: int, n_moves: int, batch: int = 32) -> torch.Tensor:
    """[n_moves, B] ranks as the sparse EO kernel draws them: at every
    `batch`-th move of a launch (counted from the launch's first move, not
    from move 0) the ranks of the next `batch` moves at once, a lane a move
    (csrc/eo_sparse.cu, eo_group.cuh rank_of)."""
    out = []
    for lo in range(0, n_moves, batch):
        words = prng.eo_rank_bits(seed, chain0, B, move0 + lo, batch, "cpu")
        ranks = torch.searchsorted(cdf, prng.to_uniform(words))
        out.append(ranks[:min(batch, n_moves - lo)])
    return torch.cat(out)


def coarse_select(half: torch.Tensor, rank: torch.Tensor,
                  tie_bits: torch.Tensor, nb: int, lo: float,
                  scale: float, listed: int = 32) -> torch.Tensor:
    """The sparse EO kernel's select on float32 keys (csrc/eo_sparse.cu,
    COARSE), row by row: the coarse bin floor((half - lo) * scale) clamped
    to [0, nb) in float32, the bin b of the rank's site by the histogram's
    running sum, then among the sites of bin b the key of rank rank - before:
    from the listed sites (at most `listed`) by counting smaller and equal
    keys, or else by four 8-bit radix passes over the biased keys of the
    bin's sites; then the tie race of that key's members. Returns [B]
    winners."""
    import rrrmc_tpu_torch.ops.eo as eo

    key = eo.sort_key(half)
    x = ((half - torch.tensor(lo, dtype=torch.float32))
         * torch.tensor(scale, dtype=torch.float32)).floor()
    bins = x.clamp(0, nb - 1).to(torch.int64)
    out = []
    for b in range(half.shape[0]):
        hist = torch.bincount(bins[b], minlength=nb)
        run = hist.cumsum(0)
        r = int(rank[b])
        sel = int((run <= r).sum())
        before = int(run[sel - 1]) if sel else 0
        sites = (bins[b] == sel).nonzero().flatten()
        keys = key[b, sites].to(torch.int64)
        rr = r - before
        if sites.numel() <= listed:
            lt = (keys[None, :] < keys[:, None]).sum(1)
            eq = (keys[None, :] == keys[:, None]).sum(1)
            v = int(keys[(lt <= rr) & (rr < lt + eq)][0])
        else:
            biased = (keys + 2 ** 31) & 0xFFFFFFFF
            prefix = pmask = 0
            for shift in (24, 16, 8, 0):
                ok = (biased & pmask) == prefix
                digit = torch.bincount((biased[ok] >> shift) & 255,
                                       minlength=256).cumsum(0)
                d = int((digit <= rr).sum())
                rr -= int(digit[d - 1]) if d else 0
                prefix |= d << shift
                pmask |= 255 << shift
            v = prefix - 2 ** 31
        member = key[b].to(torch.int64) == v
        score = torch.where(member, tie_bits[b].clamp(max=2 ** 31 - 2),
                            torch.tensor(2 ** 31 - 1, dtype=torch.int32))
        out.append(int(score.argmin()))
    return torch.tensor(out)
