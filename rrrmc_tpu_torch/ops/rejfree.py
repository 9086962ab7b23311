"""Rejection-free race moves (bkl / wtm / rrr) on sparse Pairwise models:
the CUDA kernel (csrc/rejfree_sparse.cu), its plain torch version, and the
eligibility rule.

Source note. The kernel replaces
rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_sparse_kernel (called by
`_pallas_rejfree_sparse_chunk`). Per move it makes two to five passes over
the chain's N sites (race, min and log-sum-exp of the Boltzmann terms, and
for rrr the same again on the flipped state) plus one Philox call per four
sites, so on the H100 it is bound by the arithmetic and the shared-memory
reads of those passes, with a handful of block barriers per move. The design
keeps each chain's spins and local fields resident in shared memory for the
whole chunk (one thread block per chain; 5 bytes per site, 50 KB at N=10^4),
so global memory is touched only at the chunk's start and end and for the
per-move stream rows. A flip updates only the winner's K neighbours through
its own table row, where the TPU kernel compared every site's K inverse
columns because it had no gather.

The same kernel is the port of
rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_kernel, the TPU race on integer
LatticeEA: to the race a lattice is a sparse Pairwise with K = 2D (LatticeEA
keeps the padded tables), and that kernel's roll identity for the local
fields existed only because Mosaic has no gather. The JAX package's switch
of small lattices (N <= _LATTICE_DENSE_MAX) to the dense matmul race kernel
is a VMEM heuristic and is not carried over: every integer lattice takes
this kernel (5 bytes per site, 20 KB at L=16, D=3).

The race: score_i = log(-log u_i) + beta_s * max(dE_i, 0) over the N
sites, with dE_i = 2 sigma_i lf_i the energy change of flipping site i and
beta_s = beta * model.scale (the kernel takes 2 beta_s and sigma_i lf_i),
winner = argmin (lowest index on ties), z from a shifted
log-sum-exp. bkl advances its coordinate by a geometric skip + 1, wtm by
exp(min score), rrr by one move and keeps the flip with probability
min(1, z / z'). Chains whose coordinate reached `target` make no move.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import check_args, prng
from ..core.dtypes import is_integer

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

MODES = {"bkl": 0, "wtm": 1, "rrr": 2}
#: threads of one block, one block per chain (kThreads of the kernel)
THREADS = 256
#: BKL skip cap: bounds coordinate growth so int32 never overflows (the
#: samplers keep iters <= 1e9)
SKIP_CAP = 1.0e9
#: float32(1 - 1e-6), the TPU kernel's cap on p in the geometric skip
_P_CAP = float(torch.tensor(1 - 1e-6, dtype=torch.float32))
_TINY = float(torch.tensor(1e-38, dtype=torch.float32))

BitsFn = Callable[[int, int], torch.Tensor]


def sparse_rejfree_ok(model) -> bool:
    """Eligibility of a model for the sparse race kernel (the JAX package's
    `_sparse_rejfree_ok` without its TPU size caps): a Pairwise model with
    N >= 8 whose couplings and fields are both integer, or both float and
    finite."""
    from ..models.pairwise import Pairwise

    if not (isinstance(model, Pairwise) and model.N >= 8):
        return False
    if is_integer(model.J):
        return is_integer(model.h)
    return bool(torch.isfinite(model.J).all() and torch.isfinite(model.h).all())


def coord_dtype(mode: str) -> torch.dtype:
    """wtm counts global time (float32); bkl and rrr count iterations."""
    return torch.float32 if mode == "wtm" else torch.int32


def _check_args(sigma, lf, E, coord, acc, zacc, neigh, J, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    B, N = sigma.shape
    K = neigh.shape[1]
    dt = torch.int32 if is_integer(J) else torch.float32
    want = {"sigma": (sigma, (B, N), torch.int8), "lf": (lf, (B, N), dt),
            "E": (E, (B,), dt), "coord": (coord, (B,), coord_dtype(mode)),
            "acc": (acc, (B,), torch.int32),
            "zacc": (zacc, (B,), torch.float32),
            "neigh": (neigh, (N, K), torch.int32), "J": (J, (N, K), dt)}
    check_args(want, sigma.device)


def rejfree_sparse_chunk(sigma, lf, E, coord, acc, zacc, neigh, J, *,
                         mode: str, n_moves: int, beta_s: float, target,
                         seed: int, move0: int = 0, chain0: int = 0,
                         bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` race moves, in place.

    sigma [B, N] int8 and lf [B, N] (int32 for integer J, else float32) are
    chain-major; E [B] (lf's dtype), coord [B] (int32, float32 for wtm),
    acc [B] int32 (applied flips) and zacc [B] float32 (summed z/N) are
    updated. neigh/J are the model's [N, K] tables (padding == N).
    beta_s = beta * model.scale. Returns the per-move streams
    (cs, es), each [n_moves, B]: coordinate and E after every move.

    Random words are Philox under key (seed, chain0 + b), counter
    (word, move0 + m, draw, 0) (see ops/prng.py). On a CUDA tensor this
    launches the kernel; on a CPU tensor it runs the plain version. `bits`
    (move, draw) -> int32 ([B, N] for the race, [B] otherwise) replaces the
    generator and is taken by the plain version only."""
    global LAUNCHES
    _check_args(sigma, lf, E, coord, acc, zacc, neigh, J, mode)
    if sigma.device.type == "cpu":
        return rejfree_sparse_chunk_reference(
            sigma, lf, E, coord, acc, zacc, neigh, J, mode=mode,
            n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
            move0=move0, chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no race kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    B, N = sigma.shape
    K = neigh.shape[1]
    dev = sigma.device
    smem = lib.rrrmc_rejfree_sparse_smem(N, K)
    cap = lib.rrrmc_rejfree_sparse_max_smem(dev.index or 0)
    if smem > cap:
        raise NotImplementedError(
            f"the sparse race kernel keeps a chain's spins and local fields "
            f"in shared memory: N={N} needs {smem} bytes, a block may have "
            f"{cap}; sparse state in global memory is not ported yet "
            f"(ROADMAP.md queue 2, item 1)")
    ct = coord_dtype(mode)
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=lf.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_sparse(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            neigh.data_ptr(), J.data_ptr(), N, K, B, n_moves,
            seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            2.0 * beta_s, int(target) if ct == torch.int32 else 0,
            float(target),
            MODES[mode], 0 if is_integer(J) else 1,
            torch.cuda.current_stream().cuda_stream)
    check(err, "rejfree_sparse launch")
    LAUNCHES += 1
    return cs, es


def block_sum(x):
    """Row sums of x [B, N] float32 in the kernel's order of additions:
    thread t of a block adds sites t, t + THREADS, ... in turn; each warp
    folds its 32 partial sums pairwise (lane l with lane l + 16, then
    l + 8, ..., 1); the warps' sums are then added in turn. With the same
    order z is bit-equal to the kernel's, and so are the bkl skip, the rrr
    acceptance and z/N that depend on it."""
    B, N = x.shape
    per = -(-N // THREADS)
    x = torch.nn.functional.pad(x, (0, per * THREADS - N))
    x = x.view(B, per, THREADS)
    s = x[:, 0]
    for p in range(1, per):
        s = s + x[:, p]
    s = s.view(B, THREADS // 32, 32)
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    s = s[..., 0]
    out = s[:, 0]
    for w in range(1, THREADS // 32):
        out = out + s[:, w]
    return out


def _log_z(dE, beta_s):
    """(bE, log z): bE = beta_s*max(dE, 0) and the shifted log-sum-exp of
    -bE over the sites, summed as the kernel sums."""
    bE = beta_s * dE.clamp(min=0).to(torch.float32)
    m = bE.min(dim=1).values
    zs = block_sum(torch.exp(m[:, None] - bE))
    return bE, torch.log(zs) - m


def pair_de(sig, lf):
    """The energy change of flipping each site of a pairwise model or a
    PSpin3, 2 sigma lf: bit for bit twice the kernels' key sigma lf, so
    beta_s * max(dE, 0) equals their 2 beta_s * max(sigma lf, 0) in
    float32."""
    return 2 * sig * lf


def _geom_skip(u2, p):
    """Geometric rejected-iteration count with success probability p,
    capped so int32 never overflows (the TPU kernel's `_geom_skip`)."""
    denom = torch.log1p(-p.clamp(max=_P_CAP))
    sk = torch.floor(torch.log((1 - u2).clamp(min=_TINY)) / denom)
    skip = sk.clamp(max=SKIP_CAP).to(torch.int32)
    return torch.where(p >= 1.0, torch.zeros_like(skip), skip)


def rejfree_sparse_chunk_reference(sigma, lf, E, coord, acc, zacc, neigh, J,
                                   *, mode: str, n_moves: int, beta_s: float,
                                   target, seed: int, move0: int = 0,
                                   chain0: int = 0,
                                   bits: Optional[BitsFn] = None):
    """Plain torch version of the race kernel, move by move over [B, N]
    tensors (same arguments, in-place contract and streams as
    `rejfree_sparse_chunk`)."""
    B, N = sigma.shape
    K = neigh.shape[1]
    rows = torch.arange(B, device=sigma.device)

    def lf_flipped(sig, lf, win, d, do):
        """A copy of lf with the winner's K neighbours updated where do."""
        lf = lf.clone()
        nb = neigh[win].long()
        jr = J[win]
        for k in range(K):
            sel = do & (nb[:, k] < N)
            lf[rows[sel], nb[sel, k]] += jr[sel, k] * d[sel]
        return lf

    return race_chunk_reference(
        sigma, lf, E, coord, acc, zacc, lf_flipped, mode=mode,
        n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
        move0=move0, chain0=chain0, bits=bits)


def race_chunk_reference(sigma, lf, E, coord, acc, zacc, lf_flipped, *,
                         mode: str, n_moves: int, beta_s: float, target,
                         seed: int, move0: int = 0, chain0: int = 0,
                         bits: Optional[BitsFn] = None,
                         de_of: Callable = pair_de):
    """The race moves of the race kernels' plain versions, over [B, N]
    spins. lf is the chain's resident state (local fields, cavity sums, or
    SAT's clause counts); `lf_flipped(sig, lf, win, d, do)` returns a copy of
    it with the winner win [B] flipped (d = -2 sigma_win, sig the spins
    before the flip, in lf's dtype) in the chains where do. Site i races
    with the energy change of its flip dE_i = de_of(sig, lf)[:, i]
    (2 sigma_i lf_i by default) and the Boltzmann exponent
    beta_s * max(dE_i, 0). E (lf's dtype, or float32 physical energies
    for the replica composites) gains the dE of each applied flip."""
    B, N = sigma.shape
    dev = sigma.device
    lt = lf.dtype
    rows = torch.arange(B, device=dev)
    beta = torch.tensor(beta_s, dtype=torch.float32, device=dev)
    log_n = torch.log(torch.tensor(float(N), dtype=torch.float32, device=dev))
    zero = torch.zeros((), dtype=E.dtype, device=dev)
    sig = sigma.to(lt)
    cs = torch.empty((n_moves, B), dtype=coord.dtype, device=dev)
    es = torch.empty((n_moves, B), dtype=E.dtype, device=dev)

    def draws(d):
        """Iterator over the moves' bits of draw id d."""
        if bits is not None:
            return map(lambda m: bits(m, d), range(n_moves))
        if d == prng.DRAW_RACE:
            block = max(1, min(64, (1 << 18) // (B * N)))
            return prng.per_move(lambda lo, n: prng.race_bits(
                seed, chain0, B, N, move0 + lo, n, dev), n_moves, block)
        return prng.per_move(lambda lo, n: prng.draw_bits(
            seed, chain0, B, move0 + lo, n, d, dev), n_moves, 256)

    race = draws(prng.DRAW_RACE)
    second = draws(prng.DRAW_ACCEPT if mode == "rrr" else prng.DRAW_SKIP)

    def flipped(sig, lf, win, s_w, d, do):
        """Copies of (sig, lf) with the winner flipped where `do`."""
        sig2 = sig.clone()
        sig2[rows[do], win[do]] = -s_w[do]
        return sig2, lf_flipped(sig, lf, win, d, do)

    for m in range(n_moves):
        active = coord < target
        if not bool(active.any()):
            # every chain is done: the remaining stream rows repeat
            cs[m:] = coord
            es[m:] = E
            break
        de = de_of(sig, lf)
        bE, logz = _log_z(de, beta)
        u = prng.to_uniform(next(race))
        score = torch.log(-torch.log(u)) + bE
        mrow, win = score.min(dim=1)          # first index among equal mins
        s_w = sig[rows, win]
        dE = de[rows, win]
        z_over_n = torch.exp(logz - log_n)
        zacc += torch.where(active, z_over_n, 0.0)
        d = -2 * s_w
        if mode == "rrr":
            sig2, lf2 = flipped(sig, lf, win, s_w, d, active)
            _, logz2 = _log_z(de_of(sig2, lf2), beta)
            ua = prng.to_uniform(next(second))
            do = active & (torch.log(ua) < logz - logz2)
            sig = torch.where(do[:, None], sig2, sig)
            lf.copy_(torch.where(do[:, None], lf2, lf))
            E += torch.where(do, dE, zero)
            coord += active.to(coord.dtype)
            acc += do.to(torch.int32)
        else:
            sig, lf2 = flipped(sig, lf, win, s_w, d, active)
            lf.copy_(lf2)
            E += torch.where(active, dE, zero)
            acc += active.to(torch.int32)
            if mode == "wtm":
                coord += torch.where(active, torch.exp(mrow), 0.0)
            else:
                u2 = prng.to_uniform(next(second))
                coord += torch.where(active, _geom_skip(u2, z_over_n) + 1, 0)
        cs[m] = coord
        es[m] = E
    sigma.copy_(sig.to(torch.int8))
    return cs, es
