"""Rejection-free race moves (bkl / wtm / rrr) on sparse Pairwise models:
the CUDA kernel (csrc/rejfree_sparse.cu), its plain torch version, the
eligibility rule, and the launch rule of the fused race kernels
(rejfree_sparse.cu, rejfree_dense.cu, rejfree_replica.cu, rejfree_sat.cu,
rejfree_perc.cu).

Source note. The kernel replaces
rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_sparse_kernel (called by
`_pallas_rejfree_sparse_chunk`). Per move it makes one fused pass over the
chain's N sites (csrc/race.cuh::fused_pass: the race, min bE and the
log-sum-exp of the Boltzmann terms from one evaluation of each site; rrr
adds a second pass for z' on the flipped state) with one Philox call per
four sites, so on the H100 it is bound by the arithmetic and the
shared-memory reads of that pass, with a barrier or two per pass. The
design keeps each chain's spins and local fields resident in shared memory
for the whole chunk (one thread block per chain; the fields in the
narrowest integer type their bound allows, 2 bytes per site at N=10^4 on a
+-J graph), so global memory is touched only at the chunk's start and end
and for the per-move stream rows. A flip updates only the winner's K
neighbours through its own table row, where the TPU kernel compared every
site's K inverse columns because it had no gather.

The launch rule (`resident_dtype`, `race_threads`, `fused_plan`): the
wrapper keeps the fields resident as int8, int16 or int32 by the bound on
|lf| it is given (`field_bound`: samplers/families.py computes it from the
model, the largest row sum of |J| plus |h|; none given: int32), float32 for
float couplings; global lf stays int32. It then takes the block size T from
the chains and the blocks of each size that fit on an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor): 512 threads while the
blocks of all chains are resident at once and a chain has at least
MIN_SITES_PER_THREAD sites a thread, else 256 (1024 threads never beat
512 on the H100, PERF.md section 6, and are not built). The plain
version adds z in the order of the T it is given.

The same kernel is the port of
rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_kernel, the TPU race on integer
LatticeEA: to the race a lattice is a sparse Pairwise with K = 2D (LatticeEA
keeps the padded tables), and that kernel's roll identity for the local
fields existed only because Mosaic has no gather. The JAX package's switch
of small lattices (N <= _LATTICE_DENSE_MAX) to the dense matmul race kernel
is a VMEM heuristic and is not carried over: every integer lattice takes
this kernel (2 bytes per site at int8, 8 KB at L=16, D=3).

The race: score_i = log(-log u_i) + beta_s * max(dE_i, 0) over the N
sites, with dE_i = 2 sigma_i lf_i the energy change of flipping site i and
beta_s = beta * model.scale (the kernel takes 2 beta_s and sigma_i lf_i),
winner = argmin (lowest index on ties), z from a shifted
log-sum-exp. bkl advances its coordinate by a geometric skip + 1, wtm by
exp(min score), rrr by one move and keeps the flip with probability
min(1, z / z'). Chains whose coordinate reached `target` make no move.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch

from . import check_args, launch, prng
from ..core.dtypes import is_integer
from ..utils.profiling import spanned

MODES = {"bkl": 0, "wtm": 1, "rrr": 2}
#: the plain versions' default block size, whose order of additions they
#: keep (the smaller of FUSED_THREADS)
THREADS = 256
#: the block sizes the fused race kernels are built for
FUSED_THREADS = (256, 512)
#: the fewest sites a thread at which the larger block pays: below it, the
#: reductions and barriers of a move over more warps cost more than the
#: split of the pass saves. On the H100 (PERF.md section 6,
#: scripts/torch_race_timing.py --sweep) 512 threads ran 15% slower than
#: 256 at 2 sites a thread (the perceptron, 1023 sites, 256 chains) and
#: 12-24% faster at 4, 5.9, 8 and 11.7 (K-SAT and the step perceptron, 128
#: chains); between 2 and 4 nothing was measured, and 3 is the midpoint
MIN_SITES_PER_THREAD = 3
#: the fused kernels' codes of the resident field types
FIELD_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2,
               torch.float32: 3}
#: the block size `pinned_threads` holds every fused launch to (None: the
#: launch rule's)
_PINNED: Optional[int] = None
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


def resident_dtype(integer: bool, bound: Optional[int]) -> torch.dtype:
    """The resident type of a fused race's fields: float32 for float
    couplings, else the narrowest integer type that holds every |value| <=
    `bound` (None: no bound known, int32)."""
    if not integer:
        return torch.float32
    if bound is None or bound > 32767:
        return torch.int32
    return torch.int8 if bound <= 127 else torch.int16


def race_threads(B: int, n_sm: int, blocks_per_sm: dict, N: int) -> int:
    """The block size of a fused race launch of B chains of N sites: the
    largest T at which all B blocks are resident at once on the n_sm SMs
    (`blocks_per_sm`: {T: blocks of T threads that fit on an SM, 0 if
    none}) and, but for the smallest T, each thread has at least
    MIN_SITES_PER_THREAD sites; else the smallest T that fits."""
    fits = sorted(t for t, n in blocks_per_sm.items() if n > 0)
    for t in reversed(fits):
        if B <= n_sm * blocks_per_sm[t] and (
                t == fits[0] or N >= MIN_SITES_PER_THREAD * t):
            return t
    return fits[0]


def fused_plan(kernel: str, info: Callable, B: int, N: int, need: int,
               field: torch.dtype, n_sm: int) -> dict:
    """The plan of a fused race launch of B chains of N sites on n_sm SMs:
    the block size (`race_threads`, or the pinned one) and the resident
    `field` type. info(T, need) gives the instantiation's [blocks per SM,
    registers, local bytes, static shared bytes, most dynamic shared
    bytes] at `need` dynamic bytes; where no size fits, require_smem
    refuses."""
    facts = {t: info(t, need) for t in FUSED_THREADS}
    blocks = {t: (f[0] if need <= f[4] else 0) for t, f in facts.items()}
    if not any(blocks.values()):
        launch.require_smem(need, max(f[4] for f in facts.values()), N, kernel)
        raise RuntimeError(f"{kernel}: no block size fits ({facts})")
    if _PINNED is not None:
        if not blocks.get(_PINNED):
            raise ValueError(f"{kernel}: {_PINNED} threads a block do not "
                             f"fit at {need} shared bytes ({facts})")
        threads = _PINNED
    else:
        threads = race_threads(B, n_sm, blocks, N)
    f = facts[threads]
    return {"kernel": kernel, "threads": threads,
            "field": str(field).replace("torch.", ""), "blocks_per_sm": f[0],
            "smem": need, "registers": f[1], "spill_bytes": f[2]}


def race_plan(kernel: str, entry: str, head: tuple, B: int, N: int,
              need: int, field: torch.dtype, device: int, **extra) -> dict:
    """`fused_plan` on the facts of the C entry `entry` (with `head`) on
    CUDA device `device`, recorded with `extra` in launch.PLANS."""
    plan = fused_plan(kernel, launch.info(entry, head, device), B, N, need,
                      field, launch.sm_count(device))
    return launch.record(kernel, {**plan, **extra})


@contextlib.contextmanager
def pinned_threads(threads: Optional[int]) -> Iterator[None]:
    """Within the block, every fused race launch takes `threads` threads a
    block (one of FUSED_THREADS; a ValueError at launch where it does not
    fit), whatever the launch rule would pick; None leaves the rule. For
    the checks and timings of a kernel at the block size its path does not
    pick (chip_smoke.py, scripts/torch_race_timing.py)."""
    global _PINNED
    if threads is not None and threads not in FUSED_THREADS:
        raise ValueError(f"threads must be one of {FUSED_THREADS}, "
                         f"got {threads}")
    before, _PINNED = _PINNED, threads
    try:
        yield
    finally:
        _PINNED = before


@spanned("rrrmc.op.rejfree_sparse")
def rejfree_sparse_chunk(sigma, lf, E, coord, acc, zacc, neigh, J, *,
                         mode: str, n_moves: int, beta_s: float, target,
                         seed: int, move0: int = 0, chain0: int = 0,
                         bits: Optional[BitsFn] = None,
                         field_bound: Optional[int] = None):
    """Advance every chain by `n_moves` race moves, in place.

    sigma [B, N] int8 and lf [B, N] (int32 for integer J, else float32) are
    chain-major; E [B] (lf's dtype), coord [B] (int32, float32 for wtm),
    acc [B] int32 (applied flips) and zacc [B] float32 (summed z/N) are
    updated. neigh/J are the model's [N, K] tables (padding == N), and
    `field_bound` a bound on |lf| over every configuration (the family's,
    samplers/families.py; None: int32 resident fields for integer J).
    beta_s = beta * model.scale. Returns the per-move streams
    (cs, es), each [n_moves, B]: coordinate and E after every move.

    Random words are Philox under key (seed, chain0 + b), counter
    (word, move0 + m, draw, 0) (see ops/prng.py). On a CUDA tensor this
    launches the kernel with the launch rule's block size (`fused_plan`);
    on a CPU tensor it runs the plain version. `bits`
    (move, draw) -> int32 ([B, N] for the race, [B] otherwise) replaces the
    generator and is taken by the plain version only."""
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
    from .cuda_build import library

    lib = library()
    B, N = sigma.shape
    K = neigh.shape[1]
    dev = sigma.device
    ct = coord_dtype(mode)
    field = resident_dtype(is_integer(J), field_bound)
    T = race_plan("rejfree_sparse", "rrrmc_rejfree_sparse_info",
                  (FIELD_CODES[field], int(mode == "wtm")), B, N,
                  lib.rrrmc_rejfree_sparse_smem(N, K, field.itemsize), field,
                  dev.index or 0)["threads"]
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=lf.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_sparse(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            neigh.data_ptr(), J.data_ptr(), N, K, B, n_moves,
            seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            2.0 * beta_s, int(target) if ct == torch.int32 else 0,
            float(target), MODES[mode], 0, T, FIELD_CODES[field],
            torch.cuda.current_stream().cuda_stream)
    launch.launched("rejfree_sparse", err)
    return cs, es


def block_sum(x, threads: int = THREADS):
    """Row sums of x [B, N] float32 in the kernels' order of additions with
    `threads` threads a block: thread t adds sites t, t + threads, ... in
    turn; each warp folds its 32 partial sums pairwise (lane l with lane
    l + 16, then l + 8, ..., 1); the warps' sums are then added in turn.
    With the same order z is bit-equal to the kernel's, and so are the bkl
    skip, the rrr acceptance and z/N that depend on it."""
    B, N = x.shape
    per = -(-N // threads)
    x = torch.nn.functional.pad(x, (0, per * threads - N))
    x = x.view(B, per, threads)
    s = x[:, 0]
    for p in range(1, per):
        s = s + x[:, p]
    s = s.view(B, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    s = s[..., 0]
    out = s[:, 0]
    for w in range(1, threads // 32):
        out = out + s[:, w]
    return out


def _log_z(dE, beta_s, threads: int = THREADS):
    """(bE, log z): bE = beta_s*max(dE, 0) and the shifted log-sum-exp of
    -bE over the sites, summed as race.cuh's log_z sums (a min pass, then
    the sum of exp(min - bE))."""
    bE = beta_s * dE.clamp(min=0).to(torch.float32)
    m = bE.min(dim=1).values
    zs = block_sum(torch.exp(m[:, None] - bE), threads)
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
                                   bits: Optional[BitsFn] = None,
                                   threads: int = THREADS):
    """Plain torch version of the race kernel, move by move over [B, N]
    tensors (same arguments, in-place contract and streams as
    `rejfree_sparse_chunk`; z summed as the kernel's fused pass sums it
    with `threads` threads a block)."""
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
        move0=move0, chain0=chain0, bits=bits, threads=threads)


def race_chunk_reference(sigma, lf, E, coord, acc, zacc, lf_flipped, *,
                         mode: str, n_moves: int, beta_s: float, target,
                         seed: int, move0: int = 0, chain0: int = 0,
                         bits: Optional[BitsFn] = None,
                         de_of: Callable = pair_de,
                         threads: int = THREADS):
    """The race moves of the race kernels' plain versions, over [B, N]
    spins. lf is the chain's resident state (local fields, cavity sums, or
    SAT's clause counts); `lf_flipped(sig, lf, win, d, do)` returns a copy of
    it with the winner win [B] flipped (d = -2 sigma_win, sig the spins
    before the flip, in lf's dtype) in the chains where do. Site i races
    with the energy change of its flip dE_i = de_of(sig, lf)[:, i]
    (2 sigma_i lf_i by default) and the Boltzmann exponent
    beta_s * max(dE_i, 0). E (lf's dtype, or float32 physical energies
    for the replica composites) gains the dE of each applied flip. z is
    summed as a block of `threads` threads sums it (`_log_z`)."""
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
        bE, logz = _log_z(de, beta, threads)
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
            _, logz2 = _log_z(de_of(sig2, lf2), beta, threads)
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
