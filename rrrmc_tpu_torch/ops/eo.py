"""tau-extremal optimisation (EO) moves on sparse Pairwise models, EA
lattices included: the CUDA kernel (csrc/eo_sparse.cu), its plain torch
version, the launch plan of the three kernels on csrc/eo_chain.cuh's move
loop (sparse, dense: ops/eo_dense.py, K-SAT: ops/eo_sat.py), and the move
loop and the order-statistic select of every EO kernel's plain version.

Source note. The kernel replaces rrrmc_tpu/ops/eo_pallas.py::
_eo_sparse_kernel (launched by `_pallas_eo_sparse_run`) and the lattice
branch of that file's `_eo_kernel` (`_pallas_eo_run` with dense=False): to
EO a LatticeEA is a sparse Pairwise with K = 2D and its padded tables, as the
lattice race was folded into the sparse race (ops/rejfree.py). The TPU found
the order statistic by up to 32 counting passes over the chain block, since
Mosaic has no gather. Here each chain keeps its keys half_i = sigma_i lf_i
(in the narrowest type the bound on |half| allows: `key_type`), its spins
and best spins (as bits) and a histogram of its keys resident in shared
memory for the whole launch. A flip moves the K + 1 changed keys between
bins, so the select is a scan of the histogram: exact bins for integer keys
of a range of at most HIST_MAX values, coarse monotone bins for the others
(then the sites of the selected bin are collected and the key selected
exactly among them). The rank draws are made 32 moves ahead. `eo_plan`
sizes the group of threads that runs a chain: one warp, four chains a
block, for small chains (no block barrier in a move), or a block of 4, 8 or
32 warps where a chain has many sites and few chains share an SM. What bounds
it on the H100 is the tie race's Philox calls, one for each group of four
sites that holds a member of the selected class, and the pass over the
keys (csrc/eo_sparse.cu).

The move (the TPU kernels' law, the same on every route of the port):
half_i = sigma_i lf_i and dE_i = 2 half_i; the rank is #{i : cdf_i < u}
with u from the Philox rank draw and cdf the float32 cast of the float64
cumulative k^-tau table; v is the (rank+1)-th smallest key (half for integer
couplings, the monotone int32 key of the float32 half otherwise, so -0.0
sorts below +0.0); among the sites whose key equals v the smallest score
min(bits_i, INT32_MAX - 1) wins, bits_i the signed Philox tie word, the
lowest index among equal scores; the winner flips unconditionally, and
E < Emin (strict) records Emin, sigma_min and itmin = move0 + m + 1.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import check_args, launch, prng
from .rejfree import pair_de
from ..core.dtypes import is_integer
from ..utils.profiling import spanned

#: the most bins of the kernels' integer histogram select (kEoHistMax)
HIST_MAX = 4096
_I32_MAX = 2 ** 31 - 1
#: the warps a chain the sparse EO kernel is built for (csrc/eo_sparse.cu):
#: one warp, WARP_CHAINS chains a block, or one chain a block of 4, 8 or 32
EO_WARPS = (1, 4, 8, 32)
#: chains a block of the one-warp route (kWarpChains)
WARP_CHAINS = 4
#: the sparse EO kernel's key types, by its codes: int8 / int16 keys with
#: exact histogram bins, int32 / float32 keys with coarse bins
KEY_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2,
             torch.float32: 3}
#: the coarse bins of int32 and float32 keys (32 super-bins of 32)
COARSE_BINS = 1024
#: entries of a warp's queue of member groups (kTieQueue)
TIE_QUEUE = 192
#: the warps an SM the plan aims at, and the fewest sites a lane of a
#: chain
WARPS_PER_SM = 16
MIN_SITES_PER_LANE = 6
#: the most sites a lane of the dense EO kernel's plan (ops/eo_dense.py)
DENSE_SITES_PER_LANE = 40
#: the last run of `eo_chunk_reference`: its chain-moves and the groups of
#: four sites (i // 4) that held a member of the selected class where it
#: had more than one (a class of one site wins without a draw), summed over
#: them: the tie race's Philox calls beside the rank draw, the work the law
#: needs (chip_smoke.py's bound counts them)
TIE_GROUPS = {"chain_moves": 0, "groups": 0}

BitsFn = Callable[[int, int], torch.Tensor]


def hist_bins(integer: bool, half_max: Optional[int]) -> int:
    """The kernels' select: 2*half_max + 1 histogram bins for integer keys
    bounded by half_max when that is at most HIST_MAX, else 0 (the radix
    select)."""
    if not integer or half_max is None or 2 * half_max + 1 > HIST_MAX:
        return 0
    return 2 * int(half_max) + 1


def key_bins(key_max: int, what: str) -> int:
    """The histogram of the hypergraph EO kernels, whose integer keys obey
    |key| <= key_max by their tables' shape: 2*key_max + 1 bins, or
    NotImplementedError above HIST_MAX (they take no radix select)."""
    bins = 2 * int(key_max) + 1
    if bins > HIST_MAX:
        raise NotImplementedError(
            f"the {what} EO kernel counts its keys |key| <= {key_max} in "
            f"{bins} histogram bins, more than {HIST_MAX}")
    return bins


def key_type(integer: bool, half_max: Optional[int]) -> torch.dtype:
    """The resident type of the sparse EO kernel's keys half = sigma lf:
    float32 for float couplings; int8 or int16 for integer keys bounded by
    half_max (|half| <= 127, or with at most HIST_MAX histogram bins);
    else int32 (no bound, or a wider one)."""
    if not integer:
        return torch.float32
    if hist_bins(True, half_max) == 0:
        return torch.int32
    return torch.int8 if half_max <= 127 else torch.int16


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def chain_bytes(N: int, key: torch.dtype, nb: int, warps: int,
                extra: int = 0) -> int:
    """Shared bytes of one chain of the EO kernels of csrc/eo_chain.cuh
    (eo_layout): the keys (N rounded up to 4), the spins and best spins as
    bits, the nb bins and their super-bins (more than 32 bins), a queue of
    TIE_QUEUE member groups and a (score, index) slot a warp, for the
    coarse select the listed sites of two moves and 256 radix counters, and
    `extra` bytes of the kernel's own (K-SAT: its counts); each part
    16-byte aligned."""
    coarse = key in (torch.int32, torch.float32)
    words = -(-N // 32)
    nsup = -(-nb // 32) if nb > 32 else 0
    return (_align16(-(-N // 4) * 4 * key.itemsize) + 2 * _align16(4 * words)
            + _align16(4 * nb) + _align16(4 * nsup) + 4 * TIE_QUEUE * warps
            + _align16(8 * warps)
            + (_align16(2 * 32 * 8 + 2 * 4) + 256 * 4 if coarse else 0)
            + _align16(extra))


def eo_plan(N: int, B: int, key: torch.dtype, nb: int, n_sm: int,
            info: Callable, *, extra: int = 0, what: str = "sparse EO",
            sites_per_lane: Optional[int] = None) -> dict:
    """The launch plan of an EO kernel of csrc/eo_chain.cuh (the sparse,
    dense and K-SAT ones) for B chains of N sites with keys of type `key`
    in nb bins and `extra` bytes of its own a chain. info(W, need) gives
    the instantiation of W warps a chain: [blocks per SM, registers, local
    bytes, static shared bytes, most dynamic shared bytes] at `need`
    dynamic bytes. Of the W of EO_WARPS whose block fits (none:
    NotImplementedError), those with at least MIN_SITES_PER_LANE sites a
    lane (none: the smallest that fits) and at most two waves of chains on
    the n_sm SMs (or the fewest): the smallest W at which the chains an SM
    holds at once give WARPS_PER_SM warps, else the largest. Measured on
    the H100 (PERF.md section 6, the EO kernels' warps a chain): a chain's
    move is a chain of dependent steps, so more warps a chain pay only while
    the SM is short of warps; GraphRRG(10^4) at 1024 chains ran fastest on
    4 warps (20 an SM), at 128 chains on 32, the EA-3D L=8 lattice (512
    sites) on one. With `sites_per_lane` (the dense kernel, whose flip
    walks all N sites) the rule is the fewest W of the candidates with
    enough sites a lane that give a lane at most that many sites, else the
    largest, whatever the waves: GraphSK(1024) at 1024 chains ran fastest
    on one warp, densify(GraphRRG(10^4)) on 8 (three waves, against 4 on
    two), GraphSKNormal(4096) at 512 chains on 4 (DENSE_SITES_PER_LANE)."""
    def chains(w):
        return WARP_CHAINS if w == 1 else 1

    need = {w: chains(w) * chain_bytes(N, key, nb, w, extra)
            for w in EO_WARPS}
    facts = {w: info(w, need[w]) for w in EO_WARPS}
    fits = [w for w in EO_WARPS if need[w] <= facts[w][4] and facts[w][0] > 0]
    if not fits:
        w = min(EO_WARPS, key=lambda w: need[w])
        launch.require_smem(need[w], max(f[4] for f in facts.values()), N,
                            what)
        raise NotImplementedError(f"{what}: no block fits ({facts})")
    per_sm = -(-B // n_sm)

    def waves(w):
        return -(-B // (n_sm * facts[w][0] * chains(w)))

    def warps_per_sm(w):
        return min(per_sm, facts[w][0] * chains(w)) * w

    cands = [w for w in fits if N >= MIN_SITES_PER_LANE * 32 * w] \
        or [min(fits)]
    most = max(2, min(waves(w) for w in cands))
    if sites_per_lane is not None:
        full = [w for w in cands if N <= sites_per_lane * 32 * w]
    else:
        cands = [w for w in cands if waves(w) <= most]
        full = [w for w in cands if warps_per_sm(w) >= WARPS_PER_SM]
    w = min(full) if full else max(cands)
    f = facts[w]
    coarse = key in (torch.int32, torch.float32)
    return {"route": "warp" if w == 1 else "block", "warps": w,
            "chains": chains(w), "threads": 32 * w * chains(w),
            "key": str(key).replace("torch.", ""),
            "select": "coarse" if coarse else "histogram", "bins": nb,
            "smem": need[w], "blocks_per_sm": f[0], "registers": f[1],
            "spill_bytes": f[2], "waves": waves(w)}


def coarse_map(key: torch.dtype, nb: int, half_max: Optional[int], J, lf):
    """(lo, scale) of the coarse bins, floor((x - lo) * scale) clamped to
    [0, nb), x = float(half): nb equal bins over [-H, H], H = half_max for
    int32 keys, else the largest row sum of |J| (J None: none) or |lf| of
    the start. Any (lo, scale) gives the same moves (the bins are monotone
    in the key and keys outside the range fall into the end bins); a range
    that fits the keys keeps the bins sparse, so the select lists their
    sites."""
    if key == torch.int32 and half_max is not None:
        H = float(half_max) + 0.5
    else:
        H = max(float(J.abs().double().sum(1).max())
                if J is not None and J.numel() else 0.0,
                float(lf.abs().max()) if lf.numel() else 0.0)
    H = max(H, 1.0)
    return -H, nb / (2.0 * H)


def planned(what: str, info_entry: str, head: tuple, smem_of: Callable,
            N: int, B: int, key: torch.dtype, nb: int, dev,
            label: str = "sparse EO", **rule) -> dict:
    """The `eo_plan` of an EO kernel of csrc/eo_chain.cuh on device dev
    (`rule`: its extra bytes and sites a lane), its instantiations' facts
    from the C entry `info_entry` (with the key code and flags `head`),
    checked against the kernel's own shared bytes smem_of(W), and recorded
    in launch.PLANS under the kernel's name `what`."""
    dev_i = dev.index or 0
    plan = eo_plan(N, B, key, nb, launch.sm_count(dev_i),
                   launch.info(info_entry, head, dev_i), what=label, **rule)
    smem = smem_of(plan["warps"])
    if smem != plan["smem"]:
        raise RuntimeError(f"{what}: the kernel's shared bytes {smem} differ "
                           f"from the plan's {plan['smem']}")
    return launch.record(what, {"kernel": what, **plan})


def sparse_launch(what: str, sigma, lf, E, emin, smin, itmin, neigh, J, cdf,
                  *, n_moves: int, seed: int, move0: int, chain0: int,
                  key: torch.dtype, nb: int, pspin: bool,
                  half_max: Optional[int] = None):
    """Plan and launch the sparse EO kernel (eo_sparse.cu) on CUDA tensors:
    neigh [N, K] int32 (PSpin3: the partner table read as [N, 2K']) and J
    (None for PSpin3); keys of type `key` in nb bins. Records the plan and
    the launch under `what`."""
    from .cuda_build import library

    lib = library()
    B, N = sigma.shape
    dev = sigma.device
    code = KEY_CODES[key]
    K = neigh.shape[1] if neigh.dim() == 2 else 2 * neigh.shape[1]
    plan = planned(what, "rrrmc_eo_sparse_info", (code, int(pspin)),
                   lambda w: lib.rrrmc_eo_sparse_smem(N, code, nb, w), N, B,
                   key, nb, dev)
    W = plan["warps"]
    lo, scale = (coarse_map(key, nb, half_max, J, lf)
                 if plan["select"] == "coarse" else (0.0, 0.0))
    with torch.cuda.device(dev):
        err = lib.rrrmc_eo_sparse(
            *launch_args(sigma, lf, E, emin, smin, itmin), neigh.data_ptr(),
            J.data_ptr() if J is not None else None, cdf.data_ptr(), N, K,
            B, n_moves, seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF,
            chain0 & 0xFFFFFFFF, code, int(pspin), nb, lo, scale, W,
            torch.cuda.current_stream().cuda_stream)
    launch.launched(what, err)


def sort_key(half: torch.Tensor) -> torch.Tensor:
    """The select's int32 key: half itself for integers; for float32 the
    monotone key of its bits, b ^ ((b >> 31) & 0x7fffffff)."""
    if is_integer(half):
        return half
    b = half.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def select_rank_with_ties(key: torch.Tensor, rank: torch.Tensor,
                          tie_bits: torch.Tensor) -> torch.Tensor:
    """[B] index of the rank[b]-th smallest (0-based) entry of each row of
    key [B, N], uniformly random among equal values: the race of the scores
    min(tie_bits, INT32_MAX - 1) over the entries equal to it, the smallest
    score winning and the lowest index among equal scores."""
    v = key.sort(dim=1).values.gather(1, rank[:, None].long())
    imax = torch.tensor(_I32_MAX, dtype=torch.int32, device=key.device)
    score = torch.where(key == v, tie_bits.clamp(max=_I32_MAX - 1), imax)
    return score.argmin(dim=1)


def eo_draws(seed: int, chain0: int, B: int, N: int, move0: int,
             n_moves: int, device, bits: Optional[BitsFn] = None):
    """Iterators over the moves' rank draws [B] and tie-race bits [B, N]:
    the Philox streams of the moves move0 .. move0 + n_moves - 1, or
    bits(m, draw) where given."""
    if bits is not None:
        return (map(lambda m: bits(m, prng.DRAW_EO_RANK), range(n_moves)),
                map(lambda m: bits(m, prng.DRAW_EO_TIE), range(n_moves)))
    block = max(1, min(64, (1 << 18) // (B * N)))
    return (prng.per_move(lambda lo, n: prng.eo_rank_bits(
                seed, chain0, B, move0 + lo, n, device), n_moves, 256),
            prng.per_move(lambda lo, n: prng.eo_tie_bits(
                seed, chain0, B, N, move0 + lo, n, device), n_moves, block))


def _check_args(sigma, lf, E, emin, smin, itmin, cdf, tables: dict):
    B, N = sigma.shape
    dt = lf.dtype
    if dt not in (torch.int32, torch.float32):
        raise ValueError(f"lf: expected int32 or float32, got {dt}")
    want = {"sigma": (sigma, (B, N), torch.int8), "lf": (lf, (B, N), dt),
            "E": (E, (B,), dt), "emin": (emin, (B,), dt),
            "smin": (smin, (B, N), torch.int8),
            "itmin": (itmin, (B,), torch.int32),
            "cdf": (cdf, (N,), torch.float32), **tables}
    check_args(want, sigma.device)


def launch_args(sigma, lf, E, emin, smin, itmin):
    """The state's pointers, as both EO kernels take them."""
    return (sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), emin.data_ptr(),
            smin.data_ptr(), itmin.data_ptr())


@spanned("rrrmc.op.eo_sparse")
def eo_sparse_chunk(sigma, lf, E, emin, smin, itmin, neigh, J, cdf, *,
                    n_moves: int, seed: int, half_max: Optional[int] = None,
                    move0: int = 0, chain0: int = 0,
                    bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` EO moves, in place.

    sigma and smin [B, N] int8 and lf [B, N] (int32 for integer J, else
    float32) are chain-major; E and emin [B] (lf's dtype) and itmin [B]
    int32 are updated; neigh/J are the model's [N, K] tables (padding == N,
    J's dtype that of lf), cdf [N] float32 the rank table. For integer J,
    half_max bounds |sigma_i lf_i| over every configuration (the largest row
    sum of |J| plus |h|): the kernel keeps its keys in the type `key_type`
    gives and selects by 2*half_max + 1 exact bins when that is at most
    HIST_MAX, else (and for float J) by COARSE_BINS coarse bins.

    Random words are Philox under key (seed, chain0 + b), counter
    (word, move0 + m, draw, 0) (ops/prng.py: DRAW_EO_RANK, DRAW_EO_TIE). On
    a CUDA tensor this launches the kernel with the plan of `eo_plan`
    (launch.PLANS["eo_sparse"]); on a CPU tensor it runs the plain version.
    `bits` (move, draw) -> int32 ([B] for the rank, [B, N]
    for the tie race) replaces the generator and is taken by the plain
    version only."""
    B, N = sigma.shape
    K = neigh.shape[1]
    _check_args(sigma, lf, E, emin, smin, itmin, cdf,
                {"neigh": (neigh, (N, K), torch.int32),
                 "J": (J, (N, K), lf.dtype)})
    if sigma.device.type == "cpu":
        return eo_sparse_chunk_reference(
            sigma, lf, E, emin, smin, itmin, neigh, J, cdf, n_moves=n_moves,
            seed=seed, half_max=half_max, move0=move0, chain0=chain0,
            bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no EO kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    key = key_type(is_integer(J), half_max)
    nb = hist_bins(True, half_max) if KEY_CODES[key] < 2 else COARSE_BINS
    sparse_launch("eo_sparse", sigma, lf, E, emin, smin, itmin, neigh, J,
                  cdf, n_moves=n_moves, seed=seed, move0=move0,
                  chain0=chain0, key=key, nb=nb, pspin=False,
                  half_max=half_max)


def eo_sparse_chunk_reference(sigma, lf, E, emin, smin, itmin, neigh, J, cdf,
                              *, n_moves: int, seed: int,
                              half_max: Optional[int] = None, move0: int = 0,
                              chain0: int = 0,
                              bits: Optional[BitsFn] = None):
    """Plain torch version of the sparse EO kernel (same arguments and
    in-place contract as `eo_sparse_chunk`; half_max, a choice of the
    kernel's select, changes nothing here)."""
    N, K = neigh.shape
    rows = torch.arange(sigma.shape[0], device=sigma.device)

    def flip_fields(sig, lf, win, d):
        """The winner's K neighbours' fields += J[win, k] * d, in place."""
        nb = neigh[win].long()
        jr = J[win]
        for k in range(K):
            sel = nb[:, k] < N
            lf[rows[sel], nb[sel, k]] += jr[sel, k] * d[sel]

    eo_chunk_reference(sigma, lf, E, emin, smin, itmin, cdf, flip_fields,
                       n_moves=n_moves, seed=seed, move0=move0,
                       chain0=chain0, bits=bits)


def eo_chunk_reference(sigma, lf, E, emin, smin, itmin, cdf, flip_fields, *,
                       n_moves: int, seed: int, move0: int = 0,
                       chain0: int = 0, bits: Optional[BitsFn] = None,
                       de_of: Callable = pair_de):
    """The EO moves of the EO kernels' plain versions, over [B, N] spins. lf
    is the chain's resident state (local fields, cavity sums, or SAT's
    clause counts); `flip_fields(sig, lf, win, d)` adds the flip of the
    winner win [B] (d = -2 sigma_win, sig the spins before the flip, in lf's
    dtype) to lf in place. Sites are ranked by the energy change of their
    flip, dE = de_of(sig, lf) (2 sigma_i lf_i by default: the same order and
    ties as the kernels' key sigma_i lf_i, float keys included), and a flip
    changes E by its dE."""
    B, N = sigma.shape
    dev = sigma.device
    rows = torch.arange(B, device=dev)
    sig = sigma.to(lf.dtype)
    rank_draws, tie_draws = eo_draws(seed, chain0, B, N, move0, n_moves, dev,
                                     bits)
    groups = torch.zeros((), dtype=torch.int64, device=dev)
    for m in range(n_moves):
        de = de_of(sig, lf)
        rank = torch.searchsorted(cdf, prng.to_uniform(next(rank_draws)))
        key = sort_key(de)
        win = select_rank_with_ties(key, rank, next(tie_draws))
        groups += member_groups(key, key[rows, win])
        s_w = sig[rows, win]
        dE = de[rows, win]
        flip_fields(sig, lf, win, -2 * s_w)
        sig[rows, win] = -s_w
        E += dE
        better = E < emin
        emin.copy_(torch.where(better, E, emin))
        smin.copy_(torch.where(better[:, None], sig.to(torch.int8), smin))
        itmin.copy_(torch.where(better, move0 + m + 1, itmin))
    sigma.copy_(sig.to(torch.int8))
    TIE_GROUPS.update(chain_moves=B * n_moves, groups=int(groups))


def member_groups(key: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The groups of four sites (i // 4) of each row of key [B, N] that
    hold a site whose key equals v [B], summed over the rows whose class
    has more than one site (one site wins without a draw): the tie race's
    Philox calls at one move."""
    B, N = key.shape
    member = torch.zeros((B, -(-N // 4) * 4), dtype=torch.bool,
                         device=key.device)
    member[:, :N] = key == v[:, None]
    tied = member.sum(1, keepdim=True) > 1
    return (member.view(B, -1, 4).any(-1) & tied).sum()
