"""BKL moves on integer sparse Pairwise models by energy classes: the CUDA
kernel (csrc/rejfree_classes.cu), its plain torch version and its route
rule.

Source note. The kernel replaces no TPU kernel. The TPU package runs BKL
as the race of rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_sparse_kernel,
ported as csrc/rejfree_sparse.cu: a move there is a pass over all N sites
of the chain (a Philox word, a Boltzmann term and a race score each) to
flip one site and change K + 1 fields. With integer couplings and int8
resident fields a site's Boltzmann exponent is beta_s * 2h for an integer
class h = max(sigma lf, 0) in [0, C), C = the field bound + 1 <= 128, so a
move can be drawn as RRRMC.jl's discrete BKL draws it: a class with
probability n_h exp(-2 beta_s h) / z, then a site uniformly within it.
This kernel was added for that: O(C + K) work a move, with the chain's
spins, sigma lf and the class counts resident in shared memory.

The classes: n_h, the sites of class h (the kernel also counts each class
in each group of GROUP consecutive sites). z = sum_h n_h ez[h - hmin] over the
classes from the least occupied one, hmin, up, in ascending h, with ez[k] =
exp(0 - 2 beta_s k) (hmin > 0 only when every flip raises E; z / N is then
(z / N) ez[hmin]); the class is the largest occupied h whose preceding sum
is at most u z, so no empty class is drawn; the site is the k-th of its
class in ascending index, k = floor(u' n_c) from a 32-bit word (its product
with n_c, high half): the group whose running count passes k, then the
site within it. The flip changes the site's and its K neighbours' sigma lf
in slot order and moves each changed site between the counts. bkl then
adds the geometric skip at p = z / N + 1 to the coordinate, z / N to zacc,
the flip's 2 sigma lf to E and 1 to acc, and writes the (coordinate, E)
stream rows as the race does; a chain whose coordinate reached `target`
makes no move. The law is the race's: a site with probability proportional
to exp(-2 beta_s max(sigma lf, 0)), the same skip. Energies stay exact
integers.

What bounds it on the H100: a move is a short dependent chain (the class
sums, two warp scans, the table row from L2, K + 1 count moves), one warp a
chain; the card is filled by chains, and the narrow state (2 bytes a site,
21 KB a chain at N = 10^4) keeps every chain of a 1024-chain launch
resident at once (its plan: registers, spills, blocks an SM).

Random words: Philox under key (seed, chain0 + b), counter (0, move,
DRAW_CLASS, 0) (word 0 the class, word 1 the site) and (0, move, DRAW_SKIP,
0) (ops/prng.py). The plain version makes the same draws and sums in the
same order, so the kernel, built with -fmad=false, equals it bit for bit on
the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import check_args, launch, prng
from .rejfree import BitsFn, _geom_skip, coord_dtype
from ..core.dtypes import is_integer
from ..utils.profiling import spanned

#: sites of a group, the unit of the class counts the site pick scans
GROUP = 512
#: the most sites a chain: 64 groups, two a lane of the chain's warp
MAX_SITES = 32767
#: the most classes: h = max(sigma lf, 0) of int8 resident fields
MAX_CLASSES = 128


def classes_ok(model, mode: str, field_bound: Optional[int], device) -> bool:
    """The route rule of bklMC's race loop on a sparse Pairwise model:
    bkl, integer couplings whose fields fit int8 (`field_bound`, the
    family's bound on |lf|, None for float couplings, at most 127),
    N <= MAX_SITES, and on a CUDA device a plan that finds shared memory
    for one chain."""
    if (mode != "bkl" or field_bound is None or field_bound >= MAX_CLASSES
            or model.N > MAX_SITES):
        return False
    return (torch.device(device).type != "cuda"
            or plan(model.N, field_bound + 1, torch.device(device))[
                "blocks_per_sm"] > 0)


def plan(N: int, C: int, dev) -> dict:
    """The launch plan of the kernel for chains of N sites in C classes on
    CUDA device dev: dynamic shared bytes, blocks per SM (0 where a chain
    does not fit), registers and local bytes a thread."""
    from .cuda_build import library

    smem = int(library().rrrmc_rejfree_classes_smem(N, C))
    f = _facts(smem, dev)
    return {"kernel": "rejfree_classes", "smem": smem, "classes": C,
            "groups": -(-N // GROUP),
            "blocks_per_sm": f[0] if smem <= f[4] else 0, "registers": f[1],
            "spill_bytes": f[2]}


def _facts(smem: int, dev) -> tuple:
    """The kernel's launch facts at `smem` dynamic bytes on CUDA device
    dev (one warp a chain, a chain a block)."""
    return launch.facts("rrrmc_rejfree_classes_info", (), None, smem,
                        dev.index or 0)


def _check_args(sigma, lf, E, coord, acc, zacc, neigh, J, mode,
                field_bound):
    if mode != "bkl":
        raise ValueError(f"the class kernel runs bkl only, got {mode!r}")
    B, N = sigma.shape
    if not is_integer(J) or field_bound is None or not (
            0 <= field_bound < MAX_CLASSES) or N > MAX_SITES:
        raise ValueError(f"the class kernel takes integer couplings with "
                         f"|lf| <= {MAX_CLASSES - 1} and N <= {MAX_SITES}; "
                         f"got {J.dtype}, bound {field_bound}, N={N}")
    K = neigh.shape[1]
    i32 = torch.int32
    want = {"sigma": (sigma, (B, N), torch.int8), "lf": (lf, (B, N), i32),
            "E": (E, (B,), i32), "coord": (coord, (B,), coord_dtype(mode)),
            "acc": (acc, (B,), i32), "zacc": (zacc, (B,), torch.float32),
            "neigh": (neigh, (N, K), i32), "J": (J, (N, K), i32)}
    check_args(want, sigma.device)


@spanned("rrrmc.op.rejfree_classes")
def rejfree_classes_chunk(sigma, lf, E, coord, acc, zacc, neigh, J, *,
                          mode: str, n_moves: int, beta_s: float, target,
                          seed: int, move0: int = 0, chain0: int = 0,
                          bits: Optional[BitsFn] = None,
                          field_bound: Optional[int] = None):
    """Advance every chain by `n_moves` BKL moves, in place: the arguments,
    in-place outputs and returned (cs, es) streams of
    ops/rejfree.py::rejfree_sparse_chunk, for mode "bkl" on integer
    couplings with `field_bound` <= 127 (C = field_bound + 1 classes).

    On a CUDA tensor this launches the kernel (one warp a chain); on a CPU
    tensor it runs the plain version. `bits` (move, draw) -> int32 ([B, 2]
    for DRAW_CLASS, [B] for DRAW_SKIP) replaces the generator and is taken
    by the plain version only."""
    _check_args(sigma, lf, E, coord, acc, zacc, neigh, J, mode, field_bound)
    if sigma.device.type == "cpu":
        return rejfree_classes_chunk_reference(
            sigma, lf, E, coord, acc, zacc, neigh, J, mode=mode,
            n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
            move0=move0, chain0=chain0, bits=bits, field_bound=field_bound)
    if sigma.device.type != "cuda":
        raise ValueError(f"no class kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import library

    lib = library()
    B, N = sigma.shape
    dev = sigma.device
    C = field_bound + 1
    p = plan(N, C, dev)
    launch.require_smem(p["smem"], _facts(p["smem"], dev)[4], N, "class")
    launch.record("rejfree_classes", p)
    cs = torch.empty((n_moves, B), dtype=torch.int32, device=dev)
    es = torch.empty((n_moves, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_classes(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            neigh.data_ptr(), J.data_ptr(), N, neigh.shape[1], B, n_moves, C,
            seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            2.0 * beta_s, int(target),
            torch.cuda.current_stream().cuda_stream)
    launch.launched("rejfree_classes", err)
    return cs, es


class ClassCounts:
    """The plain version's class tables of B chains: the class h = max(sigma
    lf, 0) of every site [B, N] and the sites of each class [B, C]."""

    def __init__(self, half: torch.Tensor, C: int):
        self.rows = torch.arange(half.shape[0], device=half.device)
        self.h = half.clamp(min=0).long()
        self.cnt = torch.zeros((half.shape[0], C), dtype=torch.long,
                               device=half.device).scatter_add_(
            1, self.h, torch.ones_like(self.h))

    def move(self, site, half_new, do):
        """Site site [B] takes class max(half_new, 0) where `do`."""
        r, i = self.rows[do], site[do]
        b = half_new[do].clamp(min=0).long()
        self.cnt[r, self.h[r, i]] -= 1
        self.cnt[r, b] += 1
        self.h[r, i] = b

    def kth(self, c, k):
        """[B] the k-th site (from 0) of class c [B] in ascending index (the
        kernel finds it through its counts of each class in each group of
        GROUP sites)."""
        return ((self.h == c[:, None]).cumsum(1) <= k[:, None]).sum(1)


def rejfree_classes_chunk_reference(sigma, lf, E, coord, acc, zacc, neigh,
                                    J, *, mode: str, n_moves: int,
                                    beta_s: float, target, seed: int,
                                    move0: int = 0, chain0: int = 0,
                                    bits: Optional[BitsFn] = None,
                                    field_bound: Optional[int] = None):
    """Plain torch version of the class kernel, move by move over the B
    chains (same arguments, in-place contract and streams as
    `rejfree_classes_chunk`)."""
    cs, es, _ = class_moves(sigma, lf, E, coord, acc, zacc, neigh, J,
                            n_moves=n_moves, beta_s=beta_s, target=target,
                            seed=seed, move0=move0, chain0=chain0, bits=bits,
                            field_bound=field_bound)
    return cs, es


def class_moves(sigma, lf, E, coord, acc, zacc, neigh, J, *, n_moves: int,
                beta_s: float, target, seed: int, move0: int = 0,
                chain0: int = 0, bits: Optional[BitsFn] = None,
                field_bound: int):
    """The plain version's moves; returns (cs, es, the final ClassCounts)."""
    B, N = sigma.shape
    K = neigh.shape[1]
    C = field_bound + 1
    dev = sigma.device
    rows = torch.arange(B, device=dev)
    sig = sigma.to(torch.int32)
    half = sig * lf
    t = ClassCounts(half, C)
    classes = torch.arange(C, device=dev)
    beta2s = torch.tensor(2.0 * beta_s, dtype=torch.float32, device=dev)
    ez = torch.exp(0.0 - beta2s * classes.to(torch.float32))
    zero = torch.zeros((), dtype=E.dtype, device=dev)
    # a tensor divisor: torch divides by a host scalar as a product with its
    # reciprocal on the card, where the kernel divides
    n_f = torch.tensor(float(N), dtype=torch.float32, device=dev)
    cs = torch.empty((n_moves, B), dtype=coord.dtype, device=dev)
    es = torch.empty((n_moves, B), dtype=E.dtype, device=dev)

    def draws(d):
        if bits is not None:
            return map(lambda m: bits(m, d), range(n_moves))
        if d == prng.DRAW_CLASS:
            return prng.per_move(lambda lo, n: prng.class_bits(
                seed, chain0, B, move0 + lo, n, dev), n_moves, 256)
        return prng.per_move(lambda lo, n: prng.draw_bits(
            seed, chain0, B, move0 + lo, n, d, dev), n_moves, 256)

    pick, skips = draws(prng.DRAW_CLASS), draws(prng.DRAW_SKIP)
    for m in range(n_moves):
        do = coord < target
        if not bool(do.any()):
            cs[m:] = coord
            es[m:] = E
            break
        w2, wk = next(pick), next(skips)
        occupied = t.cnt > 0
        hmin = occupied.to(torch.int8).argmax(1)
        w = t.cnt.to(torch.float32) * ez[(classes - hmin[:, None]).clamp(
            min=0)]
        zs = torch.zeros(B, dtype=torch.float32, device=dev)
        before = []
        for h in range(C):
            before.append(zs)
            zs = zs + w[:, h]
        zn = zs / n_f * ez[hmin]
        skip = _geom_skip(prng.to_uniform(wk), zn)
        u = prng.to_uniform(w2[:, 0]) * zs
        ok = occupied & (u[:, None] >= torch.stack(before, 1))
        c = torch.where(ok, classes, -1).max(1).values
        k = ((w2[:, 1].long() & 0xFFFFFFFF) * t.cnt[rows, c]) >> 32
        i = t.kth(c, k)
        s, hf = sig[rows, i], half[rows, i]
        sig[rows[do], i[do]] = -s[do]
        half[rows[do], i[do]] = -hf[do]
        t.move(i, -hf, do)
        d = -2 * s
        for q in range(K):
            nb = neigh[i, q].long()
            on = do & (nb < N)
            nbc = nb.clamp(max=N - 1)
            hn = half[rows, nbc] + sig[rows, nbc] * J[i, q] * d
            half[rows[on], nbc[on]] = hn[on]
            t.move(nbc, hn, on)
        E += torch.where(do, 2 * hf, zero)
        acc += do.to(torch.int32)
        zacc += torch.where(do, zn, 0.0)
        coord += torch.where(do, skip + 1, 0)
        cs[m] = coord
        es[m] = E
    sigma.copy_(sig.to(torch.int8))
    lf.copy_(sig * half)
    return cs, es, t
