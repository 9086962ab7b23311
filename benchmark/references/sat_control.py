"""The control of the K-SAT configuration: the reference's plain BKL on
clauses, put in the program's place in the window, with each chain's
virtual-iteration coordinate kept in bfloat16.

The configuration states exact integer energies and counts (int32), and
the program's race keeps its coordinate in int32. bfloat16 energies would
not break the guarantee here: a chain of this cell holds fewer than 256
violated clauses (163-241 on an H100 after the set-up's anneal), and
bfloat16 holds every whole number up to 256 exactly. Its coordinate, a few
10^4 iterations into a block, is spaced 64-256 apart, where a BKL move
advances it by N / z, about 7 iterations: a coordinate rounded to the
nearest bfloat16 value would stall, and one rounded up to the next, as
here, ends the block after far fewer moves than a sound chain makes,
which `work_ratio_gap` reads.
`from_view(..., dtype=torch.int64)` gives the same sampler an exact
coordinate: the tests' sound stand-in for the program.

Plain PyTorch on the benchmark's own tables (references/sat.py), drawing
from a torch.Generator seeded with the run's program seed; it imports
nothing of the program. A traffic mix's "control" object may cut the block
and its step where the plain sampler is too slow for the cell's own.
"""

from __future__ import annotations

import math

import torch

#: the control's coordinate type
PRECISION = torch.bfloat16


def from_view(run, ref, tab, view, dtype=PRECISION) -> dict:
    """The control's state from a view of the program's set-up: the spins,
    their clause counts and energies worked out again by the reference
    module `ref` on its tables `tab`, the coordinate to be kept in
    `dtype`."""
    sigma = view["sigma"].clone()
    acc = view.get("accepted")
    return {"sigma": sigma, "cnt": ref.fields(tab, sigma),
            "E": ref.energy(tab, sigma), "coord_dtype": dtype,
            "acc": (acc.long().clone() if acc is not None else
                    torch.zeros(sigma.shape[0], dtype=torch.long,
                                device=sigma.device)),
            "gen": torch.Generator(device=sigma.device).manual_seed(run.seed)}


def held(x: torch.Tensor, dtype) -> torch.Tensor:
    """Whole numbers x >= 0 (int64) rounded up to the next value that the
    type `dtype` holds: x itself for an integer type, the next multiple of
    the floating type's spacing at x (2^floor(log2 x) eps) otherwise."""
    if not dtype.is_floating_point:
        return x
    e = torch.log2(x.clamp(min=1).double()).floor()
    step = torch.exp2(e + math.log2(torch.finfo(dtype).eps)).clamp(min=1)
    step = step.long()
    return (x + step - 1) // step * step


def _flip(tab, st, rows, i, do):
    """Flip variable i[b] in the chains where do, moving the counts of its
    clauses by one each (padded slots hold the sign 0 and move nothing)."""
    s_new = -st["sigma"][rows, i].long()
    lit = tab.slot_l[i]                                  # [B, slots]
    upd = torch.where(s_new[:, None] == lit, 1, -1) * (lit != 0)
    upd = upd * do[:, None]
    st["cnt"].scatter_add_(1, tab.slot_c[i].clamp(max=tab.Mc - 1), upd)
    st["sigma"][rows, i] = torch.where(do, s_new,
                                       -s_new).to(st["sigma"].dtype)


def _rand(st, shape):
    return torch.rand(shape, generator=st["gen"], device=st["sigma"].device,
                      dtype=torch.float64)


def bkl(ref, tab, st, beta, iters, step):
    """BKL moves until every chain's coordinate reaches `iters`; returns the
    [B, iters // step] checkpoint series (each the energy before the move
    whose coordinate reaches the checkpoint, as the program's)."""
    B, N = st["sigma"].shape
    dev = st["sigma"].device
    rows = torch.arange(B, device=dev)
    coord = torch.zeros(B, dtype=torch.long, device=dev)
    ns = torch.arange(1, iters // step + 1, device=dev) * step
    series = torch.zeros((B, ns.numel()), dtype=st["E"].dtype, device=dev)
    while bool((coord < iters).any()):
        active = coord < iters
        dE = ref.delta_counts(tab, st["sigma"].long(), st["cnt"])
        w = torch.exp(-beta * dE.clamp(min=0).double())
        c = w.cumsum(1)
        z = c[:, -1]
        u = _rand(st, (B,)) * z
        i = torch.searchsorted(c, u[:, None]).squeeze(1).clamp(max=N - 1)
        p = (z / N).clamp(max=1.0)
        u2 = 1.0 - _rand(st, (B,))
        skip = torch.where(p >= 1.0, torch.zeros_like(p),
                           torch.floor(torch.log(u2) / torch.log1p(-p)))
        new = held(coord + skip.long() + 1, st["coord_dtype"])
        hit = ((ns[None] > coord[:, None]) & (ns[None] <= new[:, None])
               & active[:, None])
        series = torch.where(hit, st["E"][:, None], series)
        st["E"] = st["E"] + torch.where(active, dE[rows, i], 0)
        st["acc"] += active.long()
        _flip(tab, st, rows, i, active)
        coord = torch.where(active, new, coord)
    return series


def block(run, ref, tab, st):
    """One block of the traffic's entry on the plain sampler (bklMC
    only)."""
    t = run.traffic
    if t["entry"] != "bklMC":
        raise ValueError(f"no plain sampler for entry {t['entry']!r}")
    series = bkl(ref, tab, st, float(t["beta"]), int(t["block"]),
                 int(t["step"]))
    return st, {"series": series, "sigma": st["sigma"].clone(),
                "E": st["E"].clone(), "aux": st["cnt"].clone(),
                "accepted": st["acc"].clone()}
