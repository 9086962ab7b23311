"""The control of the pairwise configurations: the reference's own plain
samplers (Metropolis, BKL, the colour-class sweep, tau-EO), put in the
program's place in the window, with the running energy kept in bfloat16.

The configurations state exact integer energies (int32). float32 would
hold them as exactly (|E| is at most the number of edges, far under 2^24),
and so would int16 (under 32 768); the step below float32 is bfloat16,
which spaces whole numbers 32 apart from 4 096 up and breaks the
guarantee that the comparison holds the program to. (float16 would not
always: on an EA lattice every flip moves E by a multiple of 4, so E keeps
one residue mod 4, and float16's spacing there is 4.)
`from_view(..., dtype=torch.int64)` gives the same samplers exact energies:
the tests' sound stand-in for the program.

Plain PyTorch on the benchmark's own tables (references/pairwise.py),
drawing from a torch.Generator seeded with the run's program seed; it
imports nothing of the program. A traffic mix's "control" object may cut
the block and its step (moves or sweeps) where the plain sampler is too
slow for the cell's own; the harness then runs the window's blocks at
that length.
"""

from __future__ import annotations

import numpy as np
import torch

#: the control's running-energy type
PRECISION = torch.bfloat16


def from_view(run, ref, tab, view, dtype=PRECISION) -> dict:
    """The control's state from a view of the program's set-up: the spins,
    their fields and energies worked out again by the reference module
    `ref` on its tables `tab`, the energies in `dtype`."""
    sigma = view["sigma"].clone()
    acc = view.get("accepted")
    return {"sigma": sigma, "lf": ref.fields(tab, sigma),
            "E": ref.energy(tab, sigma).to(dtype),
            "acc": (acc.long().clone() if acc is not None else
                    torch.zeros(sigma.shape[0], dtype=torch.long,
                                device=sigma.device)),
            "gen": torch.Generator(device=sigma.device).manual_seed(run.seed)}


def _flip(tab, st, rows, i, do):
    s = st["sigma"][rows, i]
    upd = (-2 * s.long())[:, None] * tab.J[i] * do[:, None].long()
    st["lf"].scatter_add_(1, tab.neigh[i], upd)
    st["sigma"][rows, i] = torch.where(do, -s, s)


def _rand(st, shape, dtype=torch.float64):
    return torch.rand(shape, generator=st["gen"], device=st["sigma"].device,
                      dtype=dtype)


def metropolis(tab, st, beta, moves, step):
    B, N = st["sigma"].shape
    dev = st["sigma"].device
    rows = torch.arange(B, device=dev)
    series = []
    for m in range(moves):
        i = torch.randint(0, N, (B,), generator=st["gen"], device=dev)
        dE = 2 * st["sigma"][rows, i].long() * st["lf"][rows, i]
        do = (dE <= 0) | (_rand(st, (B,)) < torch.exp(-beta * dE.double()))
        st["E"] = st["E"] + torch.where(do, dE, 0).to(st["E"].dtype)
        st["acc"] += do.long()
        _flip(tab, st, rows, i, do)
        if (m + 1) % step == 0:
            series.append(st["E"].clone())
    return torch.stack(series, 1)


def bkl(tab, st, beta, iters, step):
    B, N = st["sigma"].shape
    dev = st["sigma"].device
    rows = torch.arange(B, device=dev)
    coord = torch.zeros(B, dtype=torch.long, device=dev)
    ns = torch.arange(1, iters // step + 1, device=dev) * step
    series = torch.zeros((B, ns.numel()), dtype=st["E"].dtype, device=dev)
    while bool((coord < iters).any()):
        active = coord < iters
        dE = 2 * st["sigma"].long() * st["lf"]
        w = torch.exp(-beta * dE.clamp(min=0).double())
        c = w.cumsum(1)
        z = c[:, -1]
        u = _rand(st, (B,)) * z
        i = torch.searchsorted(c, u[:, None]).squeeze(1).clamp(max=N - 1)
        p = (z / N).clamp(max=1.0)
        u2 = 1.0 - _rand(st, (B,))
        skip = torch.where(p >= 1.0, torch.zeros_like(p),
                           torch.floor(torch.log(u2) / torch.log1p(-p)))
        new = coord + skip.long() + 1
        hit = ((ns[None] > coord[:, None]) & (ns[None] <= new[:, None])
               & active[:, None])
        series = torch.where(hit, st["E"][:, None], series)
        st["E"] = st["E"] + torch.where(active, dE[rows, i], 0).to(
            st["E"].dtype)
        st["acc"] += active.long()
        _flip(tab, st, rows, i, active)
        coord = torch.where(active, new, coord)
    return series


def colour_masks(tab) -> torch.Tensor:
    """[C, N] masks of a first-fit greedy colouring of the graph."""
    neigh = tab.neigh.cpu().numpy()
    col = np.full(tab.N, -1)
    for i in range(tab.N):
        used = set(col[neigh[i]].tolist())
        c = 0
        while c in used:
            c += 1
        col[i] = c
    return torch.as_tensor(np.stack([col == c for c in range(col.max() + 1)]),
                           device=tab.neigh.device)


def sweep(ref, tab, st, beta, sweeps, step):
    masks = colour_masks(tab)
    series = []
    for k in range(sweeps):
        for mask in masks:
            dE = 2 * st["sigma"].long() * st["lf"]
            do = mask & ((dE <= 0) | (_rand(st, dE.shape, torch.float32)
                                      < torch.exp(-beta * dE.float())))
            st["E"] = st["E"] + (dE * do).sum(1).to(st["E"].dtype)
            st["sigma"] = torch.where(do, -st["sigma"], st["sigma"])
            st["lf"] = ref.fields(tab, st["sigma"])
        if (k + 1) % step == 0:
            series.append(st["E"].clone())
    return torch.stack(series, 1)


def eo(tab, st, tau, moves):
    B, N = st["sigma"].shape
    dev = st["sigma"].device
    rows = torch.arange(B, device=dev)
    w = np.arange(1, N + 1, dtype=np.float64) ** (-tau)
    cdf = torch.as_tensor(np.cumsum(w) / w.sum(), device=dev)
    emin, smin = st["E"].clone(), st["sigma"].clone()
    for _ in range(moves):
        dE = 2 * st["sigma"].long() * st["lf"]
        key = dE.double() + 0.5 * _rand(st, dE.shape)   # ties at random
        k = torch.searchsorted(cdf, _rand(st, (B, 1))).squeeze(1)
        i = key.argsort(1)[rows, k.clamp(max=N - 1)]
        st["E"] = st["E"] + dE[rows, i].to(st["E"].dtype)
        _flip(tab, st, rows, i, torch.ones(B, dtype=torch.bool, device=dev))
        better = st["E"] < emin
        emin = torch.where(better, st["E"], emin)
        smin = torch.where(better[:, None], st["sigma"], smin)
    return emin, smin


def block(run, ref, tab, st):
    """One block of the traffic's entry on the plain sampler."""
    t = run.traffic
    n = int(t["block"])
    entry = t["entry"]
    view = {}
    if entry == "standardMC":
        view["series"] = metropolis(tab, st, float(t["beta"]), n,
                                    int(t["step"]))
    elif entry == "bklMC":
        view["series"] = bkl(tab, st, float(t["beta"]), n, int(t["step"]))
    elif entry == "sweepMC":
        view["series"] = sweep(ref, tab, st, float(t["beta"]), n,
                               int(t["step"]))
    elif entry == "extremal_opt":
        view["emin"], view["sigma_min"] = eo(tab, st, float(t["tau"]), n)
    else:
        raise ValueError(f"no plain sampler for entry {entry!r}")
    view.update(sigma=st["sigma"].clone(), E=st["E"].clone(),
                aux=st["lf"].clone())
    if entry in ("standardMC", "bklMC"):
        view["accepted"] = st["acc"].clone()
    if entry == "extremal_opt":
        del view["aux"]
    return st, view
