"""BKL by energy classes on integer sparse models
(rrrmc_tpu_torch/ops/rejfree_classes.py, its plain version on the CPU):
the law against exact enumeration, the class tables' invariants under
injected bits, the route rule of bklMC's race loop, and the class route
against the race route on the same chains."""

import itertools

import numpy as np
import pytest
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import prng
from rrrmc_tpu_torch.ops.rejfree_classes import (GROUP, ClassCounts,
                                                 class_moves,
                                                 rejfree_classes_chunk)
from rrrmc_tpu_torch.samplers import bkl, families
from rrrmc_tpu_torch.samplers.common import LAST_ROUTE

from torch_port_helpers import CPU

torch.set_num_threads(1)

#: the law test: N = 12 spins of the graphs, beta = 1, chains, iterations
#: a chain, the checkpoint spacing and the checkpoints dropped as burn-in
LAW_N, LAW_BETA, LAW_CHAINS, LAW_ITERS, LAW_STEP, LAW_BURN = (
    12, 1.0, 512, 2400, 24, 20)


def _exact_levels(m, beta):
    """{E: Boltzmann probability} of the 2^N states of m, internal units."""
    states = torch.tensor(list(itertools.product((-1, 1), repeat=m.N)),
                          dtype=torch.int8)
    E = m.energy(states).double()
    w = torch.exp(-beta * m.scale * (E - E.min()))
    levels = {}
    for e, p in zip(E.tolist(), (w / w.sum()).tolist()):
        levels[e] = levels.get(e, 0.0) + p
    return levels


LAW_MODELS = {
    "RRG K=3": lambda: pt.GraphRRG(LAW_N, 3, (-1, 1), seed=5, **CPU),
    "RRG K=6": lambda: pt.GraphRRG(LAW_N, 6, (-1, 1), seed=5, **CPU),
    "EA-3D L=2 (each neighbour twice)": lambda: pt.GraphEA(2, 3, (-1, 1),
                                                          seed=5, **CPU),
}


@pytest.mark.parametrize("name", list(LAW_MODELS))
def test_class_law_matches_exact_enumeration(name):
    """bklMC on the class route (its plain version) samples the Boltzmann
    law: the time-weighted occupation of each energy level (checkpoints at
    fixed virtual times after a burn-in) lies within 5 standard errors of
    the exact one, beta = 1, on +-J random K-regular graphs of 12 spins
    (K = 3, and the seven classes of K = 6) and the 8-spin EA lattice of
    L = 2, whose rows hold each neighbour twice. The standard error is the
    spread of the chains' own occupations over sqrt(chains)."""
    m = LAW_MODELS[name]()
    Es, st = pt.bklMC(m, LAW_BETA, LAW_ITERS, step=LAW_STEP,
                      chains=LAW_CHAINS, seed=11, **CPU)
    assert LAST_ROUTE["pick"] == "classes"
    assert torch.equal(m.energy(st.sigma), st.E)
    E = Es[:, LAW_BURN:].double()
    exact = _exact_levels(m, LAW_BETA)
    assert set(torch.unique(E).tolist()) <= set(exact)
    for e, p in exact.items():
        per_chain = (E == e).double().mean(1)
        se = float(per_chain.std()) / LAW_CHAINS ** 0.5
        got = float(per_chain.mean())
        assert abs(got - p) <= 5 * se + 1e-4, (name, e, got, p, se)


def _injected(seed, B):
    """bits(move, draw) of numpy words: [B, 2] for DRAW_CLASS, [B] for
    DRAW_SKIP."""
    rng = np.random.default_rng(seed)

    def bits(m, d):
        shape = (B, 2) if d == prng.DRAW_CLASS else (B,)
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape,
                                             dtype=np.int64).astype(np.int32))

    return bits


def _fielded_rrg(N, K, seed):
    """A +-J random K-regular graph with integer fields in -2..2: classes
    0 .. K + 2, every one of them occupied at some time."""
    import dataclasses

    m = pt.GraphRRG(N, K, (-1, 1), seed=seed, **CPU)
    h = np.random.default_rng(seed).integers(-2, 3, N)
    return dataclasses.replace(m, h=torch.as_tensor(h, dtype=m.h.dtype))


MODELS = {
    "RRG K=3 with fields, 1500 sites": lambda: _fielded_rrg(1500, 3, 2),
    "EA-3D L=8": lambda: pt.GraphEA(8, 3, (-1, 1), seed=3, **CPU),
    "EA-3D L=2 (each neighbour twice)": lambda: pt.GraphEA(2, 3, (-1, 1),
                                                          seed=3, **CPU),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_class_tables_stay_consistent(name):
    """After each of three chunks with injected bits the plain version's
    class tables match a recount from the chains' spins and fields: every
    site's class is max(sigma lf, 0), the class counts are its members',
    and z from the counts equals the race's sum of exp(-beta_s max(dE, 0))
    over the sites within 1e-5 relative (float64 sums of float32 terms in
    another order); the running E stays exact."""
    m = MODELS[name]()
    bound = families.half_bound(m)
    B, beta_s = 16, 0.7 * m.scale
    st = pt.init_state(m, B, seed=4, **CPU)
    sigma, lf, E = st.sigma.clone(), m.init_aux(st.sigma), st.E.clone()
    coord = torch.zeros(B, dtype=torch.int32)
    acc = torch.zeros(B, dtype=torch.int32)
    zacc = torch.zeros(B, dtype=torch.float32)
    C = bound + 1
    for chunk in range(3):
        cs, es, t = class_moves(
            sigma, lf, E, coord, acc, zacc, m.neigh, m.J, n_moves=40,
            beta_s=beta_s, target=2 ** 30, seed=0, move0=40 * chunk,
            bits=_injected(chunk, B), field_bound=bound)
        half = sigma.int() * lf
        assert torch.equal(lf, m.local_fields(sigma))
        assert torch.equal(E, m.energy(sigma)) and torch.equal(es[-1], E)
        assert torch.equal(t.h, half.clamp(min=0).long())
        assert torch.equal(t.cnt, ClassCounts(half, C).cnt)
        assert torch.equal(t.cnt.sum(1), torch.full((B,), m.N))
        ez = torch.exp(0.0 - torch.tensor(2 * beta_s, dtype=torch.float32)
                       * torch.arange(C, dtype=torch.float32))
        z_classes = (t.cnt.double() * ez.double()).sum(1)
        z_sites = torch.exp(-beta_s * (2 * half).clamp(min=0).double()).sum(1)
        assert torch.allclose(z_classes, z_sites, rtol=1e-5, atol=0)
    assert int(acc.min()) == 120


def test_kth_member_in_ascending_order():
    """ClassCounts.kth, the pick within a class, gives the k-th member of
    the class in ascending site index, for every k of every occupied class
    (over more than one of the kernel's groups of GROUP sites)."""
    g = torch.Generator().manual_seed(3)
    B, N, C = 4, 2 * GROUP + 77, 5
    half = torch.randint(-3, C, (B, N), generator=g, dtype=torch.int32)
    t = ClassCounts(half, C)
    for b in range(B):
        for c in range(C):
            members = torch.nonzero(t.h[b] == c).flatten()
            rows = torch.full((len(members),), c)
            picked = ClassCounts(half[b:b + 1].expand(len(members), N),
                                 C).kth(rows, torch.arange(len(members)))
            assert torch.equal(picked, members)


def _lattice():
    return pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU)


def _rrg():
    return pt.GraphRRG(40, 3, (-1, 1), seed=5, **CPU)


#: (call, the pick it must take)
ROUTES = {
    "bklMC RRG +-J": (lambda: pt.bklMC(_rrg(), 1.0, 200, chains=4, **CPU),
                      "classes"),
    "bklMC EA +-J": (lambda: pt.bklMC(_lattice(), 1.0, 200, chains=4, **CPU),
                     "classes"),
    "rrrMC RRG +-J": (lambda: pt.rrrMC(_rrg(), 1.0, 50, chains=4, **CPU),
                      "race"),
    "wtmMC RRG +-J": (lambda: pt.wtmMC(_rrg(), 1.0, 2, step=40.0, chains=4,
                                       **CPU), "race"),
    "bklMC GraphRRGNormal": (lambda: pt.bklMC(
        pt.GraphRRGNormal(40, 3, seed=5, **CPU), 1.0, 200, chains=4, **CPU),
        "race"),
    "bklMC RRG J=+-100 (int16 fields)": (lambda: pt.bklMC(
        pt.GraphRRG(40, 3, (-100, 100), seed=5, **CPU), 0.01, 200, chains=4,
        **CPU), "race"),
    "bklMC PSpin3": (lambda: pt.bklMC(pt.GraphPSpin3(30, 3, seed=2, **CPU),
                                      1.0, 200, chains=4, **CPU), "race"),
    "bklMC SAT": (lambda: pt.bklMC(pt.GraphSAT(40, 3, 3.0, seed=2, **CPU),
                                   1.0, 200, chains=4, **CPU), "race"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_pick(name):
    """LAST_ROUTE["pick"] says which kernel bklMC's race loop took: the
    classes for bkl on integer sparse Pairwise models whose fields fit
    int8 (an RRG and an EA lattice, +-J), the race for rrr, wtm, float
    couplings, wider integer fields, PSpin3 and K-SAT."""
    call, want = ROUTES[name]
    call()
    assert LAST_ROUTE["pick"] == want
    assert LAST_ROUTE["backend"].startswith("kernel-rejfree-")


def test_class_kernel_refuses_what_its_rule_excludes():
    """The class op runs bkl on int8-bounded integer fields only."""
    m = _rrg()
    st = pt.init_state(m, 2, seed=1, **CPU)
    args = (st.sigma.clone(), m.init_aux(st.sigma), st.E.clone(),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.float32), m.neigh, m.J)
    kw = dict(n_moves=4, beta_s=1.0, target=100, seed=1)
    with pytest.raises(ValueError, match="bkl only"):
        rejfree_classes_chunk(*args, mode="rrr", field_bound=3, **kw)
    with pytest.raises(ValueError, match="integer couplings"):
        rejfree_classes_chunk(*args, mode="bkl", field_bound=300, **kw)


#: the two routes' comparison: RRG +-J, sites, chains, beta, iterations
CMP_N, CMP_CHAINS, CMP_BETA, CMP_ITERS = 1000, 256, 4.0, 1000


def test_classes_agree_with_the_race():
    """The class route and the race route (the same loop with the family's
    class op taken away) from the same spins of 256 chains on GraphRRG(1000,
    3, +-J) at beta = 4, after 1000 virtual iterations: the mean energy and
    the mean applied flips (iters_per_flip = iterations over flips) agree
    within 5 combined standard errors of the chains' spreads."""
    m = pt.GraphRRG(CMP_N, 3, (-1, 1), seed=8, **CPU)
    fam = families.family_of(m)
    out = {}
    for pick, f in (("classes", fam), ("race", fam._replace(classes=None))):
        st = pt.init_state(m, CMP_CHAINS, seed=3, **CPU)
        _, st = bkl.rejfree_mc(m, f, CMP_BETA, "bkl", CMP_ITERS, CMP_ITERS,
                               st, 1, 1024)
        assert LAST_ROUTE["pick"] == pick
        assert torch.equal(m.energy(st.sigma), st.E)
        out[pick] = (st.E.double(), st.accepted.double())
    for a, b in zip(out["classes"], out["race"]):
        se = float(np.hypot(float(a.std()), float(b.std())))
        se /= CMP_CHAINS ** 0.5
        assert abs(float(a.mean() - b.mean())) <= 5 * se, (
            float(a.mean()), float(b.mean()), se)
