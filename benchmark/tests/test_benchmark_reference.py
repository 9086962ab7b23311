"""The plain reference and the benchmark's generators against the port's
plain CPU path at small sizes, and the reference samplers that serve as
the control."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import checks
from benchmark.manifest import Manifest

MAN = Manifest()
RRG = MAN.generator({"generator": "rrg"})
EA = MAN.generator({"generator": "ea"})
REF = MAN.reference({"reference": "pairwise"})
CTL = MAN.module("references", "pairwise_control")


def rrg(N=200, K=3, seed=1):
    return RRG.make({"N": N, "K": K, "levels": [-1, 1]},
                    np.random.default_rng(seed))


def ea(L=4, D=3, seed=1):
    return EA.make({"L": L, "D": D, "levels": [-1, 1]},
                   np.random.default_rng(seed))


def spins(B, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 2, (B, N), generator=g) * 2 - 1).to(torch.int8)


@pytest.mark.parametrize("N,K", [(64, 3), (200, 3), (100, 4), (1000, 3)])
def test_rrg_is_simple_and_regular(N, K):
    a = rrg(N, K)
    neigh, J = a["neigh"], a["J"]
    assert neigh.shape == (N, K) and set(np.unique(J)) <= {-1, 1}
    for i in range(N):
        assert len(set(neigh[i])) == K and i not in neigh[i]
        for k, j in enumerate(neigh[i]):
            back = np.nonzero(neigh[j] == i)[0]
            assert len(back) == 1 and J[j, back[0]] == J[i, k]


def test_generators_follow_the_seed():
    assert np.array_equal(rrg(seed=3)["neigh"], rrg(seed=3)["neigh"])
    assert not np.array_equal(rrg(seed=3)["neigh"], rrg(seed=4)["neigh"])
    assert np.array_equal(ea(seed=3)["Jd"], ea(seed=3)["Jd"])


@pytest.mark.parametrize("L", [4, 6])
def test_ea_table_is_the_lattice(L):
    a = ea(L)
    N = L ** 3
    idx = np.arange(N).reshape(L, L, L)
    for x in range(0, N, 7):
        c = np.unravel_index(x, (L, L, L))
        for d in range(3):
            up = list(c)
            up[d] = (up[d] + 1) % L
            y = idx[tuple(up)]
            k = list(a["neigh"][x]).index(y)
            assert a["J"][x, k] == a["Jd"][d][c]


@pytest.mark.parametrize("make", [rrg, ea])
def test_reference_equals_the_port(make):
    a = make()
    gen = RRG if make is rrg else EA
    model = gen.to_program(a, "cpu")
    tab = REF.Tables(a, "cpu")
    s = spins(6, a["N"])
    assert torch.equal(REF.energy(tab, s), model.energy(s).long())
    assert torch.equal(REF.fields(tab, s), model.local_fields(s).long())
    assert torch.equal(REF.delta(tab, s),
                       model.delta_all(s, model.init_aux(s)).long())


def test_z_and_z_flipped_by_brute_force():
    a = rrg(40, 3)
    tab = REF.Tables(a, "cpu")
    s = spins(3, 40, seed=5)
    beta = 0.7
    d = REF.delta(tab, s).double()
    assert torch.allclose(REF.z(tab, s, beta),
                          torch.exp(-beta * d.clamp(min=0)).sum(1))
    zf = REF.z_flipped(tab, s, beta)
    for i in range(40):
        t = s.clone()
        t[:, i] = -t[:, i]
        assert torch.allclose(zf[:, i], REF.z(tab, t, beta))


@pytest.mark.parametrize("entry,make,extra", [
    ("standardMC", rrg, {"beta": 1.0, "block": 300, "step": 100}),
    ("bklMC", rrg, {"beta": 1.0, "block": 3000, "step": 1000}),
    ("sweepMC", ea, {"beta": 1.0, "block": 4, "step": 2}),
    ("extremal_opt", ea, {"tau": 1.4, "block": 50}),
])
def test_plain_samplers_keep_exact_energies(entry, make, extra):
    """The control's samplers with int64 energies are a sound chain: the
    energies and fields they carry stay those of their spins."""
    a = make()
    tab = REF.Tables(a, "cpu")
    run = type("R", (), {"traffic": dict(entry=entry, **extra),
                         "seed": 3})()
    st = CTL.from_view(run, REF, tab, {"sigma": spins(4, a["N"])},
                       dtype=torch.int64)
    s0 = st["sigma"].clone()
    st, view = CTL.block(run, REF, tab, st)
    assert torch.equal(view["E"], REF.energy(tab, view["sigma"]))
    assert not torch.equal(view["sigma"], s0)
    if "aux" in view:
        assert torch.equal(view["aux"], REF.fields(tab, view["sigma"]))
    if "emin" in view:
        assert torch.equal(view["emin"], REF.energy(tab, view["sigma_min"]))


def test_control_precision_cannot_hold_the_cells_energies():
    """bfloat16 holds whole numbers exactly only up to 256: the cells'
    energies (|E| in the thousands) are rounded, whatever their residue
    mod 4; int16 and float32 would hold them all."""
    for step in (2, 4):
        E = torch.arange(-12800, -4000, step, dtype=torch.int64)
        assert not torch.equal(E.to(CTL.PRECISION).long(), E)
        assert torch.equal(E.to(torch.int16).long(), E)
        assert torch.equal(E.to(torch.float32).long(), E)
    small = torch.arange(-256, 257)
    assert torch.equal(small.to(CTL.PRECISION).long(), small)


@pytest.mark.parametrize("d,t", [([0, 0, 0], 0.0), ([1, 1, 1], math.inf),
                                 ([1, -1, 1, -1], 0.0),
                                 ([2, 0, 2, 0], math.sqrt(3))])
def test_t_stat(d, t):
    assert checks.t_stat(torch.tensor(d)) == pytest.approx(t)


@pytest.mark.parametrize("traffic,half", [
    ({"entry": "sweepMC", "beta": 1.0, "block": 4, "step": 2}, 2),
    ({"entry": "extremal_opt", "tau": 1.4, "block": 61}, 30)])
def test_replay_separates_half_the_work(traffic, half):
    """work_z: an output of the plain sampler on another stream reads as
    sound; one of half the block's moves or sweeps does not."""
    a = ea(L=6)
    tab = REF.Tables(a, "cpu")
    sigma = spins(256, a["N"], seed=3)
    before = {"sigma": sigma, "E": REF.energy(tab, sigma)}

    def output(block, seed):
        run = SimpleNamespace(seed=seed, traffic=dict(traffic, block=block))
        st = CTL.from_view(run, REF, tab, before, dtype=torch.int64)
        return CTL.block(run, REF, tab, st)[1]

    run = SimpleNamespace(seed=11, traffic=traffic)
    sound = checks.replay(CTL, REF, tab, run,
                          [(before, output(traffic["block"], 99))])
    short = checks.replay(CTL, REF, tab, run, [(before, output(half, 13))])
    assert sound < 4 < 8 < short
