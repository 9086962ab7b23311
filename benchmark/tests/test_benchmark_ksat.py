"""The K-SAT cell (`ksat-n1e4.bkl-b4`) at a small size on the CPU, on the
port's plain version of the SAT race kernel: sound runs are `correct`,
every fault and the control are not; the reference's z and z_flipped
against brute force; the kernel's name and its work floor; the generator."""

import json
import re

import numpy as np
import pytest
import torch

from benchmark.faults import FAULTS
from benchmark.harness import run_cell
from benchmark.manifest import Manifest
from conftest import SMALL, small_copy
from test_benchmark_work import KERNEL_NAMES, OTHERS, ctx_of

CELL = "ksat-n1e4.bkl-b4"
MAN = Manifest()
GEN = MAN.generator({"generator": "sat"})
REF = MAN.reference({"reference": "sat"})
CTL = MAN.module("references", "sat_control")
SAT_KERNELS = ["void rrrmc::rejfree_sat_kernel<512, int>(SatArgs)",
               "void rrrmc::rejfree_sat_kernel<256, float>(SatArgs)"]


def quiet(*a):
    pass


def cut(man, config=None, traffic=None):
    """Cut the copy's K-SAT configuration to N = 64 and its traffic to
    bkl-b4's small sizes, then apply the updates given."""
    b = man.base
    for f, upd in (("configs/ksat-n1e4.json", {"N": 64, **(config or {})}),
                   ("traffic/bkl-b4-c128.json",
                    {**SMALL["bkl-b4"], **(traffic or {})})):
        d = json.loads((b / f).read_text())
        d.update(upd)
        (b / f).write_text(json.dumps(d))
    return man


@pytest.fixture
def ksat(tmp_path):
    return cut(small_copy(tmp_path))


def formula(N=40, alpha=4.2, seed=1, K=3):
    return GEN.make({"N": N, "K": K, "alpha": alpha},
                    np.random.default_rng(seed))


def spins(B, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 2, (B, N), generator=g) * 2 - 1).to(torch.int8)


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 1])
def test_sound_runs_are_correct(ksat, seed):
    res = run_cell(CELL, seed, 0.05, False, device="cpu", manifest=ksat,
                   log=quiet)
    assert res["correct"], res["checks"]
    assert res["checks"]["work_ratio_gap"]["value"] < 0.5


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_are_not_correct(ksat, fault):
    res = run_cell(CELL, 3, 0.05, False, device="cpu", manifest=ksat,
                   block_hook=FAULTS[fault], log=quiet)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [4, 5])
def test_control_is_not_correct(ksat, seed):
    """The control (a bfloat16 coordinate) at the small block, whose last
    thousands of iterations its coordinate holds 8-16 apart: the block
    ends after fewer moves than a sound chain makes."""
    res = run_cell(CELL, seed, 0.01, False, device="cpu", manifest=ksat,
                   control=True, log=quiet)
    assert not res["correct"]
    assert res["checks"]["work_ratio_gap"]["value"] > 0.5
    assert res["checks"]["energy_gap"]["value"] == 0


@pytest.mark.parametrize("N,alpha,K", [(40, 4.2, 3), (30, 2.0, 4),
                                       (12, 6.0, 3)])
def test_z_and_z_flipped_by_brute_force(N, alpha, K):
    a = formula(N, alpha, seed=N, K=K)
    tab = REF.Tables(a, "cpu")
    s = spins(5, N, seed=7)
    beta = 0.9
    E = REF.energy(tab, s)
    d = torch.stack([REF.energy(tab, flip(s, i)) - E for i in range(N)], 1)
    assert torch.equal(REF.delta(tab, s), d)
    assert torch.allclose(REF.z(tab, s, beta),
                          torch.exp(-beta * d.double().clamp(min=0)).sum(1))
    zf = REF.z_flipped(tab, s, beta)
    for i in range(N):
        assert torch.allclose(zf[:, i], REF.z(tab, flip(s, i), beta))


def flip(s, i):
    t = s.clone()
    t[:, i] = -t[:, i]
    return t


def test_reference_counts_by_hand():
    """Two clauses on four variables, (x0 or not x1 or x2) and (not x0 or
    x1 or x3), at all-up spins and at one flip."""
    a = {"N": 4, "K": 3, "Mc": 2, "A": np.array([[0, 1, 2], [0, 1, 3]]),
         "L": np.array([[1, -1, 1], [-1, 1, 1]])}
    tab = REF.Tables(a, "cpu")
    s = torch.tensor([[1, 1, 1, 1], [1, 1, -1, -1]], dtype=torch.int8)
    assert REF.fields(tab, s).tolist() == [[2, 2], [1, 1]]
    assert REF.energy(tab, s).tolist() == [0, 0]
    # chain 1: x0 alone satisfies clause 0, x1 alone clause 1
    assert REF.delta(tab, s).tolist() == [[0, 0, 0, 0], [1, 1, 0, 0]]


def test_held_rounds_up_to_bfloat16():
    x = torch.tensor([0, 1, 255, 256, 257, 300, 40000, 65535, 65536])
    h = CTL.held(x, torch.bfloat16)
    assert torch.equal(h.to(torch.bfloat16).long(), h)
    assert bool((h >= x).all())
    assert h.tolist()[:5] == [0, 1, 255, 256, 258]
    assert h[6] == 40192 and h[7] == 65536 and h[8] == 65536
    assert torch.equal(CTL.held(x, torch.int64), x)


def test_plain_sampler_keeps_exact_energies():
    """The control's sampler with an int64 coordinate is a sound chain:
    the energies and counts it carries stay those of its spins, and its
    last checkpoint is one flip from its energy."""
    a = formula(60, 3.0, seed=3)
    tab = REF.Tables(a, "cpu")
    run = type("R", (), {"traffic": {"entry": "bklMC", "beta": 1.0,
                                     "block": 3000, "step": 1000},
                         "seed": 3})()
    st = CTL.from_view(run, REF, tab, {"sigma": spins(4, 60)},
                       dtype=torch.int64)
    s0 = st["sigma"].clone()
    st, view = CTL.block(run, REF, tab, st)
    assert torch.equal(view["E"], REF.energy(tab, view["sigma"]))
    assert torch.equal(view["aux"], REF.fields(tab, view["sigma"]))
    assert not torch.equal(view["sigma"], s0)
    d = view["series"][:, -1] - view["E"]
    assert bool((REF.delta(tab, view["sigma"]) == d[:, None]).any(1).all())


def test_kernel_names():
    rx = re.compile(MAN.work("rejfree_sat").KERNELS)
    assert all(rx.search(n) for n in SAT_KERNELS)
    others = OTHERS + [n for ns in KERNEL_NAMES.values() for n in ns]
    others.append("void rrrmc::eo_chain_kernel<(anonymous namespace)::"
                  "SatFlip, unsigned char, 0, 1>(EoArgs, SatTables)")
    assert not any(rx.search(n) for n in others)
    for k, names in KERNEL_NAMES.items():
        krx = re.compile(MAN.work(k).KERNELS)
        assert not any(krx.search(n) for n in SAT_KERNELS)


def test_floor_by_hand():
    """Two clauses of three literals on N = 4 (mean degree 6 / 4): a move
    costs 3 + 3 x 1.5 = 7.5 operations; a block moves 2 B N + 16 B bytes
    of spins, energies and counters, a launch 8 B Mc + 16 K Mc of counts
    and tables."""
    a = {"N": 4, "K": 3, "Mc": 2, "A": np.array([[0, 1, 2], [0, 1, 3]]),
         "L": np.array([[1, -1, 1], [-1, 1, 1]])}
    ctx = ctx_of({"chains": 5}, a, {"moves": 100, "iters": 10 ** 6},
                 blocks=10, name=SAT_KERNELS[0])
    f = MAN.work("rejfree_sat").floor(ctx)
    assert f == {"ops": 750, "bytes": 10 * (2 * 5 * 4 + 16 * 5)
                 + 1 * (8 * 5 * 2 + 16 * 3 * 2)}
    ctx["work"] = {"moves": 200, "iters": 1}
    assert MAN.work("rejfree_sat").floor(ctx)["ops"] == 1500


@pytest.mark.parametrize("N,K,alpha", [(64, 3, 4.2), (200, 3, 4.2),
                                       (10, 5, 3.0)])
def test_generator_follows_the_seed_and_draws_distinct_variables(N, K,
                                                                 alpha):
    a, b, c = formula(N, alpha, 3, K), formula(N, alpha, 3, K), \
        formula(N, alpha, 4, K)
    assert a["Mc"] == round(alpha * N) and a["A"].shape == (a["Mc"], K)
    assert a["A"].dtype == np.int32 and a["L"].dtype == np.int32
    assert np.array_equal(a["A"], b["A"]) and np.array_equal(a["L"], b["L"])
    assert not np.array_equal(a["A"], c["A"])
    assert all(len(set(row)) == K for row in a["A"].tolist())
    assert a["A"].min() >= 0 and a["A"].max() < N
    assert set(np.unique(a["L"]).tolist()) == {-1, 1}
