"""extremal_opt of the port (rrrmc_tpu_torch/samplers/eo.py): eligibility and
LAST_ROUTE; the kernel route against the generic torch route (one law, one
set of Philox streams, so the same moves), the dense EO kernel against the
sparse one on one graph, split launches, the law checks of the JAX
package's EO kernel tests (tests/test_eo_pallas.py) on both routes, and the
port's best energies against the JAX package's extremal_opt."""

import dataclasses

import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops.eo import (eo_sparse_chunk, hist_bins, key_bins,
                                    sort_key, select_rank_with_ties)
from rrrmc_tpu_torch.ops.eo_dense import eo_dense_chunk
from rrrmc_tpu_torch.ops.rejfree_dense import kernel_couplings
from rrrmc_tpu_torch.samplers.eo import eo_kernel_route, rank_table

from torch_port_helpers import CPU, port_lattice, random_sigma

torch.set_num_threads(1)

#: name -> (builder, the kernel route it takes)
MODELS = {
    "RRG150": (lambda: pt.GraphRRG(150, 3, (-1, 1), seed=21, **CPU),
               "sparse"),
    "EA(4,3)": (lambda: pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU), "sparse"),
    "SK64": (lambda: pt.GraphSK(64, seed=3, **CPU), "dense"),
    "densify(RRG96)": (lambda: pt.densify(pt.GraphRRG(96, 3, (-1, 1),
                                                      seed=23, **CPU)),
                       "dense"),
    "RRGNormal96": (lambda: pt.GraphRRGNormal(96, 3, seed=5, **CPU),
                    "sparse"),
    "EANormal(4,2)": (lambda: pt.GraphEANormal(4, 2, seed=7, **CPU),
                      "sparse"),
    "SKNormal64": (lambda: pt.GraphSKNormal(64, seed=3, **CPU), "dense"),
}
KEYS = ("sigma", "E", "Emin", "sigma_min", "itmin")


def _check_invariants(m, r, iters):
    """E == energy(sigma) and Emin == energy(sigma_min), exactly for integer
    couplings (physical float32 of exact int32 energies) and within
    1e-4 * N for float ones; itmin in [0, iters]; Emin <= E."""
    E_re = m.to_physical(m.energy(r.sigma))
    Emin_re = m.to_physical(m.energy(r.sigma_min))
    if m.J.dtype.is_floating_point:
        assert float((E_re - r.E).abs().max()) <= 1e-4 * m.N
        assert float((Emin_re - r.Emin).abs().max()) <= 1e-4 * m.N
    else:
        assert torch.equal(E_re, r.E) and torch.equal(Emin_re, r.Emin)
    assert bool(((r.itmin >= 0) & (r.itmin <= iters)).all())
    assert bool((r.Emin <= r.E).all())


@pytest.mark.parametrize("name", list(MODELS))
def test_kernel_route_equals_torch_route(name):
    """The kernel route (here the plain versions) and the generic route on
    model.delta_all / model.flip make the same moves from the same Philox
    streams: equal results, float couplings included (the same one rounding
    per field update)."""
    build, route = MODELS[name]
    m = build()
    assert eo_kernel_route(m) == route
    k = pt.extremal_opt(m, 1.4, 150, chains=16, seed=3, **CPU)
    assert pt.LAST_ROUTE == {"backend": f"kernel-eo-{route}",
                             "impl": "plain"}
    t = pt.extremal_opt(m, 1.4, 150, chains=16, seed=3, backend="torch",
                        **CPU)
    assert pt.LAST_ROUTE == {"backend": "torch", "impl": "plain"}
    for key in KEYS:
        assert torch.equal(getattr(k, key), getattr(t, key)), key
    _check_invariants(m, k, 150)
    assert int(k.itmin.max()) > 0


def test_dense_eo_equals_sparse_eo():
    """On a graph and its densified copy the two EO kernels' plain versions
    make the same moves: one law, one stream, exact int32 fields."""
    m = pt.GraphRRG(150, 3, (-1, 1), seed=21, **CPU)
    s = pt.extremal_opt(m, 1.4, 200, chains=32, seed=9, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-eo-sparse"
    d = pt.extremal_opt(pt.densify(m), 1.4, 200, chains=32, seed=9, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-eo-dense"
    for key in KEYS:
        assert torch.equal(getattr(s, key), getattr(d, key)), key


def _chunk_state(m, B, seed=4):
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(seed), B,
                                          m.N))
    lf = m.local_fields(sigma)
    E = m.energy(sigma).to(lf.dtype)
    return [sigma, lf, E, E.clone(), sigma.clone(),
            torch.zeros(B, dtype=torch.int32)]


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_split_launches_equal_one(kind):
    """Moves are counted across launches (move0): 20 + 30 moves equal 50,
    itmin included."""
    m = pt.GraphRRG(96, 3, (-1, 1), seed=23, **CPU)
    if kind == "dense":
        m = pt.densify(m)
        tables, chunk = (kernel_couplings(m),), eo_dense_chunk
    else:
        tables, chunk = (m.neigh, m.J), eo_sparse_chunk
    cdf = rank_table(m.N, 1.4, "cpu")
    one, two = _chunk_state(m, 16), _chunk_state(m, 16)
    chunk(*one, *tables, cdf, n_moves=50, seed=7)
    chunk(*two, *tables, cdf, n_moves=20, seed=7)
    chunk(*two, *tables, cdf, n_moves=30, seed=7, move0=20)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert int(one[5].max()) > 20


def test_chunk_independent_of_batch_layout():
    """Philox keys on the global chain id: two halves run with chain0
    offsets give the whole batch's results."""
    m = pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU)
    cdf = rank_table(m.N, 1.4, "cpu")
    whole = _chunk_state(m, 16)
    eo_sparse_chunk(*whole, m.neigh, m.J, cdf, n_moves=40, seed=3)
    lo = [t[:8].clone() for t in _chunk_state(m, 16)]
    hi = [t[8:].clone() for t in _chunk_state(m, 16)]
    eo_sparse_chunk(*lo, m.neigh, m.J, cdf, n_moves=40, seed=3)
    eo_sparse_chunk(*hi, m.neigh, m.J, cdf, n_moves=40, seed=3, chain0=8)
    for w, a, b in zip(whole, lo, hi):
        assert torch.equal(w, torch.cat([a, b]))


def _rank_law_model(name):
    return {"EA(4,2)": lambda: pt.GraphEA(4, 2, (-1, 1), seed=11, **CPU),
            "densify(RRG72)": lambda: pt.densify(pt.GraphRRG(
                72, 3, (-1, 1), seed=31, **CPU)),
            "SKNormal16": lambda: pt.GraphSKNormal(16, seed=11, **CPU),
            "RRG72": lambda: pt.GraphRRG(72, 3, (-1, 1), seed=31, **CPU),
            }[name]()


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("name", ["EA(4,2)", "densify(RRG72)", "SKNormal16",
                                  "RRG72"])
def test_rank_law_tau8(name, backend):
    """tau = 8: rank 0 has probability ~0.996, so one move from a fixed
    configuration flips a site of minimal dE in (almost) every chain: the
    rank draw, the order statistic and the tie race at once."""
    m = _rank_law_model(name)
    C0 = np.random.RandomState(0).choice(np.array([-1, 1], np.int8), m.N)
    r = pt.extremal_opt(m, 8.0, 1, chains=128, seed=13, C0=C0,
                        backend=backend, **CPU)
    c0 = torch.from_numpy(C0)
    flips = r.sigma != c0[None, :]
    assert bool((flips.sum(dim=1) == 1).all()), "exactly one flip per chain"
    dE = m.delta_all(c0[None, :], m.init_aux(c0[None, :]))[0].double()
    picked = dE[flips.int().argmax(dim=1)]
    n_min = int(((picked - dE.min()).abs() < 1e-5).sum())
    assert n_min >= 120, (n_min, dE.min())


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_ferromagnet_reaches_ground_state(backend):
    """All-(+1) couplings: EO reaches the known ground state -D*N."""
    m = pt.GraphEA(4, 2, (1, 1), seed=1, **CPU)
    r = pt.extremal_opt(m, 1.5, 400, chains=128, seed=7, backend=backend,
                        **CPU)
    assert float(r.Emin.min()) == -2.0 * m.N
    _check_invariants(m, r, 400)


def test_field_lattice_pins_the_ground_state():
    """A LatticeEA with integer fields rides the sparse kernel with exact
    energies, and a dominant uniform field pins the best state to all-up
    (E = -(pair + h.sigma))."""
    m0 = pt.GraphEA(4, 2, (-1, 1), seed=11, **CPU)
    h = torch.from_numpy(np.random.RandomState(3).randint(-2, 3, m0.N))
    m = dataclasses.replace(m0, h=h.to(m0.h.dtype))
    r = pt.extremal_opt(m, 1.4, 300, chains=64, seed=3, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-eo-sparse"
    _check_invariants(m, r, 300)
    mf = dataclasses.replace(m0, h=torch.full((m0.N,), 16, dtype=m0.h.dtype))
    rf = pt.extremal_opt(mf, 1.5, 300, chains=64, seed=7, **CPU)
    best = int(rf.Emin.argmin())
    assert bool((rf.sigma_min[best] == 1).all())


def test_kernel_law_matches_torch_route_other_seed():
    """Mean best energy after a fixed budget: the kernel route and the
    torch route under different seeds agree within 0.04 per spin."""
    m = pt.GraphEA(4, 2, (-1, 1), seed=21, **CPU)
    k = pt.extremal_opt(m, 1.3, 800, chains=128, seed=5, **CPU)
    t = pt.extremal_opt(m, 1.3, 800, chains=128, seed=6, backend="torch",
                        **CPU)
    a, b = float(k.Emin.mean()) / m.N, float(t.Emin.mean()) / m.N
    assert abs(a - b) < 0.04, (a, b)


@pytest.mark.parametrize("name", ["EA(4,2)", "SK64"])
def test_best_energy_matches_jax_extremal_opt(name):
    """The port's mean best energy on a JAX instance agrees with the JAX
    package's extremal_opt (its generic "xla" path; independent streams)
    within 0.04 per spin."""
    if name == "EA(4,2)":
        jm = rt.GraphEA(4, 2, (-1, 1), seed=21)
        pm = port_lattice(jm)
    else:
        jm = rt.GraphSK(64, seed=3)
        pm = pt.fully_connected_from_arrays(np.asarray(jm.J),
                                            np.asarray(jm.h), scale=jm.scale,
                                            **CPU)
    j = rt.extremal_opt(jm, 1.3, iters=600, chains=128, seed=6,
                        backend="xla")
    p = pt.extremal_opt(pm, 1.3, 600, chains=128, seed=5, **CPU)
    a = float(np.asarray(j.Emin).mean()) / jm.N
    b = float(p.Emin.mean()) / pm.N
    assert abs(a - b) < 0.04, (a, b)


@pytest.mark.parametrize("build,route", [
    (lambda: pt.GraphRRG(16, 3, **CPU), "sparse"),
    (lambda: pt.GraphEA(4, 2, (-1, 1), **CPU), "sparse"),
    (lambda: pt.GraphEANormal(4, 2, **CPU), "sparse"),
    (lambda: pt.GraphSK(16, **CPU), "dense"),
    (lambda: pt.GraphSKNormal(16, **CPU), "dense"),
    (lambda: pt.GraphSK(6, **CPU), None),                      # N < 8
    (lambda: pt.make_fully_connected(200 * (1 - np.eye(8)), scale=1.0,
                                     **CPU), None),            # |J| > 127
])
def test_eo_kernel_route(build, route):
    """Eligibility: the race kernels' rule (sparse Pairwise, lattices
    included; FullyConnected with integer |J| <= 127 or float J), no TPU
    caps; an ineligible model takes the torch route under "auto" and
    raises under "kernel"."""
    m = build()
    assert eo_kernel_route(m) == route
    if route is None:
        pt.extremal_opt(m, 1.4, 5, chains=4, **CPU)
        assert pt.LAST_ROUTE["backend"] == "torch"
        with pytest.raises(NotImplementedError, match="not eligible"):
            pt.extremal_opt(m, 1.4, 5, chains=4, backend="kernel", **CPU)


def test_argument_errors():
    m = pt.GraphRRG(16, 3, **CPU)
    with pytest.raises(ValueError, match="backend"):
        pt.extremal_opt(m, 1.4, 5, backend="pallas", **CPU)
    with pytest.raises(ValueError, match="block_chains"):
        pt.extremal_opt(m, 1.4, 5, block_chains=128, **CPU)
    st = _chunk_state(m, 4)
    cdf = rank_table(m.N, 1.4, "cpu")
    with pytest.raises(ValueError, match="cdf"):
        eo_sparse_chunk(*st, m.neigh, m.J, cdf[:-1], n_moves=1, seed=1)
    with pytest.raises(ValueError, match="J"):
        eo_dense_chunk(*st, pt.densify(m).J.int(), cdf, n_moves=1, seed=1)


def test_runs_on_the_card_by_default():
    """Without `device` extremal_opt starts its chains on CUDA: on a
    machine without a card that raises torch's own error, never a quiet
    CPU run."""
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pt.extremal_opt(pt.GraphRRG(16, 3, **CPU), 1.4, 5, chains=4)
        return
    r = pt.extremal_opt(pt.GraphRRG(16, 3), 1.4, 5, chains=4)
    assert r.sigma.device.type == "cuda"


def test_select_rank_with_ties_and_sort_key():
    """The order statistic with the tie race, and the float key order:
    -0.0 sorts below +0.0, negatives below positives."""
    key = torch.tensor([[3, 1, 2, 1, 1]], dtype=torch.int32)
    bits = torch.tensor([[0, 9, -5, 4, 4]], dtype=torch.int32)
    for rank, want in ((0, 3), (1, 3), (2, 3), (3, 2), (4, 0)):
        got = select_rank_with_ties(key, torch.tensor([rank]), bits)
        assert int(got) == want, (rank, int(got))
    ties = torch.tensor([[7, 2 ** 31 - 1, 2 ** 31 - 1]], dtype=torch.int32)
    assert int(select_rank_with_ties(torch.tensor([[5, 1, 1]]),
                                     torch.tensor([0]), ties)) == 1
    x = torch.tensor([-1.5, -0.0, 0.0, 2.0, -3.0])
    assert sort_key(x).argsort().tolist() == [4, 0, 1, 2, 3]
    assert int(sort_key(x)[1]) == -1 and int(sort_key(x)[2]) == 0


def test_hist_bins():
    """The kernels count integer keys in 2*half_max + 1 bins up to
    HIST_MAX; float keys and wider ranges take the radix select."""
    assert hist_bins(True, 3) == 7
    assert hist_bins(True, 2047) == 4095
    assert hist_bins(True, 2048) == 0
    assert hist_bins(True, None) == 0 and hist_bins(False, 3) == 0


def test_key_bins():
    """The hypergraph EO kernels, which take no radix select, count their
    keys |key| <= key_max in 2*key_max + 1 bins and refuse more than
    HIST_MAX."""
    assert key_bins(3, "PSpin3") == 7
    assert key_bins(2047, "SAT") == 4095
    with pytest.raises(NotImplementedError, match="SAT EO kernel"):
        key_bins(2048, "SAT")
