"""The port's K-SAT model (rrrmc_tpu_torch/models/sat.py) against the JAX
package's, and its samplers through the public API: the same seed gives the
same clause tables; on the same spins energies, satisfied counts (aux),
delta_all, delta_one and masked flips agree bit for bit (exact int32);
export_cnf writes the same bytes; bklMC, wtmMC and rrrMC take the SAT race
route and extremal_opt the SAT EO route, whose moves equal the generic
torch route's; clauses with a repeated variable stay off the kernels; and
the race samples the Boltzmann law on a 14-variable instance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops.eo_sat import eo_sat_chunk
from rrrmc_tpu_torch.ops.sat import (rejfree_sat_chunk, sat_rejfree_ok,
                                     sat_tables)
from rrrmc_tpu_torch.samplers.eo import eo_kernel_route, rank_table

from torch_port_helpers import CPU, port_sat, random_sigma

torch.set_num_threads(1)

B = 16
#: (N, K, alpha, seed) of the instances both packages build
CASES = [(12, 3, 2.5, 42), (20, 3, 3.0, 5), (24, 4, 2.5, 7), (40, 5, 4.0, 3)]
KEYS = ("sigma", "E", "Emin", "sigma_min", "itmin")
TABLES = ("A", "L", "T", "TL")
SIZES = ("N", "Mc", "K", "Cmax", "max_conn", "scale")


def _pair(N, K, alpha, seed):
    return (rt.GraphSAT(N, K, alpha, seed=seed),
            pt.GraphSAT(N, K, alpha, seed=seed, **CPU))


@pytest.mark.parametrize("case", CASES)
def test_same_seed_same_tables(case):
    jm, pm = _pair(*case)
    assert tuple(getattr(pm, a) for a in SIZES) == tuple(
        getattr(jm, a) for a in SIZES)
    for a in TABLES:
        assert getattr(pm, a).dtype == torch.int32
        np.testing.assert_array_equal(getattr(pm, a).numpy(),
                                      np.asarray(getattr(jm, a)), err_msg=a)
    cm = port_sat(jm)
    assert all(torch.equal(getattr(cm, a), getattr(pm, a)) for a in TABLES)
    assert pm.delta_classes() == jm.delta_classes()
    assert pm.var_neighb() == jm.var_neighb()


def test_make_sat_padding_and_order():
    """Explicit clauses with a padded entry (id N) and a literal sign 0
    build the JAX tables, each variable's slots in clause order; aux and
    delta_all treat both as the JAX model does (the padded entry counts as
    satisfied, the sign 0 adds no violated term)."""
    A = np.array([[0, 1, 2], [1, 2, 3], [3, 0, 4], [2, 4, 5]], np.int32)
    L = np.array([[1, -1, 1], [-1, -1, 1], [1, 1, 0], [-1, 1, 1]], np.int32)
    jm, pm = rt.make_sat(5, A, L), pt.make_sat(5, A, L, **CPU)
    for a in TABLES:
        np.testing.assert_array_equal(getattr(pm, a).numpy(),
                                      np.asarray(getattr(jm, a)), err_msg=a)
    sigma = random_sigma(np.random.default_rng(0), B, 5)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma)
    aux_j = jax.vmap(jm.init_aux)(sj)
    np.testing.assert_array_equal(pm.init_aux(sp).numpy(), np.asarray(aux_j))
    np.testing.assert_array_equal(
        pm.delta_all(sp, pm.init_aux(sp)).numpy(),
        np.asarray(jax.vmap(jm.delta_all)(sj, aux_j)))


@pytest.mark.parametrize("case", CASES)
def test_energy_aux_delta(case):
    jm, pm = _pair(*case)
    sigma = random_sigma(np.random.default_rng(1), B, jm.N)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma)
    aux_j = jax.vmap(jm.init_aux)(sj)
    E_j = np.asarray(jax.vmap(jm.energy)(sj))
    d_j = np.asarray(jax.vmap(jm.delta_all)(sj, aux_j))
    aux_p = pm.init_aux(sp)
    for got, want in ((pm.energy(sp), E_j), (aux_p, np.asarray(aux_j)),
                      (pm.delta_all(sp, aux_p), d_j)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    i = np.random.default_rng(2).integers(0, jm.N, B)
    one_j = np.asarray(jax.vmap(jm.delta_one)(sj, aux_j, jnp.asarray(i)))
    np.testing.assert_array_equal(
        pm.delta_one(sp, aux_p, torch.from_numpy(i)).numpy(), one_j)


@pytest.mark.parametrize("case", CASES[:3])
def test_masked_flips(case):
    """Masked flips (do = False leaves a chain untouched) keep sigma and the
    counts equal to the JAX model's and to a fresh init_aux."""
    jm, pm = _pair(*case)
    rng = np.random.default_rng(3)
    sigma = random_sigma(rng, B, jm.N)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma.copy())
    aj, ap = jax.vmap(jm.init_aux)(sj), pm.init_aux(sp)
    flip = jax.jit(jax.vmap(jm.flip))
    for _ in range(30):
        i = rng.integers(0, jm.N, B)
        do = rng.random(B) < 0.7
        sj, aj = flip(sj, aj, jnp.asarray(i), jnp.asarray(do))
        pm.flip(sp, ap, torch.from_numpy(i), torch.from_numpy(do))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
    assert torch.equal(ap, pm.init_aux(sp))


@pytest.mark.parametrize("decimate", [None, [1], [1, -4, 7]])
def test_export_cnf_same_bytes(tmp_path, decimate):
    jm, pm = _pair(10, 3, 2.0, 9)
    pj, pp = tmp_path / "jax.cnf", tmp_path / "port.cnf"
    rt.export_cnf(jm, str(pj), decimate=decimate)
    pt.export_cnf(pm, str(pp), decimate=decimate)
    assert pp.read_bytes() == pj.read_bytes()


@pytest.mark.parametrize("sampler", ["bkl", "wtm", "rrr", "standard"])
def test_samplers_route_and_exact_energy(sampler):
    """The race samplers take the SAT race kernel's plain version, and
    standardMC its generic torch route, unchanged; the running energy and
    the resident counts stay exact."""
    m = pt.GraphSAT(32, 3, 3.5, seed=6, **CPU)
    kw = dict(chains=8, seed=1, **CPU)
    run = {"bkl": lambda: pt.bklMC(m, 2.0, 3000, step=300, **kw),
           "wtm": lambda: pt.wtmMC(m, 2.0, 10, step=30.0, **kw),
           "rrr": lambda: pt.rrrMC(m, 2.0, 1280, step=128, **kw),
           "standard": lambda: pt.standardMC(m, 2.0, 2000, step=200, **kw)}
    Es, st = run[sampler]()
    route = "torch" if sampler == "standard" else "kernel-rejfree-sat"
    assert pt.LAST_ROUTE["backend"] == route
    assert Es.shape == (8, 10) and bool(torch.isfinite(Es).all())
    assert torch.equal(m.energy(st.sigma), st.E)
    assert torch.equal(m.init_aux(st.sigma), st.aux)
    assert int(st.accepted.min()) > 0


def test_extremal_opt_kernel_route_equals_torch_route():
    """The SAT EO kernel's plain version and the generic route on
    model.delta_all / model.flip make the same moves from the same Philox
    streams; on an easy instance EO satisfies every clause."""
    m = pt.GraphSAT(30, 3, 2.0, seed=9, **CPU)
    assert eo_kernel_route(m) == "sat"
    k = pt.extremal_opt(m, 1.4, 300, chains=16, seed=7, **CPU)
    assert pt.LAST_ROUTE == {"backend": "kernel-eo-sat", "impl": "plain"}
    t = pt.extremal_opt(m, 1.4, 300, chains=16, seed=7, backend="torch",
                        **CPU)
    assert pt.LAST_ROUTE == {"backend": "torch", "impl": "plain"}
    for key in KEYS:
        assert torch.equal(getattr(k, key), getattr(t, key)), key
    assert torch.equal(m.to_physical(m.energy(k.sigma_min)), k.Emin)
    assert torch.equal(m.to_physical(m.energy(k.sigma)), k.E)
    assert float(k.Emin.min()) == 0.0


def test_repeated_variable_refused():
    """A clause that holds one variable twice stays off the kernels (the
    one eligibility rule kept): the race samplers and extremal_opt's kernel
    route raise, extremal_opt's auto route takes the generic path (as
    inexact there as the JAX model: a repeated variable's slots count its
    clause twice)."""
    X = pt.make_sat(8, np.array([[0, 0, 1], [2, 3, 4], [5, 6, 7]]),
                    np.array([[1, -1, 1], [1, 1, -1], [-1, 1, 1]]), **CPU)
    assert not sat_rejfree_ok(X)
    assert sat_rejfree_ok(pt.GraphSAT(16, 3, 2.0, seed=3, **CPU))
    with pytest.raises(NotImplementedError, match="distinct"):
        pt.bklMC(X, 1.0, 100, **CPU)
    with pytest.raises(NotImplementedError, match="distinct"):
        pt.extremal_opt(X, 1.4, 10, backend="kernel", **CPU)
    pt.extremal_opt(X, 1.4, 50, chains=4, seed=1, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch"


DEFAULT_BUILDERS = {
    "GraphSAT": lambda: pt.GraphSAT(12, 3, 2.5, seed=1),
    "make_sat": lambda: pt.make_sat(4, [[0, 1, 2]], [[1, 1, -1]]),
    "sat_from_arrays": lambda: pt.sat_from_arrays(4, [[0, 1, 2]],
                                                  [[1, 1, -1]]),
}


@pytest.mark.parametrize("name", list(DEFAULT_BUILDERS))
def test_builders_default_to_the_card(name):
    """Without `device` the builders place the tables on CUDA: on a
    machine without a card that raises torch's own error, never a quiet CPU
    model."""
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            DEFAULT_BUILDERS[name]()
        return
    assert DEFAULT_BUILDERS[name]().A.device.type == "cuda"


def _chunk_state(m, B, seed=4):
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(seed), B,
                                          m.N))
    return sigma, m.init_aux(sigma), m.energy(sigma)


def _race(m, st, n, move0, chain0=0):
    sigma, sat, E = st[:3]
    B = sigma.shape[0]
    coord = torch.zeros(B, dtype=torch.int32) if move0 == 0 else st[3]
    acc = torch.zeros(B, dtype=torch.int32) if move0 == 0 else st[4]
    zacc = torch.zeros(B, dtype=torch.float32) if move0 == 0 else st[5]
    cs, es = rejfree_sat_chunk(sigma, sat, E, coord, acc, zacc,
                               *sat_tables(m), mode="rrr", n_moves=n,
                               beta_s=2.0, target=2 ** 30, seed=7,
                               move0=move0, chain0=chain0)
    return (sigma, sat, E, coord, acc, zacc), cs, es


def test_split_launches_and_batch_layout():
    """Moves are counted across launches (move0) and the Philox keys on the
    global chain id (chain0): 15 + 25 rrr moves equal 40, 20 + 30 EO moves
    equal 50, and two halves of a batch equal the whole; the counts stay in
    the caller's tensor between launches."""
    m = pt.GraphSAT(32, 3, 3.5, seed=6, **CPU)
    one, cs, es = _race(m, _chunk_state(m, 8), 40, 0)
    two, cs1, es1 = _race(m, _chunk_state(m, 8), 15, 0)
    two, cs2, es2 = _race(m, two, 25, 15)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(cs, torch.cat([cs1, cs2])) and torch.equal(
        es, torch.cat([es1, es2]))
    assert torch.equal(one[1], m.init_aux(one[0]))
    lo, _, _ = _race(m, tuple(t[:4] for t in _chunk_state(m, 8)), 40, 0)
    hi, _, _ = _race(m, tuple(t[4:] for t in _chunk_state(m, 8)), 40, 0,
                     chain0=4)
    assert all(torch.equal(a, torch.cat([b, c]))
               for a, b, c in zip(one, lo, hi))
    cdf = rank_table(m.N, 1.4, "cpu")
    runs = []
    for parts in ((50,), (20, 30)):
        sigma, sat, E = _chunk_state(m, 8)
        st = [sigma, sat, E, E.clone(), sigma.clone(),
              torch.zeros(8, dtype=torch.int32)]
        move0 = 0
        for n in parts:
            eo_sat_chunk(*st, *sat_tables(m), cdf, n_moves=n, seed=5,
                         move0=move0)
            move0 += n
        runs.append(st)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(runs[0][1], m.init_aux(runs[0][0]))


def test_wrappers_check_arguments():
    m = pt.GraphSAT(12, 3, 2.5, seed=1, **CPU)
    sigma, sat, E = _chunk_state(m, 4)
    z = (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
         torch.zeros(4, dtype=torch.float32))
    kw = dict(mode="bkl", n_moves=2, beta_s=1.0, target=10, seed=1)
    A, L, T, TL = sat_tables(m)
    with pytest.raises(ValueError, match="sat:"):
        rejfree_sat_chunk(sigma, sat[:, :-1].contiguous(), E, *z, A, L, T,
                          TL, **kw)
    with pytest.raises(ValueError, match="TL:"):
        rejfree_sat_chunk(sigma, sat, E, *z, A, L, T, TL.long(), **kw)
    with pytest.raises(ValueError, match="mode"):
        rejfree_sat_chunk(sigma, sat, E, *z, A, L, T, TL,
                          **{**kw, "mode": "x"})
    meta = [t.to("meta") for t in (sigma, sat, E, *z, A, L, T, TL)]
    with pytest.raises(ValueError, match="no race kernel"):
        rejfree_sat_chunk(*meta, **kw)
    with pytest.raises(ValueError, match="cdf"):
        eo_sat_chunk(sigma, sat, E, E.clone(), sigma.clone(), z[0], A, L, T,
                     TL, rank_table(m.N - 1, 1.4, "cpu"), n_moves=2, seed=1)


def _boltzmann_mean(model, beta):
    """Exact <E> (physical) by enumerating all 2^N configurations."""
    n = model.N
    idx = torch.arange(2 ** n)
    sigma = (((idx[:, None] >> torch.arange(n)) & 1) * 2 - 1).to(torch.int8)
    E = model.to_physical(model.energy(sigma)).double()
    w = torch.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


BOLTZMANN = {
    "bkl": lambda m: pt.bklMC(m, 1.0, 6000, step=20, chains=128, seed=9,
                              **CPU),
    "wtm": lambda m: pt.wtmMC(m, 1.0, 300, step=20.0, chains=128, seed=9,
                              **CPU),
    "rrr": lambda m: pt.rrrMC(m, 1.0, 1536, step=8, chains=128, seed=9,
                              **CPU),
}


@pytest.mark.parametrize("mode", [
    "bkl", pytest.param("wtm", marks=pytest.mark.slow),
    pytest.param("rrr", marks=pytest.mark.slow)])
def test_race_samples_boltzmann(mode):
    """On a 14-variable 3-SAT instance the checkpoint-series mean matches
    the exact Boltzmann mean within max(5 sigma, 0.05) (the JAX package's
    test_sat_boltzmann, on the port's race)."""
    m = pt.GraphSAT(14, 3, 2.5, seed=11, **CPU)
    Es, _ = BOLTZMANN[mode](m)
    Es = Es.double().numpy()[:, Es.shape[1] // 4:]
    got = Es.mean()
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    want = _boltzmann_mean(m, 1.0)
    assert abs(got - want) < max(5 * sem, 0.05), (got, want, sem)


def test_extremal_opt_emin_law_matches_jax():
    """The distribution of the best energy Emin over chains and seeds: the
    port's extremal_opt(backend="torch") against the JAX package's
    extremal_opt on the CPU, on GraphSAT(120, 3, 4.2) with 64 chains, 500
    moves and two seeds each (128 Emin values a side; the two draw from
    different generators, so only the laws can agree). The means lie
    within 4 standard errors of their difference and the largest gap of the
    two empirical distribution functions is below 0.25 (the two-sample
    Kolmogorov-Smirnov bound at p ~ 1e-3 for 128 + 128 samples)."""
    jm = rt.GraphSAT(120, 3, 4.2, seed=3)
    pm = port_sat(jm)
    kw = dict(chains=64)
    pe = np.concatenate([pt.extremal_opt(
        pm, 1.4, 500, seed=s, backend="torch", **kw, **CPU).Emin.numpy()
        for s in (0, 1)]).astype(np.float64)
    je = np.concatenate([np.asarray(rt.extremal_opt(
        jm, 1.4, 500, seed=s, **kw).Emin) for s in (0, 1)]).astype(
            np.float64)
    se = np.sqrt(pe.var() / pe.size + je.var() / je.size)
    assert abs(pe.mean() - je.mean()) <= 4 * se, (pe.mean(), je.mean(), se)
    lv = np.union1d(pe, je)
    cdf = [np.searchsorted(np.sort(x), lv, side="right") / x.size
           for x in (pe, je)]
    assert np.abs(cdf[0] - cdf[1]).max() < 0.25
