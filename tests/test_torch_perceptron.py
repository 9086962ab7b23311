"""The port's perceptrons (rrrmc_tpu_torch/models/perceptron.py) against the
JAX package's, and their samplers through the public API: the same seed
gives the same patterns and loss tables; on the same spins, energies,
stabilities (aux), delta_all, delta_one and masked flips agree bit for bit
for step and linear, within 1e-5 relative for xentr (the JAX tests run in
x64, the port in float32); bklMC, wtmMC and rrrMC take the perceptron race
route and keep E == energy(sigma), extremal_opt the perceptron EO route,
whose moves equal the generic torch route's on the integer families; the
race samples the Boltzmann law on 13 spins; the replica aliases run the
torch routes; and the two faults of the JAX package's perceptron kernels
are not copied (a family cache keyed on the patterns, and even N)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.models.perceptron import Perceptron, gen_xi
from rrrmc_tpu_torch.ops.perc import perc_family, perc_rejfree_ok
from rrrmc_tpu_torch.samplers.eo import eo_kernel_route
from rrrmc_tpu_torch.samplers.families import family_of

from torch_port_helpers import CPU, port_perceptron, random_sigma

torch.set_num_threads(1)

B = 16
#: (family, N, P, seed) of the instances both packages build
CASES = [("step", 15, 7, 1), ("linear", 15, 7, 2), ("xentr", 15, 7, 3),
         ("step", 31, 15, 4), ("linear", 31, 15, 5), ("xentr", 31, 15, 6)]
BUILDERS = {"step": "GraphPercStep", "linear": "GraphPercLinear",
            "xentr": "GraphPercXEntr"}
LAM = 0.7


def _build(mod, fam, N, P, seed, **kw):
    args = (N, P, LAM) if fam == "xentr" else (N, P)
    return getattr(mod, BUILDERS[fam])(*args, seed=seed, **kw)


def _pair(fam, N, P, seed):
    return _build(rt, fam, N, P, seed), _build(pt, fam, N, P, seed, **CPU)


def _check(p, j, fam, what):
    p = p.numpy()
    j = np.asarray(j)
    if fam == "xentr":
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        np.testing.assert_array_equal(p, j, err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_same_seed_same_tables(case):
    fam, N, P, seed = case
    jm, pm = _pair(*case)
    np.testing.assert_array_equal(
        gen_xi(N, P, np.random.default_rng(seed)),
        np.asarray(jm.xi))
    assert pm.xi.dtype == torch.int8
    np.testing.assert_array_equal(pm.xi.numpy(), np.asarray(jm.xi))
    assert (pm.N, pm.P) == (jm.N, jm.P)
    assert pm.scale == pytest.approx(jm.scale, rel=1e-15)
    if fam == "xentr":
        assert pm.loss_table.dtype == torch.float32
        np.testing.assert_array_equal(
            pm.loss_table.numpy(),
            np.asarray(jm.loss_table).astype(np.float32))
    else:
        assert pm.loss_table.dtype == torch.int32
        np.testing.assert_array_equal(pm.loss_table.numpy(),
                                      np.asarray(jm.loss_table))
    cm = port_perceptron(jm)
    assert torch.equal(cm.xi, pm.xi)
    assert torch.equal(cm.loss_table, pm.loss_table)
    assert perc_family(pm) == fam and perc_rejfree_ok(pm)


@pytest.mark.parametrize("case", CASES)
def test_methods_match_jax(case):
    """energy, init_aux, delta_all at every site, delta_one and a masked
    flip on the same spins, through perceptron_from_arrays."""
    fam = case[0]
    jm, _ = _pair(*case)
    pm = port_perceptron(jm)
    rng = np.random.default_rng(case[3])
    sigma = random_sigma(rng, B, jm.N)
    js = jnp.asarray(sigma)
    ps = torch.from_numpy(sigma.copy())
    jaux = jax.vmap(jm.init_aux)(js)
    paux = pm.init_aux(ps)
    assert paux.dtype == torch.int32
    np.testing.assert_array_equal(paux.numpy(), np.asarray(jaux))
    _check(pm.energy(ps), jax.vmap(jm.energy)(js), fam, "energy")
    _check(pm.delta_all(ps, paux), jax.vmap(jm.delta_all)(js, jaux), fam,
           "delta_all")
    i = rng.integers(0, jm.N, B)
    ji = jnp.asarray(i)
    pi = torch.from_numpy(i)
    _check(pm.delta_one(ps, paux, pi),
           jax.vmap(jm.delta_one)(js, jaux, ji), fam, "delta_one")
    do = rng.integers(0, 2, B).astype(bool)
    js2, jaux2 = jax.vmap(jm.flip)(js, jaux, ji, jnp.asarray(do))
    ps2, paux2 = pm.flip(ps, paux, pi, torch.from_numpy(do))
    np.testing.assert_array_equal(ps2.numpy(), np.asarray(js2))
    np.testing.assert_array_equal(paux2.numpy(), np.asarray(jaux2))
    np.testing.assert_array_equal(paux2.numpy(),
                                  pm.init_aux(ps2).numpy())


@pytest.mark.parametrize("fam", list(BUILDERS))
def test_race_samplers_keep_the_energy(fam):
    """bklMC, wtmMC and rrrMC on the perceptron race route (its plain
    version on the CPU): E == energy(sigma), exactly for step and linear,
    within 1e-4 * max(1, |E|) for xentr."""
    m = _build(pt, fam, 21, 9, 11, **CPU)
    runs = (lambda: pt.bklMC(m, 1.0, 1000, step=100, chains=8, seed=1, **CPU),
            lambda: pt.wtmMC(m, 1.0, 10, step=3.0, chains=8, seed=2, **CPU),
            lambda: pt.rrrMC(m, 1.0, 150, step=15, chains=8, seed=3, **CPU))
    for run in runs:
        Es, st = run()
        assert pt.LAST_ROUTE["backend"] == "kernel-rejfree-perc"
        assert Es.shape == (8, 10) and bool(torch.isfinite(Es).all())
        E_re = m.energy(st.sigma)
        if fam == "xentr":
            err = float((E_re.double() - st.E.double()).abs().max())
            assert err <= 1e-4 * max(1.0, float(E_re.abs().max())), err
        else:
            assert torch.equal(E_re, st.E)
        assert torch.equal(st.aux, m.init_aux(st.sigma))


def _boltzmann_mean(m, beta):
    n = torch.arange(2 ** m.N)
    bits = (n[:, None] >> torch.arange(m.N)) & 1
    E = m.to_physical(m.energy((2 * bits - 1).to(torch.int8))).double()
    w = torch.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


@pytest.mark.parametrize("fam", list(BUILDERS))
def test_bkl_samples_the_boltzmann_law(fam):
    """bklMC's time-averaged E at beta = 1 against exact enumeration of the
    2^13 states, within max(5 standard errors, 0.05) (the JAX package's
    rule)."""
    m = _build(pt, fam, 13, 7, 21, **CPU)
    Es, _ = pt.bklMC(m, 1.0, 6000, step=100, chains=64, seed=9, **CPU)
    tail = Es[:, Es.shape[1] // 4:].double()
    got = float(tail.mean())
    sem = float(tail.std()) / np.sqrt(tail.shape[0] * 3.0)
    exact = _boltzmann_mean(m, 1.0)
    assert abs(got - exact) < max(5 * sem, 0.05), (got, exact, sem)


@pytest.mark.parametrize("fam", ["step", "linear", "xentr"])
def test_extremal_opt_routes(fam):
    """extremal_opt takes the perceptron EO route; E and Emin are the
    energies of sigma and sigma_min; on the integer families its moves
    equal the generic torch route's (the same Philox streams and keys)."""
    m = _build(pt, fam, 21, 9, 12, **CPU)
    assert eo_kernel_route(m) == "perc"
    R = pt.extremal_opt(m, 1.4, 200, chains=8, seed=4, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-eo-perc"
    for s, e in ((R.sigma, R.E), (R.sigma_min, R.Emin)):
        err = (m.to_physical(m.energy(s)).double() - e.double()).abs().max()
        assert float(err) <= (1e-4 if fam == "xentr" else 0.0)
    assert bool(((R.itmin >= 0) & (R.itmin <= 200)).all())
    if fam != "xentr":
        T = pt.extremal_opt(m, 1.4, 200, chains=8, seed=4, backend="torch",
                            **CPU)
        for key in ("sigma", "E", "Emin", "sigma_min", "itmin"):
            assert torch.equal(getattr(R, key), getattr(T, key)), key


@pytest.mark.parametrize("alias", ["GraphQPercStepT", "GraphPercStepRE"])
def test_replica_aliases(alias):
    """The Quant and RE composites over a step perceptron: standardMC and
    extremal_opt(backend="torch") keep the energy invariant; the race
    samplers have no kernel for them: they run the generic torch path,
    with the same energy check, and raise where the kernel is asked
    for."""
    X = getattr(pt, alias)(11, 5, 3, 1.0 if alias.startswith("GraphQ")
                           else 0.5, 1.0, seed=3, **CPU)
    Es, st = pt.standardMC(X, 1.0, 300, step=30, chains=8, seed=1, **CPU)
    err = (X.energy(st.sigma).double() - st.E.double()).abs().max()
    assert float(err) <= 1e-4 * max(1.0, float(st.E.abs().max()))
    R = pt.extremal_opt(X, 1.4, 100, chains=8, backend="torch", **CPU)
    err = (X.energy(R.sigma).double() - R.E.double()).abs().max()
    assert float(err) <= 1e-4 * max(1.0, float(R.E.abs().max()))
    assert family_of(X) is None
    for f in (pt.bklMC, pt.rrrMC):
        Es, st = f(X, 1.0, 100, step=10, chains=8, **CPU)
        assert pt.LAST_ROUTE["backend"] == "torch"
        err = (X.energy(st.sigma).double() - st.E.double()).abs().max()
        assert float(err) <= 1e-4 * max(1.0, float(st.E.abs().max()))
        with pytest.raises(NotImplementedError, match="not eligible"):
            f(X, 1.0, 100, chains=8, backend="kernel", **CPU)


def test_builders_default_to_the_card():
    """Without a device the builders put their tables on CUDA: on a
    machine without a card they raise rather than fall back to the host."""
    if torch.cuda.is_available():
        assert pt.GraphPercStep(15, 7, seed=1).xi.device.type == "cuda"
        return
    for build in (lambda: pt.GraphPercStep(15, 7, seed=1),
                  lambda: pt.GraphPercLinear(15, 7, seed=1),
                  lambda: pt.GraphPercXEntr(15, 7, 1.0, seed=1),
                  lambda: pt.GraphQPercStepT(15, 7, 3, 1.0, 1.0, seed=1)):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


def test_shared_patterns_keep_their_own_family():
    """A PercStep and a PercLinear sharing one xi tensor get their own
    families and their own dE on the kernel route (the JAX package caches
    the family on id(xi))."""
    s = pt.GraphPercStep(15, 7, seed=8, **CPU)
    lin = pt.GraphPercLinear(15, 7, xi=s.xi.numpy(), **CPU)
    lin = Perceptron(xi=s.xi, loss_table=lin.loss_table, N=15, P=7,
                     scale=lin.scale)
    assert perc_family(s) == "step" and perc_family(lin) == "linear"
    st = pt.init_state(s, 8, seed=2, **CPU)
    R1 = pt.extremal_opt(s, 1.4, 50, state=st, **CPU)
    R2 = pt.extremal_opt(lin, 1.4, 50, state=pt.rebind(lin, st), **CPU)
    for X, R in ((s, R1), (lin, R2)):
        err = (X.to_physical(X.energy(R.sigma)) - R.E).abs().max()
        assert float(err) < 1e-5
    assert not torch.equal(s.delta_all(st.sigma, st.aux),
                           lin.delta_all(st.sigma, st.aux))


def test_even_n_is_refused():
    """An even-N Perceptron with a step table is not eligible for the
    kernels (its stabilities can be 0, where the elementwise g is wrong):
    extremal_opt(backend="auto") and bklMC take the torch route on it, and
    bklMC(backend="kernel") raises."""
    N, P = 16, 7
    d = np.arange(-N, N + 1, 2)
    m = Perceptron(xi=torch.from_numpy(gen_xi(N, P,
                                              np.random.default_rng(1))),
                   loss_table=torch.from_numpy((d < 0).astype(np.int32)),
                   N=N, P=P)
    assert perc_family(m) == "step" and not perc_rejfree_ok(m)
    assert family_of(m) is None and eo_kernel_route(m) is None
    R = pt.extremal_opt(m, 1.4, 100, chains=8, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch"
    assert torch.equal(m.energy(R.sigma).to(torch.float32), R.E)
    with pytest.raises(ValueError, match="odd"):
        pt.GraphPercStep(16, 7, seed=1, **CPU)
    Es, st = pt.bklMC(m, 1.0, 100, step=10, chains=8, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch"
    assert torch.equal(m.energy(st.sigma), st.E)
    with pytest.raises(NotImplementedError, match="not eligible"):
        pt.bklMC(m, 1.0, 100, chains=8, backend="kernel", **CPU)
