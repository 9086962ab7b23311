"""The port's PSpin3 (rrrmc_tpu_torch/models/pspin.py) against the JAX
package's, and its samplers through the public API: the same seed gives the
same partner table; on the same spins energies, cavity sums, delta_all,
delta_one and masked flips agree bit for bit (exact int32); bklMC, wtmMC and
rrrMC take the PSpin3 race route, extremal_opt the PSpin3 EO route, whose
moves equal the generic torch route's, and the race samples the Boltzmann
law on a 12-spin instance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops.eo_pspin import eo_pspin_chunk
from rrrmc_tpu_torch.ops.pspin import rejfree_pspin_chunk
from rrrmc_tpu_torch.samplers.eo import eo_kernel_route, rank_table

from torch_port_helpers import CPU, port_pspin, random_sigma

torch.set_num_threads(1)

B = 16
#: (N, K, seed) of the instances both packages build
CASES = [(12, 3, 1), (12, 4, 1), (48, 3, 3), (30, 4, 5)]
KEYS = ("sigma", "E", "Emin", "sigma_min", "itmin")


def _pair(N, K, seed):
    return rt.GraphPSpin3(N, K, seed=seed), pt.GraphPSpin3(N, K, seed=seed,
                                                           **CPU)


@pytest.mark.parametrize("case", CASES)
def test_same_seed_same_table(case):
    jm, pm = _pair(*case)
    assert (pm.N, pm.K, pm.scale) == (jm.N, jm.K, jm.scale)
    assert pm.A.dtype == torch.int32
    np.testing.assert_array_equal(pm.A.numpy(), np.asarray(jm.A))
    assert pm.delta_classes() == jm.delta_classes()
    assert torch.equal(port_pspin(jm).A, pm.A)


@pytest.mark.parametrize("case", CASES)
def test_energy_cavity_delta(case):
    jm, pm = _pair(*case)
    sigma = random_sigma(np.random.default_rng(1), B, jm.N)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma)
    E_j = np.asarray(jax.vmap(jm.energy)(sj))
    c_j = np.asarray(jax.vmap(jm._cavity)(sj))
    d_j = np.asarray(jax.vmap(lambda s: jm.delta_all(s, ()))(sj))
    c_p = pm.init_aux(sp)
    for got, want in ((pm.energy(sp), E_j), (c_p, c_j),
                      (pm.delta_all(sp, c_p), d_j)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    i = np.random.default_rng(2).integers(0, jm.N, B)
    one_j = np.asarray(jax.vmap(lambda s, k: jm.delta_one(s, (), k))(
        sj, jnp.asarray(i)))
    np.testing.assert_array_equal(
        pm.delta_one(sp, c_p, torch.from_numpy(i)).numpy(), one_j)


@pytest.mark.parametrize("case", CASES[:2])
def test_masked_flips(case):
    """Masked flips (do = False leaves a chain untouched) keep sigma equal to
    the JAX model's and the cavity sums equal to a fresh init_aux."""
    jm, pm = _pair(*case)
    rng = np.random.default_rng(3)
    sigma = random_sigma(rng, B, jm.N)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma.copy())
    cp = pm.init_aux(sp)
    flip = jax.jit(jax.vmap(lambda s, i, d: jm.flip(s, (), i, d)[0]))
    for _ in range(30):
        i = rng.integers(0, jm.N, B)
        do = rng.random(B) < 0.7
        sj = flip(sj, jnp.asarray(i), jnp.asarray(do))
        pm.flip(sp, cp, torch.from_numpy(i), torch.from_numpy(do))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    assert torch.equal(cp, pm.init_aux(sp))


@pytest.mark.parametrize("sampler", ["bkl", "wtm", "rrr", "standard"])
def test_samplers_route_and_exact_energy(sampler):
    """The race samplers take the PSpin3 race kernel's plain version, and
    standardMC its generic torch route, unchanged; the running energy and
    the resident cavity sums stay exact."""
    m = pt.GraphPSpin3(30, 3, seed=2, **CPU)
    kw = dict(chains=8, seed=1, **CPU)
    run = {"bkl": lambda: pt.bklMC(m, 1.5, 3000, step=300, **kw),
           "wtm": lambda: pt.wtmMC(m, 1.5, 10, step=30.0, **kw),
           "rrr": lambda: pt.rrrMC(m, 1.0, 1280, step=128, **kw),
           "standard": lambda: pt.standardMC(m, 1.5, 2000, step=200, **kw)}
    Es, st = run[sampler]()
    route = "torch" if sampler == "standard" else "kernel-rejfree-pspin"
    assert pt.LAST_ROUTE["backend"] == route
    assert Es.shape == (8, 10) and bool(torch.isfinite(Es).all())
    assert torch.equal(m.energy(st.sigma), st.E)
    assert torch.equal(m.init_aux(st.sigma), st.aux)
    assert int(st.accepted.min()) > 0


def test_extremal_opt_kernel_route_equals_torch_route():
    """The PSpin3 EO kernel's plain version and the generic route on
    model.delta_all / model.flip make the same moves from the same Philox
    streams."""
    m = pt.GraphPSpin3(48, 3, seed=3, **CPU)
    assert eo_kernel_route(m) == "pspin"
    k = pt.extremal_opt(m, 1.4, 200, chains=16, seed=3, **CPU)
    assert pt.LAST_ROUTE == {"backend": "kernel-eo-pspin", "impl": "plain"}
    t = pt.extremal_opt(m, 1.4, 200, chains=16, seed=3, backend="torch",
                        **CPU)
    assert pt.LAST_ROUTE == {"backend": "torch", "impl": "plain"}
    for key in KEYS:
        assert torch.equal(getattr(k, key), getattr(t, key)), key
    assert torch.equal(m.to_physical(m.energy(k.sigma_min)), k.Emin)
    assert torch.equal(m.to_physical(m.energy(k.sigma)), k.E)
    assert int(k.itmin.max()) > 0


def test_eligibility():
    """N < 9 stays off the kernels (the JAX rule): the race samplers raise,
    extremal_opt takes the generic route unless the kernel is asked for."""
    m = pt.GraphPSpin3(6, 2, seed=1, **CPU)
    with pytest.raises(NotImplementedError, match="PSpin3"):
        pt.bklMC(m, 1.0, 100, **CPU)
    with pytest.raises(NotImplementedError):
        pt.extremal_opt(m, 1.4, 10, backend="kernel", **CPU)
    pt.extremal_opt(m, 1.4, 10, chains=2, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch"
    with pytest.raises(ValueError, match="divisible"):
        pt.GraphPSpin3(10, 3, **CPU)


DEFAULT_BUILDERS = {
    "GraphPSpin3": lambda: pt.GraphPSpin3(12, 3, seed=1),
    "pspin_from_arrays": lambda: pt.pspin_from_arrays(
        pt.GraphPSpin3(12, 3, seed=1, **CPU).A.numpy(), 12, 3),
}


@pytest.mark.parametrize("name", list(DEFAULT_BUILDERS))
def test_builders_default_to_the_card(name):
    """Without `device` the builders place the table on CUDA: on a machine
    without a card that raises torch's own error, never a quiet CPU
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
    sigma, c, E = st[:3]
    B = sigma.shape[0]
    coord = torch.zeros(B, dtype=torch.int32) if move0 == 0 else st[3]
    acc = torch.zeros(B, dtype=torch.int32) if move0 == 0 else st[4]
    zacc = torch.zeros(B, dtype=torch.float32) if move0 == 0 else st[5]
    cs, es = rejfree_pspin_chunk(sigma, c, E, coord, acc, zacc, m.A,
                                 mode="bkl", n_moves=n, beta_s=1.0,
                                 target=2 ** 30, seed=7, move0=move0,
                                 chain0=chain0)
    return (sigma, c, E, coord, acc, zacc), cs, es


def test_split_launches_and_batch_layout():
    """Moves are counted across launches (move0) and the Philox keys on the
    global chain id (chain0): 15 + 25 race moves equal 40, 20 + 30 EO moves
    equal 50, and two halves of a batch equal the whole."""
    m = pt.GraphPSpin3(30, 3, seed=2, **CPU)
    one, cs, es = _race(m, _chunk_state(m, 8), 40, 0)
    two, cs1, es1 = _race(m, _chunk_state(m, 8), 15, 0)
    two, cs2, es2 = _race(m, two, 25, 15)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(cs, torch.cat([cs1, cs2])) and torch.equal(
        es, torch.cat([es1, es2]))
    lo, _, _ = _race(m, tuple(t[:4] for t in _chunk_state(m, 8)), 40, 0)
    hi, _, _ = _race(m, tuple(t[4:] for t in _chunk_state(m, 8)), 40, 0,
                     chain0=4)
    assert all(torch.equal(a, torch.cat([b, c]))
               for a, b, c in zip(one, lo, hi))
    cdf = rank_table(m.N, 1.4, "cpu")
    runs = []
    for parts in ((50,), (20, 30)):
        sigma, c, E = _chunk_state(m, 8)
        st = [sigma, c, E, E.clone(), sigma.clone(),
              torch.zeros(8, dtype=torch.int32)]
        move0 = 0
        for n in parts:
            eo_pspin_chunk(*st, m.A, cdf, n_moves=n, seed=5, move0=move0)
            move0 += n
        runs.append(st)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert int(runs[0][5].max()) > 20


def test_wrappers_check_arguments():
    m = pt.GraphPSpin3(12, 3, seed=1, **CPU)
    sigma, c, E = _chunk_state(m, 4)
    z = (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
         torch.zeros(4, dtype=torch.float32))
    kw = dict(mode="bkl", n_moves=2, beta_s=1.0, target=10, seed=1)
    with pytest.raises(ValueError, match="c:"):
        rejfree_pspin_chunk(sigma, c.float(), E, *z, m.A, **kw)
    with pytest.raises(ValueError, match="A:"):
        rejfree_pspin_chunk(sigma, c, E, *z, m.A.long(), **kw)
    with pytest.raises(ValueError, match="mode"):
        rejfree_pspin_chunk(sigma, c, E, *z, m.A, **{**kw, "mode": "x"})
    meta = [t.to("meta") for t in (sigma, c, E, *z, m.A)]
    with pytest.raises(ValueError, match="no race kernel"):
        rejfree_pspin_chunk(*meta, **kw)
    st = [sigma, c, E, E.clone(), sigma.clone(), z[0]]
    with pytest.raises(ValueError, match="cdf"):
        eo_pspin_chunk(*st, m.A, rank_table(m.N - 1, 1.4, "cpu"), n_moves=2,
                       seed=1)


def _boltzmann_mean(model, beta):
    """Exact <E> (physical) by enumerating all 2^N configurations."""
    n = model.N
    idx = torch.arange(2 ** n)
    sigma = (((idx[:, None] >> torch.arange(n)) & 1) * 2 - 1).to(torch.int8)
    E = model.to_physical(model.energy(sigma)).double()
    w = torch.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


BOLTZMANN = {
    "bkl": lambda m: pt.bklMC(m, 1.0, 6000, step=20, chains=128, seed=2,
                              **CPU),
    "wtm": lambda m: pt.wtmMC(m, 1.0, 300, step=20.0, chains=128, seed=2,
                              **CPU),
    "rrr": lambda m: pt.rrrMC(m, 1.0, 1536, step=8, chains=128, seed=2,
                              **CPU),
}


@pytest.mark.parametrize("mode", [
    "bkl", pytest.param("wtm", marks=pytest.mark.slow),
    pytest.param("rrr", marks=pytest.mark.slow)])
def test_race_samples_boltzmann(mode):
    """On a 12-spin PSpin3 the checkpoint-series mean matches the exact
    Boltzmann mean within max(5 sigma, 0.05): bkl and wtm weight states by
    their holding times, so this checks the skip and the clock too."""
    m = pt.GraphPSpin3(12, 3, seed=1, **CPU)
    Es, _ = BOLTZMANN[mode](m)
    Es = Es.double().numpy()[:, Es.shape[1] // 4:]
    got = Es.mean()
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    want = _boltzmann_mean(m, 1.0)
    assert abs(got - want) < max(5 * sem, 0.05), (got, want, sem)
