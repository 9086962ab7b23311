"""The port's checkerboard sweep (rrrmc_tpu_torch/ops/sweep.py) against the
JAX Pallas sweep kernel run in interpret mode, on identical couplings, spins
and random bits, on its three code paths (threshold table, field column,
exp); and sweepMC's three routes through the public API, held against exact
enumeration and against the JAX sampler."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import sweep
from rrrmc_tpu_torch.ops.sweep import Sweeper, sweep_chunk

from torch_port_helpers import (CPU, host, pallas_interpret, port_lattice,
                                random_sigma, sweep_bits)

torch.set_num_threads(1)

B = 128
SEED = 17
N_SWEEPS = 40


@pytest.fixture(scope="module")
def sweep_pallas():
    with pallas_interpret("rrrmc_tpu.ops.sweep_pallas") as (sp,):
        yield sp


def _field_lattice(mod):
    """EA-2D L=4 (N=16) with integer fields in -2..2."""
    m = mod.GraphEA(4, 2, (-1, 1), seed=11, **host(mod))
    h = np.random.RandomState(3).randint(-2, 3, size=m.N)
    if mod is rt:
        return dataclasses.replace(m, h=jnp.asarray(h, m.h.dtype))
    return dataclasses.replace(m, h=torch.as_tensor(h, dtype=m.h.dtype))


#: (JAX model, beta, code path): +-J EA-3D on the threshold table
#: (max_half 6), EA-2D with fields on the h column, and fixed-point
#: couplings (scale 1e-5, max_half far above 64) on the exp path
CASES = {
    "table": (lambda: rt.GraphEA(4, 3, (-1, 1), seed=5), 2.0),
    "field": (lambda: _field_lattice(rt), 1.0),
    "exp": (lambda: rt.GraphEA(4, 3, (-1.5, 0.5), seed=6), 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_matches_jax_interpret(sweep_pallas, case):
    """Spins and energies EQUAL after 40 sweeps: the integer arithmetic is
    exact, and on the exp path float32 exp and the threshold rounding agree
    between XLA and torch."""
    build, beta = CASES[case]
    jm = build()
    sigma = random_sigma(np.random.default_rng(3), B, jm.N)
    sig_j = jnp.asarray(sigma)
    E0 = np.asarray(jax.vmap(jm.energy)(sig_j)).astype(np.int32)
    jsw = sweep_pallas.PallasSweeper(jm, beta, block_chains=B)
    sig_o, E_o = jsw(sig_j, jnp.asarray(E0), seed=SEED, n_sweeps=N_SWEEPS)

    pm = port_lattice(jm)
    psw = Sweeper(pm, beta)
    assert psw.table == (case != "exp")
    assert psw.th.shape[0] == jsw.max_half    # 0: the exp path
    np.testing.assert_array_equal(psw.Jp.numpy(), np.asarray(jsw.Jp))
    np.testing.assert_array_equal(psw.Jm.numpy(), np.asarray(jsw.Jm))
    if psw.table:
        np.testing.assert_array_equal(psw.th.numpy(), np.asarray(jsw.th))
    assert psw.Jp.shape[1] == pm.D + (case == "field")
    sig = torch.from_numpy(sigma.copy())
    E = torch.from_numpy(E0.copy())
    psw(sig, E, seed=SEED, n_sweeps=N_SWEEPS,
        bits=sweep_bits(SEED, B, pm.N))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_o))
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_o))
    assert torch.equal(pm.energy(sig), E)
    assert not torch.equal(sig, torch.from_numpy(sigma))


def test_split_runs_equal_one_launch():
    """Sweeps numbered from sweep0 continue one Philox stream: four
    launches of 5 sweeps equal one of 20. Keys follow the global chain id:
    the two halves of a batch, run with chain0, equal the whole batch."""
    pm = pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU)
    psw = Sweeper(pm, 2.0)
    st = pt.init_state(pm, 16, seed=4, **CPU)

    def run(sigma, E, parts, chain0=0):
        sigma, E = sigma.clone(), E.clone()
        done = 0
        for n in parts:
            psw(sigma, E, seed=SEED, n_sweeps=n, sweep0=done, chain0=chain0)
            done += n
        return sigma, E

    whole = run(st.sigma, st.E, [20])
    split = run(st.sigma, st.E, [5, 5, 5, 5])
    lo = run(st.sigma[:8], st.E[:8], [20])
    hi = run(st.sigma[8:], st.E[8:], [20], chain0=8)
    for i in range(2):
        assert torch.equal(whole[i], split[i])
        assert torch.equal(whole[i], torch.cat([lo[i], hi[i]]))
    assert torch.equal(pm.energy(whole[0]), whole[1])


def test_wrapper_checks_arguments():
    pm = pt.GraphEA(4, 2, seed=1, **CPU)
    psw = Sweeper(pm, 1.0)
    st = pt.init_state(pm, 4, seed=2, **CPU)
    kw = dict(L=4, D=2, n_sweeps=1, beta2s=2.0, seed=1)
    with pytest.raises(ValueError, match="E"):
        sweep_chunk(st.sigma, st.E.float(), psw.Jp, psw.Jm, psw.th, **kw)
    with pytest.raises(ValueError, match="L="):
        sweep_chunk(st.sigma, st.E, psw.Jp, psw.Jm, psw.th,
                    **dict(kw, L=3))
    with pytest.raises(ValueError, match="contiguous"):
        sweep_chunk(st.sigma.t().contiguous().t(), st.E, psw.Jp, psw.Jm,
                    psw.th, **kw)
    for bad in (pt.GraphEA(3, 2, seed=1, **CPU),
                pt.GraphEANormal(4, 2, seed=1, **CPU),
                pt.GraphRRG(16, 3, seed=1, **CPU)):
        assert not sweep.sweep_eligible(bad)
        with pytest.raises(ValueError, match="LatticeEA"):
            Sweeper(bad, 1.0)


#: (model builder, backend, expected route) of sweepMC
ROUTES = {
    "lattice-auto": (lambda: pt.GraphEA(4, 3, seed=2, **CPU), "auto",
                     "kernel-sweep"),
    "lattice-kernel": (lambda: _field_lattice(pt), "kernel", "kernel-sweep"),
    "rrg": (lambda: pt.GraphRRG(32, 3, seed=2, **CPU), "auto",
            "kernel-site-sweep"),
    "odd-L": (lambda: pt.GraphEA(3, 2, seed=2, **CPU), "kernel",
              "kernel-site-sweep"),
    "float-lattice": (lambda: pt.GraphEANormal(4, 2, seed=2, **CPU), "auto",
                      "kernel-site-sweep"),
    "EA-L2": (lambda: pt.GraphEA(2, 3, seed=2, **CPU), "auto",
              "kernel-site-sweep"),
    "lattice-torch": (lambda: pt.GraphEA(4, 2, seed=2, **CPU), "torch",
                      "torch"),
    "odd-L-torch": (lambda: pt.GraphEA(3, 2, seed=2, **CPU), "torch", "torch"),
    "small-N": (lambda: pt.GraphThreeSpin(**CPU), "auto", "torch"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_sweepmc_routes(name):
    """Each route names itself in LAST_ROUTE, keeps the running energy equal
    to energy(sigma) (exact for integer couplings) and returns one physical
    energy per checkpoint; only the site-sweep route counts accepted
    flips, as in the JAX package."""
    build, backend, route = ROUTES[name]
    m = build()
    Es, st = pt.sweepMC(m, 1.0, 7, step=3, chains=16, seed=3,
                        backend=backend, **CPU)
    assert pt.LAST_ROUTE["backend"] == route
    assert pt.LAST_ROUTE["impl"] == ("torch" if route == "torch"
                                     else "plain")
    assert Es.shape == (16, 2) and Es.dtype == torch.float32
    assert torch.equal(Es[:, -1], m.to_physical(st.E))
    if m.J.dtype.is_floating_point:
        err = (m.energy(st.sigma).double() - st.E.double()).abs().max()
        assert float(err) < 1e-5 * m.N
        torch.testing.assert_close(st.aux, m.local_fields(st.sigma),
                                   rtol=0, atol=1e-5)
    else:
        assert torch.equal(m.energy(st.sigma), st.E)
        assert torch.equal(st.aux, m.local_fields(st.sigma))
    if route == "kernel-site-sweep":
        assert torch.equal(st.accepted, pt.LAST_ROUTE["acc"])
        assert int(st.accepted.min()) > 0
    else:
        assert int(st.accepted.abs().max()) == 0


def test_sweepmc_reuses_sweeper():
    """Route (a) builds one Sweeper per (couplings, fields, scale, beta):
    a second call and a continuation reuse it; a field variant sharing Jd,
    or another beta, gets its own."""
    from rrrmc_tpu_torch.samplers import common, sweep as sweep_sampler

    m = pt.GraphEA(4, 2, seed=4, **CPU)
    _, st = pt.sweepMC(m, 1.0, 2, chains=4, seed=1, **CPU)
    first = sweep_sampler._sweeper(m, 1.0)
    _, st = pt.sweepMC(m, 1.0, 2, state=st, **CPU)
    assert sweep_sampler._sweeper(m, 1.0) is first
    assert torch.equal(m.energy(st.sigma), st.E)
    field = _field_lattice(pt)
    base = pt.GraphEA(4, 2, seed=11, **CPU)
    assert sweep_sampler._sweeper(base, 1.0).Jp.shape[1] == 2
    assert sweep_sampler._sweeper(
        dataclasses.replace(base, h=field.h), 1.0).Jp.shape[1] == 3
    assert sweep_sampler._sweeper(m, 2.0) is not first
    assert len(sweep_sampler._SWEEPERS) <= common._CACHE_MAX


def test_sweepmc_rejects():
    with pytest.raises(NotImplementedError, match="N >= 8"):
        pt.sweepMC(pt.GraphThreeSpin(**CPU), 1.0, 2, backend="kernel", **CPU)
    with pytest.raises(ValueError, match="backend"):
        pt.sweepMC(pt.GraphEA(4, 2, **CPU), 1.0, 2, backend="pallas", **CPU)
    with pytest.raises(NotImplementedError, match="item 10"):
        pt.sweepMC(object(), 1.0, 2, **CPU)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_sweepmc_samples_boltzmann(backend):
    """EA-2D L=4 with integer fields: the checkerboard kernel route and the
    torch colour-mask route reach the exact 2^16 Boltzmann mean energy
    (the port's analysis.truep) within max(5 sigma, 0.05), sigma the
    standard error of the chain means."""
    m = _field_lattice(pt)
    beta = 1.0
    Es, _ = pt.sweepMC(m, beta, 240, step=2, chains=256, seed=7,
                       backend=backend, **CPU)
    assert pt.LAST_ROUTE["backend"] == ("kernel-sweep" if backend == "kernel"
                                        else "torch")
    Es = Es.double().numpy()[:, Es.shape[1] // 4:]
    got = Es.mean()
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    want = float((pt.analysis.truep(m, beta)
                  * pt.analysis.energy_table(m)).sum())
    assert abs(got - want) < max(5 * sem, 0.05), (got, want, sem)


def test_sweepmc_matches_jax_xla():
    """EA-3D L=4 +-J at beta=2 from the same starting spins: after 60
    sweeps the port's kernel route and the JAX colour-mask route
    (backend="xla") give E/N within max(5 sigma, 0.02)."""
    jm = rt.GraphEA(4, 3, (-1, 1), seed=5)
    pm = port_lattice(jm)
    C0 = random_sigma(np.random.default_rng(6), 128, jm.N)
    Ej, _ = rt.sweepMC(jm, 2.0, sweeps=60, step=6, chains=64, seed=2,
                       C0=C0[:64], backend="xla")
    Ep, st = pt.sweepMC(pm, 2.0, 60, step=6, chains=128, seed=2, C0=C0, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-sweep"

    def tail(Es):
        e = np.asarray(Es, np.float64)[:, 5:].mean(axis=1) / jm.N
        return e.mean(), e.std() / np.sqrt(len(e))

    (a, sa), (b, sb) = tail(Ep.numpy()), tail(Ej)
    assert abs(a - b) < max(5 * np.hypot(sa, sb), 0.02), (a, b)
