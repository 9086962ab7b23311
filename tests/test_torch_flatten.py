"""The port's `flatten` (rrrmc_tpu_torch/models/flatten.py) against the JAX
package's on the CPU: the merged tables of Quant, LE, AddFields,
AddSubFields and Mixed stacks, the three refusals with the JAX messages, the
flat model's energies and flip costs against the wrapper's, its routes onto
the site, sparse race and sparse EO kernels (their plain versions here), and
bklMC on flatten(LE) against exact enumeration.

Tolerances: neighbour tables EQUAL; the float32 couplings, fields and
offset within 1e-6 relative of the JAX package's float64 (one float32
rounding); energies and flip costs of the flat model within 1e-5 relative
of the wrapper's physical values, plus 1e-5 absolute."""

import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu.models.flatten import flatten as jax_flatten

from torch_port_helpers import CPU, port_composite, port_model, random_sigma

torch.set_num_threads(1)

B = 6


def _h(n):
    return np.linspace(-0.5, 0.5, n)


#: (JAX wrapper, the port's over the same base tables)
STACKS = {
    "Quant EA": lambda: rt.GraphQuant(16, 4, 0.5, 2.0,
                                      rt.GraphEA(4, 2, (-1, 1), seed=3)),
    "LE RRG": lambda: rt.GraphLocalEntropy(16, 3, 0.4, 1.5, rt.GraphRRG(
        16, 3, (-1, 1), seed=5)),
    "LE RRG M=8": lambda: rt.GraphLocalEntropy(
        12, 8, 1.0, 1.0, rt.GraphRRG(12, 3, (-1, 1), seed=13)),
    "AddFields EA": lambda: rt.GraphAddFields(_h(16), rt.GraphEA(
        4, 2, (-1, 1), seed=7)),
    "AddSubFields EA": lambda: rt.GraphAddSubFields(_h(16), rt.GraphEA(
        4, 2, (-1, 1), seed=7)),
    "Mixed": lambda: rt.mixed(rt.GraphEA(4, 2, (-1, 1), seed=7),
                              rt.GraphIsing1D(16)),
}


def _port(jm):
    """The port's stack over the JAX model's exact base tables."""
    if isinstance(jm, rt.Mixed):
        return pt.mixed(*(port_model(p) for p in jm.parts))
    if isinstance(jm, (rt.QuantModel, rt.REModel)):
        return port_composite(jm)
    if isinstance(jm, rt.LEModel):
        return pt.replica_from_arrays("le", port_model(jm.resid_m.base),
                                      M=jm.M, coupling=jm.inner_m.scale,
                                      beta=1.0)
    base = jm.resid_m.parts[0] if isinstance(jm.resid_m, rt.Mixed) \
        else jm.resid_m
    kind = "addsub" if isinstance(jm.resid_m, rt.Mixed) else "af"
    return pt.replica_from_arrays(kind, port_model(base),
                                  fields=-np.asarray(jm.inner_m.h))


@pytest.mark.parametrize("name", list(STACKS))
def test_flatten_tables_match_jax(name):
    """flatten's padded neigh table equals the JAX package's (the merge
    keeps its insertion order); J, h and offset agree to one float32
    rounding; the flat model is float32 at scale 1 on the wrapper's
    device."""
    jm = STACKS[name]()
    jf = jax_flatten(jm)
    pf = pt.flatten(_port(jm))
    assert isinstance(pf, pt.Pairwise)
    assert (pf.N, pf.K, pf.scale) == (jf.N, jf.K, 1.0)
    assert pf.J.dtype == torch.float32 and pf.J.device.type == "cpu"
    np.testing.assert_array_equal(pf.neigh.numpy(), np.asarray(jf.neigh))
    for key in ("J", "h", "offset"):
        np.testing.assert_allclose(getattr(pf, key).numpy(),
                                   np.asarray(getattr(jf, key)), rtol=1e-6,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("name", list(STACKS))
def test_flatten_reproduces_the_wrapper(name):
    """The flat model's energies and flip costs equal the wrapper's
    physical ones."""
    pm = _port(STACKS[name]())
    pf = pt.flatten(pm)
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(2), B,
                                          pm.N))
    e_w, e_f = pm.to_physical(pm.energy(sigma)), pf.energy(sigma)
    scale = float(e_w.abs().max()) + pm.N
    torch.testing.assert_close(e_f.double(), e_w.double(), rtol=0,
                               atol=1e-5 * scale + 1e-5)
    d_w = pm.to_physical(pm.delta_all(sigma, pm.init_aux(sigma)))
    d_f = pf.delta_all(sigma, pf.init_aux(sigma))
    torch.testing.assert_close(d_f.double(), d_w.double(), rtol=0,
                               atol=1e-5 * scale + 1e-5)


def test_flatten_refusals_match_jax():
    """RE (the log-cosh star), TLE (the 4-spin term) and a base that is not
    Pairwise are refused with the JAX package's messages."""
    jrrg = rt.GraphRRG(8, 3, (-1, 1), seed=1)
    prrg = port_model(jrrg)
    pairs = (
        (rt.GraphRobustEnsemble(8, 3, 0.3, 1.0, jrrg),
         pt.GraphRobustEnsemble(8, 3, 0.3, 1.0, prrg)),
        (rt.GraphTopologicalLocalEntropy(8, 3, 0.3, 0.2, 1.0, jrrg),
         pt.GraphTopologicalLocalEntropy(8, 3, 0.3, 0.2, 1.0, prrg)),
        (rt.GraphLocalEntropy(8, 3, 0.3, 1.0, rt.GraphSK(8, seed=1)),
         pt.GraphLocalEntropy(8, 3, 0.3, 1.0, pt.GraphSK(8, seed=1, **CPU))),
        (rt.GraphSK(8, seed=1), pt.GraphSK(8, seed=1, **CPU)))
    for jm, pm in pairs:
        with pytest.raises(ValueError) as jerr:
            jax_flatten(jm)
        with pytest.raises(ValueError) as perr:
            pt.flatten(pm)
        assert str(perr.value) == str(jerr.value)


def _flat_le(Nk=16, M=4):
    return pt.flatten(pt.GraphLocalEntropy(
        Nk, M, 1.0, 1.0, pt.GraphRRG(Nk, 3, seed=13, **CPU)))


#: (entry point on the flat LE model, route, checkpoints)
ROUTES = {
    "standardMC": (lambda m: pt.standardMC(m, 1.0, 400, step=100, chains=4,
                                           backend="kernel", **CPU),
                   "kernel-site", 4),
    "sweepMC": (lambda m: pt.sweepMC(m, 1.0, 4, step=2, chains=4, **CPU),
                "kernel-site-sweep", 2),
    "bklMC": (lambda m: pt.bklMC(m, 1.0, 2000, step=500, chains=4, **CPU),
              "kernel-rejfree-sparse", 4),
    "wtmMC": (lambda m: pt.wtmMC(m, 1.0, 4, step=50.0, chains=4, **CPU),
              "kernel-rejfree-sparse", 4),
    "rrrMC": (lambda m: pt.rrrMC(m, 1.0, 200, step=50, chains=4, **CPU),
              "kernel-rejfree-sparse", 4),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_flat_le_takes_the_kernel_routes(name):
    """flatten(LE) (a float Pairwise whose centre spins have degree M) runs
    on the site kernel, the site-sweep route and the sparse race kernel
    (their plain versions on the CPU), keeping E == energy(sigma) within
    float32 accumulation."""
    m = _flat_le()
    assert m.K == 4 and m.J.dtype == torch.float32
    call, route, n_ckpt = ROUTES[name]
    Es, st = call(m)
    assert pt.LAST_ROUTE["backend"] == route
    assert pt.LAST_ROUTE["impl"] == "plain"
    assert Es.shape == (4, n_ckpt) and bool(torch.isfinite(Es).all())
    err = float((m.energy(st.sigma).double() - st.E.double()).abs().max())
    assert err <= 1e-4 * m.N


def test_flat_le_extremal_opt():
    """extremal_opt on flatten(LE) takes the sparse EO kernel (plain
    version), float keys with the coarse select; E and Emin equal the
    energies of sigma and sigma_min within float32 accumulation."""
    m = _flat_le(M=8)
    assert m.K == 8
    R = pt.extremal_opt(m, 1.4, 300, chains=4, seed=2, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-eo-sparse"
    for s, e in ((R.sigma, R.E), (R.sigma_min, R.Emin)):
        assert float((m.energy(s) - e).abs().max()) <= 1e-4 * m.N
    assert bool((R.Emin <= R.E).all())


def _boltzmann_mean_energy(pm, beta):
    n = pm.N
    states = ((torch.arange(2 ** n)[:, None] >> torch.arange(n)) & 1)
    E = pm.to_physical(pm.energy((2 * states - 1).to(torch.int8)))
    E = E.double().numpy()
    w = np.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


def test_flat_le_bkl_law():
    """bklMC on flatten(LE over a 3-spin ring, M = 3) (12 spins, the
    sparse race kernel's plain version) samples the WRAPPER's exact
    Boltzmann mean energy, within max(5 SEM, 0.05)."""
    le = pt.GraphLocalEntropy(3, 3, 0.6, 1.5, pt.GraphIsing1D(3, **CPU))
    beta = 1.5
    E_exact = _boltzmann_mean_energy(le, beta)
    flat = pt.flatten(le)
    Es, st = pt.bklMC(flat, beta, 40_000, step=200, chains=64, seed=5,
                      **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-rejfree-sparse"
    Es = Es[:, 50:].double().numpy()
    err = abs(Es.mean() - E_exact)
    sem = Es.std() / np.sqrt(Es.shape[0] * 5.0)
    assert err < max(5 * sem, 0.05), (Es.mean(), E_exact, sem)
