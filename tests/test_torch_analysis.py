"""The port's observables and exact-enumeration analysis
(rrrmc_tpu_torch/{observables,analysis}.py) against the JAX package's, on
the same small models and spins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu import analysis as ja, observables as jo
from rrrmc_tpu_torch import analysis as pa, observables as po

from torch_port_helpers import CPU, host, random_sigma

torch.set_num_threads(1)

#: small models, built on both sides from the same arguments and seed
MODELS = {
    "RRG": lambda m: m.GraphRRG(8, 3, (-1, 1), seed=2, **host(m)),
    "RRG_frac": lambda m: m.GraphRRG(8, 3, (-1.0, -0.5, 0.5, 1.0), seed=4,
                                     **host(m)),
    "EA2D_L3": lambda m: m.GraphEA(3, 2, (-1, 1), seed=5, **host(m)),
    "Ising1D": lambda m: m.GraphIsing1D(9, **host(m)),
}


def test_observables_match_jax():
    rng = np.random.default_rng(1)
    s1, s2 = random_sigma(rng, 6, 20), random_sigma(rng, 6, 20)
    t1, t2 = torch.from_numpy(s1), torch.from_numpy(s2)
    j1, j2 = jnp.asarray(s1), jnp.asarray(s2)
    np.testing.assert_array_equal(po.magnetization(t1).numpy(),
                                  np.asarray(jo.magnetization(j1)))
    np.testing.assert_allclose(po.overlap(t1, t2).numpy(),
                               np.asarray(jo.overlap(j1, j2)), rtol=1e-7)
    ids = po.pack_config(t1)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jo.pack_config(j1)))
    back = po.unpack_config(ids, 20)
    assert back.dtype == torch.int8 and torch.equal(back, t1)
    all_ids = torch.arange(1 << 10)
    np.testing.assert_array_equal(
        po.unpack_config(all_ids, 10).numpy(),
        np.asarray(jo.unpack_config(jnp.arange(1 << 10), 10)))


@pytest.mark.parametrize("name", list(MODELS))
def test_exact_enumeration_matches_jax(name):
    """Energy table, Boltzmann law and the three transition matrices equal
    the JAX ones (the port's physical energies are float32: within 1e-6
    for the fixed-point levels, exact otherwise), and both kernels are
    stationary."""
    jm, pm = MODELS[name](rt), MODELS[name](pt)
    beta = 1.3
    np.testing.assert_allclose(pa.energy_table(pm), ja.energy_table(jm),
                               rtol=0, atol=1e-6)
    p = pa.truep(pm, beta)
    np.testing.assert_allclose(p, ja.truep(jm, beta), rtol=1e-9, atol=1e-15)
    Q = pa.transition_matrix_standard(pm, beta)
    np.testing.assert_allclose(Q, ja.transition_matrix_standard(jm, beta),
                               atol=1e-12)
    np.testing.assert_allclose(pa.transition_matrix_bkl(Q),
                               ja.transition_matrix_bkl(Q), atol=0)
    Qr = pa.transition_matrix_rrr(pm, beta)
    np.testing.assert_allclose(Qr, ja.transition_matrix_rrr(jm, beta),
                               atol=1e-12)
    assert pa.stationarity_error(Q, p) < 1e-12
    assert pa.stationarity_error(Qr, p) < 1e-12
    assert pa.rejection_rate(Q, p) == pytest.approx(ja.rejection_rate(Q, p))
    assert pa.second_eigenvalue(Qr) == pytest.approx(
        ja.second_eigenvalue(Qr), rel=1e-12)


def test_spectral_stats_and_running_means():
    def build(mod):
        return lambda seed: mod.GraphRRG(6, 3, (-1, 1), seed=seed,
                                            **host(mod))

    taus, rrs = pa.spectral_stats(build(pt), [0.5, 1.5], n_seeds=2)
    taus_j, rrs_j = ja.spectral_stats(build(rt), [0.5, 1.5], n_seeds=2)
    np.testing.assert_allclose(taus, taus_j, rtol=1e-9)
    np.testing.assert_allclose(rrs, rrs_j, rtol=1e-9, atol=1e-15)
    Es = np.random.default_rng(2).normal(size=1000)
    np.testing.assert_array_equal(pa.tm(Es, step=10), ja.tm(Es, step=10))
    np.testing.assert_array_equal(pa.ravg(Es, step=50, skip0=0.1),
                                  ja.ravg(Es, step=50, skip0=0.1))
    with pytest.raises(ValueError, match="too large"):
        pa.energy_table(pt.GraphRRG(30, 3, seed=1, **CPU))
