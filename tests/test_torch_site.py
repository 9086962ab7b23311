"""The port's single-site Metropolis (rrrmc_tpu_torch/ops/site.py) against the
JAX Pallas site kernel run in interpret mode, on identical tables, spins,
site schedule and random bits; and the port's kernel route through
standardMC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops.site import SiteSampler, site_chunk

from torch_port_helpers import (CPU, pallas_interpret, port_model,
                                random_sigma, site_bits)

torch.set_num_threads(1)

B = 128
N_MOVES = 200


@pytest.fixture(scope="module")
def site_pallas():
    with pallas_interpret("rrrmc_tpu.ops.site_pallas") as (sp,):
        yield sp


@pytest.mark.parametrize("coupling", ["pm_j", "normal"])
def test_site_chunk_matches_jax_interpret(site_pallas, coupling):
    """Integer couplings: sigma, lf, E and acc EQUAL. Float couplings: E and
    lf within 1e-4, sigma and acc equal on all chains but at most 1 in 128
    (an f32 rounding difference between XLA's and torch's exp can flip a
    borderline acceptance)."""
    from rrrmc_tpu.samplers.common import init_lfT

    jm = (rt.GraphRRG(64, 3, (-1, 1), seed=2) if coupling == "pm_j"
          else rt.GraphRRGNormal(64, 3, seed=1))
    flt = coupling == "normal"
    beta, seed = 1.5, 11
    rng = np.random.default_rng(5)
    sigma = random_sigma(rng, B, jm.N)
    sites = rng.integers(0, jm.N, N_MOVES).astype(np.int32)

    sig_j = jnp.asarray(sigma)
    lfT0 = np.asarray(init_lfT(jm, sig_j))
    E0 = np.asarray(jax.vmap(jm.energy)(sig_j))
    jd = jnp.float32 if flt else jnp.int32
    sig_o, E_o, lf_o, acc_o = site_pallas._pallas_site(
        sig_j, jnp.asarray(lfT0), jnp.asarray(E0), jnp.zeros(B, jnp.int32),
        jnp.asarray(sites), jm.neigh.reshape(-1).astype(jnp.int32),
        jm.J.reshape(-1).astype(jd), jnp.asarray([seed], jnp.int32),
        jnp.asarray([N_MOVES], jnp.int32),
        jnp.asarray([beta * jm.scale], jnp.float32), K=jm.K, block_chains=B)

    pm = port_model(jm)
    et = np.float32 if flt else np.int32
    sigT = torch.from_numpy(sigma.T.copy())
    lfT = torch.from_numpy(lfT0.copy())
    E = torch.from_numpy(E0.astype(et))
    acc = torch.zeros(B, dtype=torch.int32)
    site_chunk(sigT, lfT, E, acc, torch.from_numpy(sites), pm.neigh, pm.J,
               seed=seed, beta_s=beta * pm.scale, bits=site_bits(seed, B))

    sig_j, lf_j = np.asarray(sig_o), np.asarray(lf_o)
    acc_j = np.asarray(acc_o)
    if not flt:
        np.testing.assert_array_equal(sigT.numpy().T, sig_j)
        np.testing.assert_array_equal(lfT.numpy(), lf_j)
        np.testing.assert_array_equal(E.numpy(), np.asarray(E_o))
        np.testing.assert_array_equal(acc.numpy(), acc_j)
        assert acc_j.min() > 0
        return
    same = (sigT.numpy().T == sig_j).all(axis=1) & (acc.numpy() == acc_j)
    assert (~same).sum() <= 1, (~same).sum()
    dE_j = np.asarray(E_o, np.float64) - E0
    dE_p = E.numpy().astype(np.float64) - E0.astype(np.float32)
    np.testing.assert_allclose(dE_p[same], dE_j[same], atol=1e-4)
    np.testing.assert_allclose(lfT.numpy()[:, same], lf_j[:, same],
                               atol=1e-4)


def test_standardmc_kernel_route_cpu():
    """standardMC(backend="kernel") on CPU runs the plain site kernel:
    exact running energy, shapes, accepted counts in range."""
    m = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    Es, st = pt.standardMC(m, 1.5, 3000, step=1000, chains=B, seed=9,
                           backend="kernel", **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-site"
    assert pt.LAST_ROUTE["impl"] == "plain"
    assert Es.shape == (B, 3) and Es.dtype == torch.float32
    assert torch.equal(m.energy(st.sigma), st.E)
    assert torch.equal(m.local_fields(st.sigma), st.aux)
    a = st.accepted
    assert int(a.min()) >= 0 and int(a.max()) <= 3000 and float(
        a.double().mean()) > 0
    # the last checkpoint is the final state's energy
    assert torch.equal(Es[:, -1], st.E.to(torch.float32))


def test_standardmc_kernel_float_couplings():
    m = pt.GraphRRGNormal(64, 3, seed=1, **CPU)
    Es, st = pt.standardMC(m, 1.5, 3000, step=1000, chains=B, seed=9,
                           backend="kernel", **CPU)
    err = (m.energy(st.sigma).double() - st.E.double()).abs().max()
    assert float(err) < 2e-3
    assert int(st.accepted.min()) > 0


def test_sweep_schedule_covers_every_site():
    """beta = 0: every proposal accepts (up to a ~2^-25 bit edge), so ONE
    sweep of the permutation schedule flips EVERY spin exactly once."""
    m = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    st = pt.init_state(m, B, seed=1, **CPU)
    sigT = st.sigma.t().contiguous()
    lfT = m.local_fields(st.sigma).t().contiguous()
    E, acc = st.E.clone(), torch.zeros(B, dtype=torch.int32)
    ps = SiteSampler(m, 0.0)
    # one sweep split over two calls: the permutation phase carries over
    ps(sigT, lfT, E, acc, generator=st.generator, seed=3, n_moves=40,
       sweep_schedule=True)
    ps(sigT, lfT, E, acc, generator=st.generator, seed=3, n_moves=24,
       move0=40, sweep_schedule=True)
    assert torch.equal(sigT.t(), -st.sigma)
    assert torch.equal(E, m.energy(sigT.t().contiguous()))
    assert torch.equal(acc, torch.full((B,), 64, dtype=torch.int32))
