"""The port's committee machines (rrrmc_tpu_torch/models/committee.py)
against the JAX package's on the CPU: the patterns, labels and unit weights
each builder draws from a seed, bit for bit; energy, Delta1 (the aux),
delta_all, delta_one and flip, bit for bit, for step, ReLU and quadratic
units, tree and fully connected; the twelve replica aliases' tables; the
converter; the builders' odd / even refusals; and the samplers: the exact
int32 energy invariant of standardMC, rrrMC and bklMC (the generic paths),
EO learning a small instance, and bklMC's law against exact enumeration at
9 spins.

Tolerances: every committee value is an exact integer, held EQUAL; the
replica aliases' physical float32 energies against the JAX package's x64
within 1e-5 relative to their energy scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.samplers.families import family_of

from torch_port_helpers import CPU, random_sigma

torch.set_num_threads(1)

B = 6

#: (JAX builder, port builder): the JAX test zoo's shapes and seeds
ZOO = {
    "CommStep": ("GraphCommStep", (3, 3, 6), dict(seed=1)),
    "CommStep-fc": ("GraphCommStep", (5, 3, 6), dict(fc=True, seed=2)),
    "CommReLU": ("GraphCommReLU", (4, 2, 6), dict(seed=3)),
    "CommReLU-fc": ("GraphCommReLU", (4, 4, 6), dict(fc=True, seed=4)),
    "CommQu": ("GraphCommQu", (4, 2, 6), dict(seed=5)),
    "CommQu-fc": ("GraphCommQu", (4, 4, 6), dict(fc=True, seed=6)),
    "CommStep wide": ("GraphCommStep", (7, 5, 40), dict(seed=7)),
    "CommQu wide": ("GraphCommQu", (6, 4, 40), dict(seed=8)),
}


def _pair(name):
    fn, args, kw = ZOO[name]
    return getattr(rt, fn)(*args, **kw), getattr(pt, fn)(*args, **kw, **CPU)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", list(ZOO))
def test_builders_draw_the_same_tables(name):
    """xi, y and c from one seed equal the JAX package's (numpy's
    default_rng draws), and the converter rebuilds the same model."""
    jm, pm = _pair(name)
    assert (pm.N, pm.K1, pm.K2, pm.P, pm.kind) == (jm.N, jm.K1, jm.K2, jm.P,
                                                   jm.kind)
    for key in ("xi", "y", "c"):
        a = getattr(pm, key)
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), _np(getattr(jm, key)))
    cm = pt.committee_from_arrays(_np(jm.xi), _np(jm.y), _np(jm.c), jm.K1,
                                  jm.K2, jm.kind, **CPU)
    for key in ("xi", "y", "c"):
        assert torch.equal(getattr(cm, key), getattr(pm, key))


@pytest.mark.parametrize("name", list(ZOO))
def test_methods_match_jax(name):
    """energy, init_aux, delta_all, delta_one and flip (two chains masked)
    on B random configurations, bit for bit; delta_all equals the
    brute-force energy differences; after 40 random flips aux equals
    init_aux."""
    jm, pm = _pair(name)
    rng = np.random.default_rng(11)
    sigma = random_sigma(rng, B, jm.N)
    i = rng.integers(0, jm.N, B)
    do = np.array([True, False, True, True, False, True])

    @jax.jit
    def run(s, ji, jdo):
        aux = jax.vmap(jm.init_aux)(s)
        s2, aux2 = jax.vmap(jm.flip)(s, aux, ji, jdo)
        return (jax.vmap(jm.energy)(s), aux, jax.vmap(jm.delta_all)(s, aux),
                jax.vmap(jm.delta_one)(s, aux, ji), s2, aux2)

    jE, jaux, jd, jd1, js2, jaux2 = (np.asarray(a) for a in run(
        jnp.asarray(sigma), jnp.asarray(i), jnp.asarray(do)))
    s = torch.from_numpy(sigma.copy())
    aux = pm.init_aux(s)
    assert aux.shape == (B, jm.K2, jm.P) and aux.dtype == torch.int32
    np.testing.assert_array_equal(aux.numpy(), jaux)
    np.testing.assert_array_equal(pm.energy(s).numpy(), jE)
    d = pm.delta_all(s, aux)
    np.testing.assert_array_equal(d.numpy(), jd)
    ti = torch.from_numpy(i)
    np.testing.assert_array_equal(pm.delta_one(s, aux, ti).numpy(), jd1)
    flips = 1 - 2 * torch.eye(jm.N, dtype=torch.int8)
    bf = torch.stack([pm.energy(s * flips[j]) - pm.energy(s)
                      for j in range(jm.N)], dim=1)
    assert torch.equal(d, bf)
    s2, aux2 = pm.flip(s, aux, ti, torch.from_numpy(do))
    np.testing.assert_array_equal(s2.numpy(), js2)
    np.testing.assert_array_equal(aux2.numpy(), jaux2)
    all_do = torch.ones(B, dtype=torch.bool)
    for _ in range(40):
        pm.flip(s2, aux2, torch.from_numpy(rng.integers(0, jm.N, B)), all_do)
    assert torch.equal(aux2, pm.init_aux(s2))


ALIASES = [f"Graph{p}Comm{k}{s}" for p, s in (("Q", "T"), ("", "RE"),
                                             ("", "LE"))
           for k in ("Step", "ReLU", "Qu")]


@pytest.mark.parametrize("name", ALIASES)
def test_replica_aliases_match_jax(name):
    """The twelve replica aliases build the JAX package's committee base and
    wrapper from one seed; their physical energies agree."""
    odd = "Step" in name
    K1, K2 = (3, 3) if odd else (4, 2)
    wrap = (0.4, 2.0)
    jm = getattr(rt, name)(K1, K2, 5, 3, *wrap, seed=9)
    pm = getattr(pt, name)(K1, K2, 5, 3, *wrap, seed=9, **CPU)
    assert type(pm).__name__ == type(jm).__name__
    assert (pm.N, pm.M, pm.Nk) == (jm.N, jm.M, jm.Nk)
    jb, pb = jm.resid_m.base, pm.resid_m.base
    for key in ("xi", "y", "c"):
        np.testing.assert_array_equal(getattr(pb, key).numpy(),
                                      _np(getattr(jb, key)))
    sigma = random_sigma(np.random.default_rng(3), B, jm.N)
    jE = np.asarray(jax.jit(jax.vmap(jm.energy))(jnp.asarray(sigma)),
                    np.float64)
    pE = pm.energy(torch.from_numpy(sigma)).double().numpy()
    np.testing.assert_allclose(pE, jE, rtol=0,
                               atol=1e-5 * (np.abs(jE).max() + jm.N))


def test_builders_refuse_as_jax():
    """Step wants odd K1 and K2, ReLU and Qu even ones (the JAX package's
    asserts, ValueError here); a given xi needs labels for ReLU and Qu; the
    converter checks shapes, kind and +-1 entries."""
    with pytest.raises(ValueError, match="odd"):
        pt.GraphCommStep(4, 3, 5, seed=1, **CPU)
    for fn in (pt.GraphCommReLU, pt.GraphCommQu):
        with pytest.raises(ValueError, match="even"):
            fn(3, 2, 5, seed=1, **CPU)
        with pytest.raises(ValueError, match="y is required"):
            fn(2, 2, 3, xi=np.ones((3, 4)), **CPU)
    xi = np.ones((3, 9), np.int8)
    with pytest.raises(ValueError, match="expected"):
        pt.committee_from_arrays(xi, np.ones(3), np.ones(2), 3, 3, "step")
    with pytest.raises(ValueError, match="kind"):
        pt.committee_from_arrays(xi, np.ones(3), np.ones(3), 3, 3, "tanh")
    with pytest.raises(ValueError, match="must be"):
        pt.committee_from_arrays(xi * 2, np.ones(3), np.ones(3), 3, 3,
                                 "step")


def test_commstep_energy_by_hand():
    """One unit of three inputs, two patterns: the second is misclassified
    (the JAX package's hand check)."""
    xi = np.array([[1, 1, 1], [-1, -1, -1]], dtype=np.int8)
    m = pt.GraphCommStep(3, 1, 2, xi=xi, **CPU)
    assert m.energy(torch.ones(1, 3, dtype=torch.int8)).tolist() == [1]


@pytest.mark.parametrize("sampler", ["standardMC", "rrrMC", "bklMC"])
def test_committee_sampler_invariant(sampler):
    """The generic paths (no kernel takes a committee) keep the exact int32
    E == energy(sigma)."""
    m = pt.GraphCommReLU(4, 2, 8, seed=11, **CPU)
    assert family_of(m) is None
    fn = getattr(pt, sampler)
    Es, st = fn(m, 1.5, 2000, step=500, chains=8, seed=5, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch"
    assert st.E.dtype == torch.int32 and Es.shape == (8, 4)
    assert torch.equal(m.energy(st.sigma), st.E)


def test_committee_eo_learns():
    """extremal_opt (the generic path, the kernels' streams) reaches zero
    training errors on GraphCommStep(5, 3, 5), as in the JAX package."""
    m = pt.GraphCommStep(5, 3, 5, seed=12, **CPU)
    R = pt.extremal_opt(m, 1.4, 3000, chains=8, seed=13, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch"
    assert float(R.Emin.min()) == 0.0
    assert torch.equal(m.to_physical(m.energy(R.sigma_min)), R.Emin)


def test_committee_bkl_law():
    """bklMC on GraphCommStep(3, 3, 7) (9 spins) samples the exact
    Boltzmann mean energy within max(5 SEM, 0.05)."""
    m = pt.GraphCommStep(3, 3, 7, seed=4, **CPU)
    beta = 1.0
    states = (torch.arange(2 ** m.N)[:, None] >> torch.arange(m.N)) & 1
    E = m.energy((2 * states - 1).to(torch.int8)).double().numpy()
    w = np.exp(-beta * (E - E.min()))
    E_exact = float((w * E).sum() / w.sum())
    Es, _ = pt.bklMC(m, beta, 6000, step=50, chains=64, seed=3, **CPU)
    Es = Es[:, 20:].double().numpy()
    err = abs(Es.mean() - E_exact)
    sem = Es.std() / np.sqrt(Es.shape[0] * 5.0)
    assert err < max(5 * sem, 0.05), (Es.mean(), E_exact, sem)
