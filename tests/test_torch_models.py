"""The port's models (rrrmc_tpu_torch/models) against the JAX package's: the
same seed gives identical tables, and on the same spins energies, local
fields, delta_all and masked flips agree -- bit for bit for integer
couplings, within float32 summation error (1e-5 per spin) for float ones,
which the port keeps in float32 where the JAX tests run float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt

from torch_port_helpers import CPU, host, port_model, random_sigma

torch.set_num_threads(1)

#: (JAX model, port model) built from the same arguments and seed
PAIRS = {
    "EA2D_L2": lambda m: m.GraphEA(2, 2, (-1, 1), seed=3, **host(m)),
    "EA3D_L2": lambda m: m.GraphEA(2, 3, (-1, 1), seed=13, **host(m)),
    "EANormal_L2": lambda m: m.GraphEANormal(2, 3, seed=5, **host(m)),
    "RRG": lambda m: m.GraphRRG(12, 3, (-1, 1), seed=7, **host(m)),
    "RRG_frac": lambda m: m.GraphRRG(12, 3, (-1.0, -0.5, 0.5, 1.0), seed=8,
                                     **host(m)),
    "RRG_big": lambda m: m.GraphRRG(96, 4, (-2, -1, 1, 2), seed=1, **host(m)),
    "RRGNormal": lambda m: m.GraphRRGNormal(12, 3, seed=9, **host(m)),
    "Ising1D": lambda m: m.GraphIsing1D(8, **host(m)),
    "Fields": lambda m: m.GraphFields(10, (0.5, 1.5), seed=11, **host(m)),
    "Empty": lambda m: m.GraphEmpty(6, **host(m)),
    "TwoSpin": lambda m: m.GraphTwoSpin(**host(m)),
    "ThreeSpin": lambda m: m.GraphThreeSpin(**host(m)),
}

B = 16


def _pair(name):
    build = PAIRS[name]
    return build(rt), build(pt)


def _integer(pm):
    return not pm.J.dtype.is_floating_point


@pytest.mark.parametrize("name", list(PAIRS))
def test_same_seed_same_tables(name):
    jm, pm = _pair(name)
    assert (pm.N, pm.K, pm.scale, pm.classes) == (jm.N, jm.K, jm.scale,
                                                  jm.classes)
    np.testing.assert_array_equal(pm.neigh.numpy(), np.asarray(jm.neigh))
    assert pm.neigh.dtype == torch.int32
    if _integer(pm):
        assert pm.J.dtype == torch.int32 and pm.h.dtype == torch.int32
        for a in ("J", "h", "offset"):
            np.testing.assert_array_equal(getattr(pm, a).numpy(),
                                          np.asarray(getattr(jm, a)))
    else:
        assert pm.J.dtype == torch.float32
        for a in ("J", "h", "offset"):
            np.testing.assert_array_equal(
                getattr(pm, a).numpy(),
                np.asarray(getattr(jm, a)).astype(np.float32))


@pytest.mark.parametrize("name", list(PAIRS))
def test_energy_fields_delta(name):
    jm, pm = _pair(name)
    sigma = random_sigma(np.random.default_rng(1), B, jm.N)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma)
    E_j = np.asarray(jax.vmap(jm.energy)(sj))
    lf_j = np.asarray(jax.vmap(jm.local_fields)(sj))
    d_j = np.asarray(jax.vmap(jm.delta_all)(sj, jnp.asarray(lf_j)))
    E_p = pm.energy(sp).numpy()
    lf_p = pm.init_aux(sp)
    d_p = pm.delta_all(sp, lf_p).numpy()
    if _integer(pm):
        for got, want in ((E_p, E_j), (lf_p.numpy(), lf_j), (d_p, d_j)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(E_p, E_j, atol=1e-5 * jm.N)
        np.testing.assert_allclose(lf_p.numpy(), lf_j, atol=1e-5)
        np.testing.assert_allclose(d_p, d_j, atol=1e-5)
    i = torch.from_numpy(np.random.default_rng(2).integers(0, jm.N, B))
    np.testing.assert_array_equal(pm.delta_one(sp, lf_p, i).numpy(),
                                  d_p[np.arange(B), i.numpy()])
    np.testing.assert_allclose(
        pm.to_physical(pm.energy(sp)).numpy(),
        np.asarray(jax.vmap(lambda s: jm.to_physical(jm.energy(s)))(sj)),
        rtol=1e-6, atol=1e-5 * jm.N)


@pytest.mark.parametrize("name", list(PAIRS))
def test_masked_flips(name):
    """A sequence of masked flips (do = False leaves a chain untouched)
    keeps sigma and aux equal to the JAX model's and to a fresh init_aux."""
    jm, pm = _pair(name)
    rng = np.random.default_rng(3)
    sigma = random_sigma(rng, B, jm.N)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma.copy())
    aj, ap = jax.vmap(jm.init_aux)(sj), pm.init_aux(sp)
    flip = jax.jit(jax.vmap(jm.flip))
    for _ in range(20):
        i = rng.integers(0, jm.N, B)
        do = rng.random(B) < 0.7
        sj, aj = flip(sj, aj, jnp.asarray(i), jnp.asarray(do))
        pm.flip(sp, ap, torch.from_numpy(i), torch.from_numpy(do))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    if _integer(pm):
        np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
        assert torch.equal(ap, pm.init_aux(sp))
    else:
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), atol=1e-5)
        torch.testing.assert_close(ap, pm.init_aux(sp), atol=1e-5, rtol=0)


def test_ea_instance_file(tmp_path):
    """load_ea_instance / GraphEAFromFile read the same file to the same
    model on both sides (L=2: doubled edges)."""
    L = 3
    rng = np.random.default_rng(4)
    lines = ["type: test", f"size: {L}", "name: t"]
    for x in range(L * L):
        r, c = divmod(x, L)
        for y in (r * L + (c + 1) % L, ((r + 1) % L) * L + c):
            lines.append(f"{x + 1} {y + 1} {rng.normal():.6f}")
    f = tmp_path / "ea.txt"
    f.write_text("\n".join(lines) + "\n")
    jm, pm = rt.GraphEAFromFile(str(f)), pt.GraphEAFromFile(str(f), **CPU)
    assert pt.load_ea_instance(str(f))[0] == L
    np.testing.assert_array_equal(pm.neigh.numpy(), np.asarray(jm.neigh))
    np.testing.assert_array_equal(pm.J.numpy(),
                                  np.asarray(jm.J).astype(np.float32))


def test_unported_constructors_raise():
    """The NormalDiscretized builders build Doubles (an inner part on the
    levels plus a residual). The race samplers run a Double that is not a
    Quant / RE composite on the generic torch path (rrr by the DoubleGraph
    law), with the running physical energy within float32 rounding of
    energy(sigma); the kernel route, asked for, raises."""
    for build in (lambda: pt.GraphRRGNormalDiscretized(12, 3, (-1, 1), **CPU),
                  lambda: pt.GraphEANormalDiscretized(2, 2, (-1, 1), **CPU),
                  lambda: pt.GraphFieldsNormalDiscretized(8, (-1, 1), **CPU)):
        m = build()
        assert isinstance(m, pt.Double)
        for f in (pt.rrrMC, pt.bklMC):
            Es, st = f(m, 1.0, 200, step=20, chains=2, **CPU)
            assert pt.LAST_ROUTE["backend"] == "torch"
            err = (m.energy(st.sigma).double() - st.E.double()).abs().max()
            assert float(err) <= 1e-5 * m.N and Es.shape == (2, 10)
            with pytest.raises(NotImplementedError, match="Double"):
                f(m, 1.0, 10, chains=2, backend="kernel", **CPU)


@pytest.mark.parametrize("name", ["RRG_frac", "RRGNormal", "Fields"])
def test_convert_round_trip(name):
    jm, pm = _pair(name)
    cm = port_model(jm)
    for a in ("neigh", "J", "h", "offset"):
        assert torch.equal(getattr(cm, a), getattr(pm, a)), a
    assert (cm.N, cm.K, cm.scale, cm.classes) == (pm.N, pm.K, pm.scale,
                                                  pm.classes)
    sigma = random_sigma(np.random.default_rng(5), 4, pm.N)
    st = pt.state_from_arrays(cm, sigma, **CPU)
    assert torch.equal(st.E, pm.energy(torch.from_numpy(sigma)))
    assert torch.equal(st.aux, pm.local_fields(torch.from_numpy(sigma)))
    with pytest.raises(ValueError):
        pt.pairwise_from_arrays(np.asarray(jm.neigh), np.asarray(jm.J),
                                np.asarray(jm.h)[:-1], 0, N=jm.N, K=jm.K,
                                scale=jm.scale, **CPU)


def test_random_spins_and_init_state():
    m = pt.GraphRRG(12, 3, seed=1, **CPU)
    a = pt.init_state(m, 8, seed=3, **CPU)
    b = pt.init_state(m, 8, seed=3, **CPU)
    assert torch.equal(a.sigma, b.sigma) and a.sigma.dtype == torch.int8
    assert set(a.sigma.unique().tolist()) <= {-1, 1}
    assert torch.equal(a.E, m.energy(a.sigma))
    c = pt.init_state(m, 8, C0=np.ones(12, np.int8), **CPU)
    assert torch.equal(c.sigma, torch.ones(8, 12, dtype=torch.int8))
