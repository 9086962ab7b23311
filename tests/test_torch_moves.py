"""The port's move primitives (rrrmc_tpu_torch/samplers/moves.py) against the
JAX package's, fed identical uniforms: the uniforms JAX draws from its keys
are handed to the port. Indices, skips and decisions must be equal; float
outputs (weights, z) agree to rtol 1e-14, the last-bit differences between
XLA's and torch's float64 exp and cumsum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrrmc_tpu.samplers import moves as jmoves
from rrrmc_tpu_torch.samplers import moves as pmoves

torch.set_num_threads(1)


def _keys(n, seed=0):
    return jax.random.split(jax.random.key(seed), n)


def test_acceptance_weights():
    dE = np.random.default_rng(1).normal(0, 3, (8, 40))
    for beta in (0.0, 0.7, 3.0):
        want = np.asarray(jmoves.acceptance_weights(jnp.asarray(dE), beta))
        got = pmoves.acceptance_weights(torch.from_numpy(dE), beta).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14)


def test_categorical_from_weights():
    rng = np.random.default_rng(2)
    w = rng.exponential(size=(64, 30))
    w[:, 5] = 0.0                                 # a zero-weight site
    keys = _keys(64)
    ji, jz = jax.vmap(jmoves.categorical_from_weights)(keys, jnp.asarray(w))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(keys)
    pi, pz = pmoves.categorical_from_weights(torch.tensor(np.asarray(u)),
                                             torch.from_numpy(w))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=1e-14)
    assert not (pi == 5).any()


@pytest.mark.parametrize("p", [1e-4, 0.03, 0.5, 0.999, 1.0])
def test_geometric_skip(p):
    keys = _keys(256, seed=3)
    pj = jnp.full((), p, jnp.float64)
    js = jax.vmap(lambda k: jmoves.geometric_skip(k, pj))(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(keys)
    ps = pmoves.geometric_skip(torch.tensor(np.asarray(u)),
                               torch.full((256,), p, dtype=torch.float64))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_accept_factor():
    rng = np.random.default_rng(4)
    keys = _keys(512, seed=5)
    c = rng.exponential(size=512)
    x = rng.normal(0, 2, 512)
    ja = jax.vmap(jmoves.accept_factor)(keys, jnp.asarray(c), jnp.asarray(x))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(keys)
    pa = pmoves.accept_factor(torch.tensor(np.asarray(u)),
                              torch.from_numpy(c), torch.from_numpy(x))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert 0 < pa.sum() < 512
