"""The port's LatticeEA (rrrmc_tpu_torch/models/lattice.py) against the JAX
package's: the same seed gives identical direction-major couplings, padded
tables and fields; the roll-based local fields equal the gathered
Pairwise.local_fields and the JAX values (exactly for integer couplings);
the odd-L greedy colourings are independent sets equal to the JAX ones."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt

from torch_port_helpers import CPU, host, port_lattice, random_sigma

torch.set_num_threads(1)

B = 8
#: the float couplings are float32 in the port and float64 in the JAX tests
F32 = dict(rtol=0, atol=1e-5)


def _build(kind, L, D, mod):
    if kind == "pm_j":
        return mod.GraphEA(L, D, (-1, 1), seed=10 * L + D, **host(mod))
    if kind == "normal":
        return mod.GraphEANormal(L, D, seed=10 * L + D + 2, **host(mod))
    # integer fields
    m = mod.GraphEA(L, D, (-1, 1), seed=10 * L + D + 3, **host(mod))
    h = np.random.default_rng(L * D).integers(-2, 3, m.N)
    if mod is rt:
        return dataclasses.replace(m, h=jnp.asarray(h, m.h.dtype))
    return dataclasses.replace(m, h=torch.as_tensor(h, dtype=m.h.dtype))


CASES = [(kind, L, D) for kind in ("pm_j", "normal", "fields")
         for L in (3, 4, 5) for D in (2, 3)]


@pytest.mark.parametrize("kind,L,D", CASES)
def test_same_seed_same_lattice(kind, L, D):
    jm, pm = _build(kind, L, D, rt), _build(kind, L, D, pt)
    assert isinstance(pm, pt.LatticeEA)
    assert (pm.N, pm.K, pm.L, pm.D, pm.scale, pm.classes) == (
        jm.N, jm.K, jm.L, jm.D, jm.scale, jm.classes)
    np.testing.assert_array_equal(pm.neigh.numpy(), np.asarray(jm.neigh))
    for a in ("Jd", "J", "h", "offset"):
        want = np.asarray(getattr(jm, a))
        if kind == "normal":
            want = want.astype(np.float32)
        np.testing.assert_array_equal(getattr(pm, a).numpy(), want,
                                      err_msg=a)
    # column 2d is x + e_d, 2d + 1 is x - e_d: the coupling of a site's edge
    # toward its neighbour is the neighbour's coupling back
    rows = np.arange(pm.N)
    neigh, J = pm.neigh.numpy(), pm.J.numpy()
    for d in range(D):
        np.testing.assert_array_equal(J[neigh[:, 2 * d], 2 * d + 1],
                                      J[rows, 2 * d])
    # the converter carries the JAX model across unchanged
    cm = port_lattice(jm)
    for a in ("neigh", "Jd", "J", "h", "offset"):
        assert torch.equal(getattr(cm, a), getattr(pm, a)), a


@pytest.mark.parametrize("kind,L,D", CASES)
def test_roll_local_fields(kind, L, D):
    """Roll local fields = gathered Pairwise.local_fields = JAX's, exact
    int32 for integer couplings; energies and delta_all likewise."""
    jm, pm = _build(kind, L, D, rt), _build(kind, L, D, pt)
    sigma = random_sigma(np.random.default_rng(L + D), B, pm.N)
    sp, sj = torch.from_numpy(sigma), jnp.asarray(sigma)
    lf = pm.local_fields(sp)
    gathered = pt.Pairwise.local_fields(pm, sp)
    lf_j = np.asarray(jax.vmap(jm.local_fields)(sj))
    E_j = np.asarray(jax.vmap(jm.energy)(sj))
    if kind == "normal":
        torch.testing.assert_close(lf, gathered, **F32)
        np.testing.assert_allclose(lf.numpy(), lf_j, **F32)
        np.testing.assert_allclose(pm.energy(sp).numpy(), E_j,
                                   atol=1e-5 * pm.N)
        return
    assert lf.dtype == torch.int32
    assert torch.equal(lf, gathered)
    np.testing.assert_array_equal(lf.numpy(), lf_j)
    np.testing.assert_array_equal(pm.energy(sp).numpy(), E_j)
    np.testing.assert_array_equal(
        pm.delta_all(sp, lf).numpy(),
        np.asarray(jax.vmap(jm.delta_all)(sj, jnp.asarray(lf_j))))


@pytest.mark.parametrize("L,D", [(3, 2), (4, 2), (5, 3), (6, 3)])
def test_sweep_masks(L, D):
    """Even L: the checkerboard; odd L: the greedy colouring. Either way
    every class is an independent set, the classes cover every site once,
    and they equal the JAX masks."""
    jm, pm = rt.GraphEA(L, D, seed=1), pt.GraphEA(L, D, seed=1, **CPU)
    masks = pm.sweep_masks()
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jm.sweep_masks()))
    assert masks.dtype == torch.bool
    assert torch.equal(masks.sum(0), torch.ones(pm.N, dtype=torch.int64))
    neigh = pm.neigh.long()
    for m in masks:
        assert not bool((m[:, None] & m[neigh]).any())
    assert (masks.shape[0] == 2) == (L % 2 == 0)


def test_lattice_builders_check_arguments():
    with pytest.raises(ValueError, match="L > 2"):
        pt.make_lattice_ea(2, 2, np.ones((2, 2, 2)), integer_scale=1.0, **CPU)
    with pytest.raises(ValueError, match="grid"):
        pt.make_lattice_ea(3, 2, np.full((2, 3, 3), 0.5), integer_scale=1.0,
                           **CPU)
    with pytest.raises(ValueError, match="Jd"):
        pt.lattice_from_arrays(np.ones((2, 3, 3), np.int32),
                               np.zeros(8, np.int32), 3, 2, 1.0, **CPU)
    # L = 2 stays generic
    assert type(pt.GraphEA(2, 3, **CPU)) is pt.Pairwise
