"""The port's dense models (rrrmc_tpu_torch/models/dense.py) against the JAX
package's (rrrmc_tpu/models/dense.py): the same seed gives the same
couplings, and energies, local fields, flip energies and masked flips agree
(bit for bit on integer couplings); densify and the array converters; the
rule that builders run on the card unless asked for the CPU; and the dense
slice as a whole through the public API on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt

from torch_port_helpers import CPU, host, random_sigma

torch.set_num_threads(1)

B = 16

#: dense models built on both sides from the same arguments and seed
PAIRS = {
    "SK": lambda m: m.GraphSK(24, seed=3, **host(m)),
    "SK_256": lambda m: m.GraphSK(256, seed=1, **host(m)),
    "SKNormal": lambda m: m.GraphSKNormal(20, seed=4, **host(m)),
}


def port_dense(jm):
    """The port's FullyConnected with the JAX model's J and h."""
    return pt.fully_connected_from_arrays(np.asarray(jm.J), np.asarray(jm.h),
                                          scale=jm.scale, **CPU)


def _with_fields(mod):
    """GraphSK(16) with integer fields in -2..2."""
    m = mod.GraphSK(16, seed=7, **host(mod))
    h = np.random.RandomState(9).randint(-2, 3, size=m.N)
    if mod is rt:
        return dataclasses.replace(m, h=jnp.asarray(h, m.h.dtype))
    return dataclasses.replace(m, h=torch.as_tensor(h, dtype=m.h.dtype))


MODELS = dict(PAIRS, fields=_with_fields,
              densified=lambda m: m.densify(m.GraphRRG(32, 3, (-1, 1),
                                                       seed=2, **host(m))))


@pytest.mark.parametrize("name", list(PAIRS))
def test_same_seed_same_couplings(name):
    jm, pm = PAIRS[name](rt), PAIRS[name](pt)
    assert (pm.N, pm.scale) == (jm.N, jm.scale)
    integer = not pm.J.dtype.is_floating_point
    assert pm.J.dtype == (torch.int32 if integer else torch.float32)
    # the JAX package keeps float J in its float type (float64 under the
    # tests' x64 setting); the port's float32 is that value rounded
    dt = np.int32 if integer else np.float32
    np.testing.assert_array_equal(pm.J.numpy(), np.asarray(jm.J).astype(dt))
    np.testing.assert_array_equal(pm.h.numpy(), np.asarray(jm.h).astype(dt))
    assert torch.equal(pm.J, pm.J.t()) and not pm.J.diagonal().any()


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """energy, local_fields, delta_all and a masked flip: EQUAL on integer
    couplings (exact int32 on both sides); float couplings within 1e-5 * N
    (float32 products summed in another order)."""
    jm, pm = MODELS[name](rt), MODELS[name](pt)
    rng = np.random.default_rng(5)
    sigma = random_sigma(rng, B, pm.N)
    sj, sp = jnp.asarray(sigma), torch.from_numpy(sigma.copy())
    lf_j = np.asarray(jax.vmap(jm.local_fields)(sj))
    got = {"E": (pm.energy(sp), jax.vmap(jm.energy)(sj)),
           "lf": (pm.local_fields(sp), lf_j),
           "dE": (pm.delta_all(sp, pm.init_aux(sp)),
                  jax.vmap(jm.delta_all)(sj, jnp.asarray(lf_j)))}
    i = rng.integers(0, pm.N, B)
    do = rng.random(B) < 0.5
    ti = torch.as_tensor(i)
    assert torch.equal(pm.delta_one(sp, pm.init_aux(sp), ti),
                       got["dE"][0][torch.arange(B), ti])
    s2, lf2 = jax.vmap(jm.flip)(sj, jnp.asarray(lf_j), jnp.asarray(i),
                                jnp.asarray(do))
    # flip updates its arguments in place
    ps, plf = pm.flip(sp.clone(), pm.init_aux(sp), ti, torch.as_tensor(do))
    got["flip_sigma"] = (ps, s2)
    got["flip_lf"] = (plf, lf2)
    assert torch.equal(plf, pm.local_fields(ps)) or pm.J.is_floating_point()
    for key, (p, j) in got.items():
        if pm.J.dtype.is_floating_point:
            np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                       atol=1e-5 * pm.N, err_msg=key)
        else:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j),
                                          err_msg=key)


#: sparse models densified on both sides
DENSIFY = {
    "RRG": lambda m: m.GraphRRG(64, 3, (-1, 1), seed=2, **host(m)),
    "EA2D_L4": lambda m: m.GraphEA(4, 2, (-1, 1), seed=5, **host(m)),
    "Ising1D": lambda m: m.GraphIsing1D(16, **host(m)),
    "RRGNormal": lambda m: m.GraphRRGNormal(32, 3, seed=4, **host(m)),
}


@pytest.mark.parametrize("name", list(DENSIFY))
def test_densify_matches_jax(name):
    """densify gives the JAX package's J (int8 where it fits), h and scale,
    and keeps the physical energies of the sparse model."""
    jm, pm = DENSIFY[name](rt), DENSIFY[name](pt)
    jd, pd = rt.densify(jm), pt.densify(pm)
    want = {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32}
    assert pd.J.dtype == want.get(np.asarray(jd.J).dtype, torch.float32)
    dt = pd.J.numpy().dtype
    np.testing.assert_array_equal(pd.J.numpy(), np.asarray(jd.J).astype(dt))
    np.testing.assert_array_equal(pd.h.numpy(),
                                  np.asarray(jd.h).astype(pd.h.numpy().dtype))
    assert pd.scale == jd.scale and pd.device == pm.device
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(1), B,
                                          pm.N))
    e_p = pm.to_physical(pm.energy(sigma)).double()
    e_d = pd.to_physical(pd.energy(sigma)).double()
    torch.testing.assert_close(e_d, e_p, rtol=0, atol=1e-4)


def test_make_fully_connected_and_converters():
    rng = np.random.default_rng(13)
    A = rng.integers(-2, 3, size=(12, 12))
    J, h = (A + A.T) * 0.25, rng.integers(-2, 3, size=12) * 0.25
    jm = rt.make_fully_connected(J, h, scale=0.25)
    pm = pt.make_fully_connected(J, h, scale=0.25, **CPU)
    assert pm.J.dtype == torch.int32 and pm.scale == 0.25
    np.testing.assert_array_equal(pm.J.numpy(), np.asarray(jm.J))
    np.testing.assert_array_equal(pm.h.numpy(), np.asarray(jm.h))
    back = port_dense(jm)
    assert torch.equal(back.J, pm.J) and torch.equal(back.h, pm.h)
    f = pt.make_fully_connected(J, **CPU)
    assert f.J.dtype == torch.float32 and not f.h.any()
    with pytest.raises(ValueError, match="symmetric"):
        pt.make_fully_connected(A, **CPU)
    with pytest.raises(ValueError, match="integer grid"):
        pt.make_fully_connected(J + 0.01, scale=0.25, **CPU)
    with pytest.raises(ValueError, match="offset"):
        pt.densify(pt.make_pairwise([[1], [0]], [[1.0], [1.0]], 2,
                                    offset=3.0, **CPU))


#: builders called without a device
DEFAULT_BUILDERS = {
    "GraphSK": lambda: pt.GraphSK(8, seed=1),
    "GraphSKNormal": lambda: pt.GraphSKNormal(8, seed=1),
    "make_fully_connected": lambda: pt.make_fully_connected(np.zeros((4, 4))),
    "GraphRRG": lambda: pt.GraphRRG(8, 3, seed=1),
    "GraphEA": lambda: pt.GraphEA(4, 2, seed=1),
    "make_pairwise": lambda: pt.make_pairwise([[1], [0]], [[1.0], [1.0]], 2),
    "init_state": lambda: pt.init_state(pt.GraphSK(8, seed=1, **CPU), 2),
    "GraphQSKT": lambda: pt.GraphQSKT(8, 3, 0.5, 1.0, seed=1),
    "GraphSKRE": lambda: pt.GraphSKRE(8, 3, 1.0, 1.0, seed=1),
    "GraphQEAT": lambda: pt.GraphQEAT(3, 2, 3, 0.5, 1.0, seed=1),
    "GraphRRGNormalDiscretized": lambda: pt.GraphRRGNormalDiscretized(
        8, 3, (-1, 1), seed=1),
}


def _table(model):
    """A coupling table of a model, or of a composite's parts."""
    if hasattr(model, "J"):
        return model.J
    return getattr(model.resid_m, "base", model.resid_m).J


@pytest.mark.parametrize("name", list(DEFAULT_BUILDERS))
def test_builders_default_to_the_card(name):
    """Without `device` a builder (and init_state) places its tensors on
    CUDA: on a machine without a card that raises torch's own error, never
    a quiet CPU model."""
    build = DEFAULT_BUILDERS[name]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build()
        return
    out = build()
    t = out.sigma if name == "init_state" else _table(out)
    assert t.device.type == "cuda"


def _slice_runs(m):
    kw = dict(chains=B, seed=3, **CPU)
    return {
        "sweepMC": (lambda: pt.sweepMC(m, 1.0, 6, step=2, **kw),
                    "kernel-sk-sweep", 3),
        "sweepMC-torch": (lambda: pt.sweepMC(m, 1.0, 6, step=2,
                                             backend="torch", **kw),
                          "torch", 3),
        "sweepMC_dense": (lambda: pt.sweepMC_dense(m, 1.0, 7, step=3, **kw),
                          "kernel-sk-sweep", 2),
        "bklMC": (lambda: pt.bklMC(m, 2.0, 3000, step=500, **kw),
                  "kernel-rejfree-dense", 6),
        "wtmMC": (lambda: pt.wtmMC(m, 2.0, 8, step=16.0, **kw),
                  "kernel-rejfree-dense", 8),
        "rrrMC": (lambda: pt.rrrMC(m, 2.0, 400, step=100, **kw),
                  "kernel-rejfree-dense", 4),
        "standardMC": (lambda: pt.standardMC(m, 2.0, 300, step=100, **kw),
                       "torch", 3),
    }


@pytest.mark.parametrize("name", list(_slice_runs(None)))
def test_slice_through_public_api(name):
    """The dense slice on GraphSK(64) through the public entry points on the
    CPU: each takes its route (the kernels' plain versions), returns one
    physical energy per checkpoint, and its running energy and local fields
    equal energy(sigma) and local_fields(sigma) exactly."""
    m = pt.GraphSK(64, seed=4, **CPU)
    call, route, n_ckpt = _slice_runs(m)[name]
    Es, st = call()
    assert pt.LAST_ROUTE["backend"] == route
    if route.startswith("kernel"):
        assert pt.LAST_ROUTE["impl"] == "plain"
    assert Es.shape == (B, n_ckpt) and Es.dtype == torch.float32
    assert bool(torch.isfinite(Es).all())
    assert torch.equal(m.energy(st.sigma), st.E)
    assert torch.equal(m.local_fields(st.sigma), st.aux)
    if name in ("bklMC", "wtmMC", "rrrMC"):
        assert torch.equal(st.accepted, pt.LAST_ROUTE["acc"])
    elif name in ("sweepMC", "sweepMC_dense"):
        assert not st.accepted.any()    # the kernel route counts nothing
    else:
        assert int(st.accepted.min()) > 0


def test_sweepmc_routes_dense_by_structure():
    """A FullyConnected model the kernel cannot take goes to the delayed
    update when it is dense (float J) and to the colour masks when it is
    sparse (int32 couplings of 200 on a ring); backend="kernel" raises."""
    fl = pt.GraphSKNormal(40, seed=2, **CPU)
    _, st = pt.sweepMC(fl, 1.0, 2, chains=4, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch" and "window" in pt.LAST_ROUTE
    err = float((fl.energy(st.sigma) - st.E).abs().max())
    assert err < 1e-5 * fl.N
    ring = pt.densify(pt.make_pairwise(
        [[(i - 1) % 8, (i + 1) % 8] for i in range(8)], [[200.0, 200.0]] * 8,
        8, integer_scale=1.0, **CPU))
    assert ring.J.dtype == torch.int32 and ring.max_degree == 2
    Es, st = pt.sweepMC(ring, 0.5, 40, step=10, chains=8, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch" \
        and pt.LAST_ROUTE["n_masks"] == 2
    assert torch.equal(ring.energy(st.sigma), st.E) and Es.shape == (8, 4)
    with pytest.raises(NotImplementedError, match="127"):
        pt.sweepMC(ring, 0.5, 4, backend="kernel", chains=2, **CPU)

