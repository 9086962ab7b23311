"""The port's replica composites (rrrmc_tpu_torch/models/composite.py,
replicas.py, aliases.py) against the JAX package's on the CPU: the same base
arrays give the same energies, aux, flip costs and flips for Quant and RE
over an SK and an RRG base and for Mixed / Double; the wrapper tables and
observables agree; the NormalDiscretized builders and the aliases draw the
same tables per seed; the ring / star dE identity of the kernels equals the
composite's delta_all; the generic samplers keep the energy invariant; the
public entry points take their routes.

Tolerances: the port computes physical energies in float32, the JAX package
in float64 (x64 on): energies within 2e-6 relative to the model's energy
scale (sum of |E| terms ~ N), flip costs within 1e-5 absolute; integer
tables and aux EQUAL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu.models import aliases as jal
from rrrmc_tpu.samplers.sweep import composite_masks as jax_composite_masks
from rrrmc_tpu_torch.ops.replica import replica_de, replica_state, \
    replica_tables
from rrrmc_tpu_torch.samplers.sweep import composite_masks

from torch_port_helpers import CPU, port_composite, port_model, random_sigma

torch.set_num_threads(1)

B = 6

#: (JAX composite, port composite built by the port's own builders)
CASES = {
    "QSKT": (lambda: jal.GraphQSKT(16, 3, 0.5, 2.0, seed=3),
             lambda: pt.GraphQSKT(16, 3, 0.5, 2.0, seed=3, **CPU)),
    "SKRE": (lambda: jal.GraphSKRE(16, 4, 1.5, 0.7, seed=3),
             lambda: pt.GraphSKRE(16, 4, 1.5, 0.7, seed=3, **CPU)),
    "QRRG": (lambda: rt.GraphQuant(20, 3, 1.0, 1.0,
                                   rt.GraphRRG(20, 3, (-1, 1), seed=11)),
             lambda: pt.GraphQuant(20, 3, 1.0, 1.0, pt.GraphRRG(
                 20, 3, (-1, 1), seed=11, **CPU))),
    "RERRG": (lambda: rt.GraphRobustEnsemble(20, 3, 2.0, 1.0, rt.GraphRRG(
        20, 3, (-1, 1), seed=12)),
              lambda: pt.GraphRobustEnsemble(20, 3, 2.0, 1.0, pt.GraphRRG(
                  20, 3, (-1, 1), seed=12, **CPU))),
    "QEAT": (lambda: jal.GraphQEAT(3, 2, 3, 0.5, 2.0, seed=3),
             lambda: pt.GraphQEAT(3, 2, 3, 0.5, 2.0, seed=3, **CPU)),
    "Q0T": (lambda: jal.GraphQ0T(10, 3, 0.5, 2.0),
            lambda: pt.GraphQ0T(10, 3, 0.5, 2.0, **CPU)),
    "0RE": (lambda: jal.Graph0RE(10, 3, 1.0, 1.0),
            lambda: pt.Graph0RE(10, 3, 1.0, 1.0, **CPU)),
    "QSKNormalT": (lambda: jal.GraphQSKNormalT(12, 3, 0.5, 2.0, seed=3),
                   lambda: pt.GraphQSKNormalT(12, 3, 0.5, 2.0, seed=3,
                                              **CPU)),
    "EARE": (lambda: jal.GraphEARE(3, 2, 3, 1.5, 0.7, seed=3),
             lambda: pt.GraphEARE(3, 2, 3, 1.5, 0.7, seed=3, **CPU)),
}


def _np(x):
    return np.asarray(x)


def _jax_batch(jm, sigma):
    s = jnp.asarray(sigma)
    aux = jax.vmap(jm.init_aux)(s)
    return (_np(jax.vmap(jm.energy)(s)), aux,
            _np(jax.vmap(jm.delta_all)(s, aux)))


def _close(a, b, scale, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64),
                               atol=2e-6 * scale + 1e-5, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_aliases_draw_the_same_tables(name):
    """The port's builders draw the JAX package's base tables bit for bit,
    and the wrapper constants agree (fourK / fk in float32)."""
    jm, pm = CASES[name][0](), CASES[name][1]()
    jb, pb = jm.resid_m.base, pm.resid_m.base
    assert type(jm).__name__ == type(pm).__name__ and pm.N == jm.N
    for key in ("J", "h", "neigh"):
        if hasattr(jb, key):
            np.testing.assert_array_equal(getattr(pb, key).numpy(),
                                          _np(getattr(jb, key)).astype(
                                              getattr(pb, key).numpy().dtype))
    assert pb.scale == jb.scale
    if name.startswith("Q"):
        assert pm.inner_m.scale == jm.inner_m.scale      # fourK / 4
        np.testing.assert_array_equal(pm.inner_m.neigh.numpy(),
                                      _np(jm.inner_m.neigh))
    else:
        np.testing.assert_array_equal(
            pm.inner_m.fk.numpy(), _np(jm.inner_m.fk).astype(np.float32))


@pytest.mark.parametrize("name", ["QSKT", "SKRE", "QRRG", "RERRG", "QEAT"])
def test_model_methods_match_jax(name):
    """energy, init_aux, delta_all, delta_one and flip on the composite
    carried across from the JAX model's arrays (convert.py)."""
    jm = CASES[name][0]()
    pm = port_composite(jm)
    rng = np.random.default_rng(1)
    sigma = random_sigma(rng, B, jm.N)
    jE, jaux, jd = _jax_batch(jm, sigma)
    sig = torch.from_numpy(sigma.copy())
    aux = pm.init_aux(sig)
    scale = float(np.abs(jE).max()) + jm.N
    _close(pm.energy(sig).numpy(), jE, scale, "energy")
    for a, b in zip(aux, jaux):
        if not a.dtype.is_floating_point:
            np.testing.assert_array_equal(a.numpy().reshape(-1),
                                          _np(b).reshape(-1))
    d = pm.delta_all(sig, aux)
    _close(d.numpy(), jd, 1.0, "delta_all")
    i = torch.from_numpy(rng.integers(0, jm.N, B))
    do = torch.tensor([True, False, True, True, False, True])
    assert torch.equal(pm.delta_one(sig, aux, i), d[torch.arange(B), i])
    sig2, aux2 = pm.flip(sig, aux, i, do)
    flipped = sigma.copy()
    rows = np.arange(B)[do.numpy()]
    flipped[rows, i.numpy()[do.numpy()]] *= -1
    np.testing.assert_array_equal(sig2.numpy(), flipped)
    jE2, _, jd2 = _jax_batch(jm, flipped)
    _close(pm.delta_all(sig2, aux2).numpy(), jd2, 1.0, "delta_all flipped")
    for a, b in zip(aux2, pm.init_aux(sig2)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_mixed_and_double_match_jax():
    """Mixed (an RRG plus fields) and a NormalDiscretized Double against the
    JAX combinators: energy, delta_all and a flip."""
    jr = rt.GraphRRG(12, 3, (-1, 1), seed=4)
    jf = rt.GraphFields(12, (1, 2), seed=5)
    jmix = rt.mixed(jr, jf)
    pmix = pt.mixed(port_model(jr), port_model(jf))
    jdbl = rt.GraphRRGNormalDiscretized(12, 3, (-1, 0, 1), seed=6)
    pdbl = pt.GraphRRGNormalDiscretized(12, 3, (-1, 0, 1), seed=6, **CPU)
    rng = np.random.default_rng(2)
    sigma = random_sigma(rng, B, 12)
    i = torch.from_numpy(rng.integers(0, 12, B))
    do = torch.ones(B, dtype=torch.bool)
    for jm, pm in ((jmix, pmix), (jdbl, pdbl)):
        jE, _, jd = _jax_batch(jm, sigma)
        sig = torch.from_numpy(sigma.copy())
        aux = pm.init_aux(sig)
        _close(pm.energy(sig).numpy(), jE, 12.0, "energy")
        _close(pm.delta_all(sig, aux).numpy(), jd, 1.0, "delta_all")
        sig2, aux2 = pm.flip(sig, aux, i, do)
        flipped = sigma.copy()
        flipped[np.arange(B), i.numpy()] *= -1
        _, _, jd2 = _jax_batch(jm, flipped)
        _close(pm.delta_all(sig2, aux2).numpy(), jd2, 1.0, "after flip")
    assert pdbl.delta_classes() == jdbl.delta_classes()
    np.testing.assert_array_equal(pdbl.neighbor_table().numpy(),
                                  _np(jdbl.neighbor_table()))


@pytest.mark.parametrize("name", ["RRG", "EA", "Fields"])
def test_normal_discretized_tables(name):
    """The three NormalDiscretized builders give the JAX package's inner and
    residual tables bit for bit for the same seed."""
    lev = (-1, 0, 1)
    j, p = {
        "RRG": (rt.GraphRRGNormalDiscretized(30, 3, lev, seed=8),
                pt.GraphRRGNormalDiscretized(30, 3, lev, seed=8, **CPU)),
        "EA": (rt.GraphEANormalDiscretized(3, 2, lev, seed=8),
               pt.GraphEANormalDiscretized(3, 2, lev, seed=8, **CPU)),
        "Fields": (rt.GraphFieldsNormalDiscretized(30, (-0.5, 0.5), seed=8),
                   pt.GraphFieldsNormalDiscretized(30, (-0.5, 0.5), seed=8,
                                                   **CPU)),
    }[name]
    assert isinstance(p, pt.Double) and p.N == j.N
    for jp, pp in ((j.inner_m, p.inner_m), (j.resid_m, p.resid_m)):
        for key in ("neigh", "J", "h"):
            a, b = getattr(pp, key).numpy(), _np(getattr(jp, key))
            if a.dtype.kind == "f":
                np.testing.assert_array_equal(a, b.astype(np.float32))
            else:
                np.testing.assert_array_equal(a, b)
        assert pp.scale == jp.scale and pp.classes == jp.classes


def test_wrapper_tables_and_observables():
    """four_K, fk, transverse_mag, Qenergy, Renergies, overlaps, REenergies
    and the replica layout agree with the JAX package."""
    from rrrmc_tpu.models.replicas import _fk_table as jfk
    from rrrmc_tpu_torch.models.replicas import _fk_table as pfk

    for beta, g, M in ((2.0, 0.3, 16), (1.0, 1.5, 5), (0.7, 0.01, 3)):
        assert pt.four_K(beta, g, M) == rt.four_K(beta, g, M)
        np.testing.assert_array_equal(pfk(M, g, beta), jfk(M, g, beta))
    jq, pq = CASES["QSKT"][0](), CASES["QSKT"][1]()
    jr, pr = CASES["SKRE"][0](), CASES["SKRE"][1]()
    sigma = random_sigma(np.random.default_rng(3), B, jq.N)
    s, sj = torch.from_numpy(sigma), jnp.asarray(sigma)
    v = jax.vmap
    _close(pq.transverse_mag(s).numpy(), _np(v(jq.transverse_mag)(sj)), 1.0,
           "transverse_mag")
    _close(pt.transverse_mag(pq.inner_m, s, pq.beta).numpy(),
           _np(v(lambda x: rt.transverse_mag(jq.inner_m, x, jq.beta))(sj)),
           1.0, "transverse_mag (function)")
    _close(pq.Qenergy(s).numpy(), _np(v(jq.Qenergy)(sj)), 1.0, "Qenergy")
    _close(pq.Renergies(s).numpy(), _np(v(jq.Renergies)(sj)), 16.0,
           "Renergies")
    np.testing.assert_allclose(pq.overlaps(s).numpy(),
                               _np(v(jq.overlaps)(sj)), atol=1e-6)
    sigma_r = random_sigma(np.random.default_rng(4), B, jr.N)
    sr = torch.from_numpy(sigma_r)
    _close(pr.REenergies(sr).numpy(),
           _np(v(jr.REenergies)(jnp.asarray(sigma_r))), 16.0, "REenergies")
    rep = pr.resid_m
    assert torch.equal(rep.to_replicas(sr)[1], sr[0, 16:32])
    k, ii, is_rep = rep.decompose(torch.tensor([0, 17, 63]))
    assert k.tolist() == [0, 1, 3] and ii.tolist() == [0, 1, 15]
    assert bool(is_rep.all())
    for pm, jm in ((pq, jq), (pr, jr)):
        np.testing.assert_array_equal(pm.neighbor_table().numpy(),
                                      _np(jm.neighbor_table()))
    with pytest.raises(ValueError, match="greater than 2"):
        pt.GraphSKRE(8, 2, 1.0, 1.0, seed=1, **CPU)
    with pytest.raises(ValueError, match="greater than 2"):
        pt.GraphQSKT(8, 2, 1.0, 1.0, seed=1, **CPU)


@pytest.mark.parametrize("name", ["QSKT", "SKRE", "QRRG", "RERRG",
                                  "QSKNormalT"])
def test_kernel_identity_equals_delta_all(name):
    """The kernels' ring / star identity (ops/replica.py::replica_de on the
    resident base fields) equals the composite's delta_all, and the race's
    family and tables are the dense or the sparse base's."""
    pm = CASES[name][1]()
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(5), B,
                                          pm.N))
    E = pm.energy(sigma)
    lf, E32 = replica_state(pm, sigma, E)
    (tab,) = replica_tables(pm)
    assert (tab.neigh is None) == (name not in ("QRRG", "RERRG"))
    d = replica_de(tab, sigma, lf)
    torch.testing.assert_close(d, pm.delta_all(sigma, pm.init_aux(sigma)),
                               rtol=0, atol=1e-5)
    assert E32.dtype == torch.float32 and torch.equal(E32, E)


@pytest.mark.parametrize("name", ["QSKT", "SKRE"])
def test_generic_samplers_keep_the_invariant(name):
    """standardMC(backend="torch") and extremal_opt(backend="torch") run
    the composites through the model methods alone; the running energies
    equal energy(sigma) within float32 accumulation (1e-4 relative)."""
    pm = CASES[name][1]()
    Es, st = pt.standardMC(pm, 1.0, 600, step=200, chains=B, seed=2,
                           backend="torch", **CPU)
    assert Es.shape == (B, 3) and pt.LAST_ROUTE["backend"] == "torch"
    E_re = pm.energy(st.sigma)
    assert float((E_re - st.E).abs().max()) <= 1e-4 * float(
        E_re.abs().max().clamp(min=1))
    assert int(st.accepted.sum()) > 0
    R = pt.extremal_opt(pm, 1.4, 200, chains=B, seed=3, backend="torch",
                        **CPU)
    assert pt.LAST_ROUTE == {"backend": "torch", "impl": "plain"}
    for s, e in ((R.sigma, R.E), (R.sigma_min, R.Emin)):
        E_re = pm.energy(s)
        assert float((E_re - e).abs().max()) <= 1e-4 * float(
            E_re.abs().max().clamp(min=1))
    # auto takes the torch route too: no EO kernel for composites
    pt.extremal_opt(pm, 1.4, 5, chains=2, seed=3, **CPU)
    assert pt.LAST_ROUTE["backend"] == "torch"


#: (entry point, model, route, checkpoints)
def _runs():
    q = CASES["QSKT"][1]()
    r = CASES["RERRG"][1]()
    kw = dict(chains=4, seed=5, **CPU)
    return {
        "rrrMC QSKT": (lambda: pt.rrrMC(q, 2.0, 60, step=20, **kw), q,
                       "kernel-rejfree-replica-dense", 3),
        "bklMC QSKT": (lambda: pt.bklMC(q, 2.0, 800, step=200, **kw), q,
                       "kernel-rejfree-replica-dense", 4),
        "wtmMC RERRG": (lambda: pt.wtmMC(r, 1.0, 3, step=1.0, **kw), r,
                        "kernel-rejfree-replica-sparse", 3),
        "rrrMC RERRG": (lambda: pt.rrrMC(r, 1.0, 60, step=30, **kw), r,
                        "kernel-rejfree-replica-sparse", 2),
        "sweepMC_quant": (lambda: pt.sweepMC_quant(q, 2.0, 4, step=2, **kw),
                          q, "kernel-replica-sweep", 2),
        "sweepMC_replica": (lambda: pt.sweepMC_replica(
            CASES["SKRE"][1](), 0.7, 3, step=2, **kw), None,
                            "kernel-replica-sweep", 1),
        "sweepMC RERRG": (lambda: pt.sweepMC(r, 1.0, 2, step=1, **kw), r,
                          "torch", 2),
    }


@pytest.mark.parametrize("name", list(_runs()))
def test_public_entry_points(name):
    """The composites through the public samplers on the CPU: each takes
    its route (the kernels' plain versions, or the colour-mask sweep), gives
    one physical energy per checkpoint, and keeps E == energy(sigma) within
    float32 accumulation."""
    call, model, route, n_ckpt = _runs()[name]
    Es, st = call()
    model = model or CASES["SKRE"][1]()
    assert pt.LAST_ROUTE["backend"] == route
    assert Es.shape == (4, n_ckpt) and bool(torch.isfinite(Es).all())
    E_re = model.energy(st.sigma)
    assert float((E_re - st.E).abs().max()) <= 1e-4 * float(
        E_re.abs().max().clamp(min=1))
    if name in ("sweepMC_quant", "sweepMC RERRG"):  # no remainder sweep
        assert torch.equal(Es[:, -1], st.E)


def test_composite_masks_match_jax():
    """The colour-mask sweep's masks are the JAX package's."""
    jm = CASES["RERRG"][0]()
    pm = CASES["RERRG"][1]()
    np.testing.assert_array_equal(composite_masks(pm).numpy(),
                                  _np(jax_composite_masks(jm)))
    assert composite_masks(CASES["QSKT"][1]()) is None


def test_ineligible_models_raise():
    """No fallback: the sweep kernel refuses a sparse base, the race
    kernels a Double that is not a Quant / RE composite (which the race
    samplers run on the generic torch path unless the kernel is asked
    for), sweepMC a composite over a dense base (that is
    sweepMC_quant's)."""
    r = CASES["RERRG"][1]()
    with pytest.raises(ValueError, match="replica sweep kernel"):
        pt.sweepMC_quant(r, 1.0, 1, chains=2, **CPU)
    dbl = pt.GraphRRGNormalDiscretized(12, 3, (-1, 0, 1), seed=6, **CPU)
    for fn in (pt.rrrMC, pt.bklMC):
        Es, st = fn(dbl, 1.0, 10, chains=2, **CPU)
        assert pt.LAST_ROUTE["backend"] == "torch"
        err = (dbl.energy(st.sigma).double() - st.E.double()).abs().max()
        assert float(err) <= 1e-5 * dbl.N
        with pytest.raises(NotImplementedError, match="not eligible"):
            fn(dbl, 1.0, 10, chains=2, backend="kernel", **CPU)
    with pytest.raises(NotImplementedError, match="sweepMC_quant"):
        pt.sweepMC(CASES["QSKT"][1](), 1.0, 1, chains=2, **CPU)
    with pytest.raises(NotImplementedError, match="no sweep kernel"):
        pt.sweepMC(r, 1.0, 1, chains=2, backend="kernel", **CPU)
