"""The port's local-entropy, topological-LE and AddFields wrappers
(rrrmc_tpu_torch/models/replicas.py, aliases.py, sat.py, perceptron.py)
against the JAX package's on the CPU: the Replicated centre-block paths, the
GraphLE star, LEModel, GraphTLE and TLEModel, the reference layouts,
GraphAddFields and GraphAddSubFields, every LE / TLE / SAT / perceptron
alias of this slice from the same seed, the converters, the composite
masks of sweepMC, and the laws of standardMC and wtmMC on an LE wrapper
against exact enumeration.

Tolerances: integer parts (the GraphLE star, the Replicated base deltas,
the aux of an integer base, the tables, the masks, the layouts) are EQUAL;
physical float32 values against the JAX package's x64 within 1e-5 relative
to the model's energy scale (sum of |E| terms), plus 1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu.models import aliases as jal
from rrrmc_tpu.models import replicas as jrep
from rrrmc_tpu.samplers.sweep import composite_masks as jax_composite_masks
from rrrmc_tpu_torch.models import replicas as prep
from rrrmc_tpu_torch.samplers.families import family_of
from rrrmc_tpu_torch.samplers.sweep import composite_masks

from torch_port_helpers import CPU, port_model, random_sigma

torch.set_num_threads(1)

B = 6
NK = 12
#: the port's float32 against the JAX package's x64
RTOL = 1e-5


def _np(x):
    return np.asarray(x)


def _close(a, b, scale, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64),
                               atol=RTOL * scale + 1e-5, rtol=0,
                               err_msg=what)


def port_wrapper(jm):
    """The port's wrapper over the JAX model's base tables, through
    convert.py (LE, TLE, AddFields, AddSubFields)."""
    base = port_model(jm.resid_m.base if hasattr(jm.resid_m, "base")
                      else (jm.resid_m.parts[0]
                            if isinstance(jm.resid_m, rt.Mixed)
                            else jm.resid_m))
    if isinstance(jm, jrep.LEModel):
        return pt.replica_from_arrays("le", base, M=jm.M,
                                      coupling=jm.inner_m.scale, beta=1.0)
    if isinstance(jm, jrep.TLEModel):
        return pt.replica_from_arrays(
            "tle", base, M=jm.M, coupling=jm.inner_m.gammaT,
            lambda_=jm.inner_m.lambdaT, beta=1.0,
            neighb=_np(jm.inner_m.neighb))
    kind = "addsub" if isinstance(jm.resid_m, rt.Mixed) else "af"
    return pt.replica_from_arrays(kind, base,
                                  fields=-_np(jm.inner_m.h))


def _jax_methods(jm, sigma, i, do):
    """energy, aux, delta_all, delta_one at i, and (sigma, aux, delta_all)
    after the flip of i where do, batched by vmap."""
    @jax.jit
    def run(s, ji, jdo):
        aux = jax.vmap(jm.init_aux)(s)
        out = dict(E=jax.vmap(jm.energy)(s), aux=aux,
                   d=jax.vmap(jm.delta_all)(s, aux),
                   d1=jax.vmap(jm.delta_one)(s, aux, ji))
        s2, aux2 = jax.vmap(jm.flip)(s, aux, ji, jdo)
        out.update(s2=s2, aux2=aux2, d2=jax.vmap(jm.delta_all)(s2, aux2))
        return out

    out = run(jnp.asarray(sigma), jnp.asarray(i), jnp.asarray(do))
    return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def _check_methods(jm, pm, seed, exact=False):
    """The model methods of pm against jm on B random composites, the
    flips masked on two chains. `exact`: every value EQUAL."""
    rng = np.random.default_rng(seed)
    sigma = random_sigma(rng, B, jm.N)
    i = rng.integers(0, jm.N, B)
    do = np.array([True, False, True, True, False, True])
    j = _jax_methods(jm, sigma, i, do)
    sig = torch.from_numpy(sigma.copy())
    aux = pm.init_aux(sig)
    scale = float(np.abs(j["E"]).max()) + jm.N
    close = (lambda a, b, s, w: np.testing.assert_array_equal(
        np.asarray(a, np.float64), np.asarray(b, np.float64), err_msg=w)) \
        if exact else _close
    close(pm.energy(sig).numpy(), j["E"], scale, "energy")
    for a, b in zip(_leaves(aux),
                    jax.tree.leaves(j["aux"])):
        if not a.dtype.is_floating_point:
            np.testing.assert_array_equal(a.numpy().reshape(-1),
                                          np.asarray(b).reshape(-1))
    d = pm.delta_all(sig, aux)
    close(d.numpy(), j["d"], 1.0, "delta_all")
    ti = torch.from_numpy(i)
    close(pm.delta_one(sig, aux, ti).numpy(), j["d1"], 1.0, "delta_one")
    sig2, aux2 = pm.flip(sig, aux, ti, torch.from_numpy(do))
    np.testing.assert_array_equal(sig2.numpy(), j["s2"])
    close(pm.delta_all(sig2, aux2).numpy(), j["d2"], 1.0, "after flip")
    for a, b in zip(_leaves(aux2), _leaves(pm.init_aux(sig2))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    return sig2


def _leaves(aux):
    if torch.is_tensor(aux):
        return [aux]
    out = []
    for a in aux:
        out += _leaves(a)
    return out


def test_replicated_offset_flip_one_chain():
    """With one chain and a centre block (offset 1), a flip changes exactly
    one spin and moves the energy by delta_one; the base aux follows. One
    chain makes the replica rows a view of the composite, which the base
    flips itself."""
    Nk, S = 16, 4
    rep = pt.Replicated(base=pt.GraphRRG(Nk, 3, seed=3, **CPU), N=Nk * S,
                        Nk=Nk, n_slots=S, offset=1)
    st = pt.init_state(rep, 1, seed=5, **CPU)
    sigma, aux = st.sigma, st.aux
    do = torch.tensor([True])
    for site in (19, 3, Nk * S - 1, Nk):
        before = sigma.clone()
        i = torch.tensor([site])
        d = rep.delta_one(sigma, aux, i)
        E0 = rep.energy(sigma)
        rep.flip(sigma, aux, i, do)
        changed = (sigma != before).nonzero()[:, 1].tolist()
        assert changed == [site], (site, changed)
        assert float(rep.energy(sigma) - E0) == float(d)
        assert torch.equal(aux, rep.init_aux(sigma))


def _replicated_pair(offset, n_slots=4):
    jb = rt.GraphRRG(NK, 3, (-1, 1), seed=4)
    kw = dict(N=NK * n_slots, Nk=NK, n_slots=n_slots, offset=offset)
    return (jrep.Replicated(base=jb, **kw),
            pt.Replicated(base=port_model(jb), **kw))


@pytest.mark.parametrize("offset", [1, 2])
def test_replicated_centre_blocks_match_jax(offset):
    """The Replicated centre-block paths, bit for bit: energy, aux,
    delta_all (zero on the centre blocks), delta_one, flip (centre spins
    included), replica_energies and neighbor_table."""
    jm, pm = _replicated_pair(offset)
    sig2 = _check_methods(jm, pm, 10 + offset, exact=True)
    np.testing.assert_array_equal(
        pm.replica_energies(sig2).numpy(),
        _np(jax.vmap(jm.replica_energies)(jnp.asarray(sig2.numpy()))))
    np.testing.assert_array_equal(pm.neighbor_table().numpy(),
                                  _np(jm.neighbor_table()))
    # every centre and replica site of one chain, one flip each
    sigma = random_sigma(np.random.default_rng(1), 1, jm.N)
    s = torch.from_numpy(sigma.copy())
    aux = pm.init_aux(s)
    js, jaux = jnp.asarray(sigma[0]), jm.init_aux(jnp.asarray(sigma[0]))
    jflip = jax.jit(jm.flip)
    for site in range(jm.N):
        pm.flip(s, aux, torch.tensor([site]), torch.tensor([True]))
        js, jaux = jflip(js, jaux, site, True)
    np.testing.assert_array_equal(s.numpy()[0], _np(js))
    np.testing.assert_array_equal(aux.numpy(), _np(jaux))


@pytest.mark.parametrize("M", [3, 4, 5])
def test_graph_le_tables(M):
    """GraphLE's neighbour and coupling tables, classes and scale equal the
    JAX package's; M <= 2 is refused."""
    g = 0.7 / 1.3
    jm, pm = rt.GraphLE(NK, M, g), pt.GraphLE(NK, M, g, **CPU)
    for key in ("neigh", "J", "h"):
        np.testing.assert_array_equal(getattr(pm, key).numpy(),
                                      _np(getattr(jm, key)))
    assert int(pm.offset) == int(jm.offset) and pm.K == jm.K
    assert pm.scale == jm.scale and pm.classes == jm.classes
    assert prep._le_classes(M, -g) == jrep._le_classes(M, -g)
    with pytest.raises(ValueError, match="greater than 2"):
        pt.GraphLE(NK, 2, g, **CPU)


#: (JAX wrapper, whether every value is exact)
WRAPPERS = {
    "LE RRG": (lambda: rt.GraphLocalEntropy(
        NK, 4, 0.4, 1.5, rt.GraphRRG(NK, 3, (-1, 1), seed=5)), False),
    "LE RRG gammaT=1": (lambda: rt.GraphLocalEntropy(
        NK, 3, 2.0, 2.0, rt.GraphRRG(NK, 3, (-1, 1), seed=6)), True),
    "TLE RRG": (lambda: rt.GraphTopologicalLocalEntropy(
        NK, 3, 0.5, 0.3, 1.2, rt.GraphRRG(NK, 3, (-1, 1), seed=7)), False),
    "TLE EA": (lambda: jal.GraphEATLE(3, 2, 4, 0.6, 0.2, 1.0, seed=8),
               False),
    "AddFields": (lambda: rt.GraphAddFields(
        np.linspace(-0.5, 0.5, NK), rt.GraphRRG(NK, 3, (-1, 1), seed=9)),
                  False),
    "AddSubFields": (lambda: rt.GraphAddSubFields(
        np.linspace(-0.7, 0.3, 9), rt.GraphEA(3, 2, (-1, 1), seed=9)),
                     False),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_methods_match_jax(name):
    """energy, aux, delta_all, delta_one and flip of LEModel, TLEModel,
    AddFields and AddSubFields, carried across through convert.py, against
    the JAX package; LE with gammaT = 1 EQUAL."""
    build, exact = WRAPPERS[name]
    jm = build()
    pm = port_wrapper(jm)
    assert type(pm).__name__ == type(jm).__name__ and pm.N == jm.N
    _check_methods(jm, pm, 3, exact=exact)
    if hasattr(jm, "M"):
        np.testing.assert_array_equal(pm.neighbor_table().numpy(),
                                      _np(jm.neighbor_table()))
        assert pm.delta_classes() == jm.delta_classes()


def test_graph_tle_inner_matches_jax():
    """GraphTLE alone: the aux-free delta_all, energy, neighbor_table (width
    max(1 + 2K, M + K + K M), sentinel N, the JAX column order) and
    delta_classes; the builder refuses a site in its own neighbourhood and
    a non-Pairwise base without neighb."""
    jm = rt.GraphTopologicalLocalEntropy(
        NK, 4, 0.5, 0.25, 1.0, rt.GraphRRG(NK, 4, (-1, 1), seed=2))
    pm = port_wrapper(jm)
    ji, pi = jm.inner_m, pm.inner_m
    np.testing.assert_array_equal(pi.neighb.numpy(), _np(ji.neighb))
    sigma = random_sigma(np.random.default_rng(4), B, jm.N)
    jE, jd = jax.jit(jax.vmap(lambda x: (ji.energy(x), ji.delta_all(x, ()))))(
        jnp.asarray(sigma))
    _close(pi.energy(torch.from_numpy(sigma)).numpy(), _np(jE), jm.N,
           "GraphTLE energy")
    _close(pi.delta_all(torch.from_numpy(sigma), ()).numpy(), _np(jd), 1.0,
           "GraphTLE delta_all")
    tab = pi.neighbor_table()
    K, M = pi.neighb.shape[1], pi.Mr
    assert tab.shape == (jm.N, max(1 + 2 * K, M + K + K * M))
    np.testing.assert_array_equal(tab.numpy(), _np(ji.neighbor_table()))
    assert pi.delta_classes() == ji.delta_classes()
    base = pt.GraphRRG(NK, 3, seed=1, **CPU)
    with pytest.raises(ValueError, match="contains itself"):
        pt.GraphTopologicalLocalEntropy(NK, 3, 0.5, 0.2, 1.0, base,
                                        neighb=[[0]] * NK)
    with pytest.raises(ValueError, match="neighb required"):
        pt.GraphTopologicalLocalEntropy(8, 3, 0.5, 0.2, 1.0,
                                        pt.GraphSK(8, seed=1, **CPU))


def test_tle_flip_costs_are_energy_differences():
    """GraphTLE's delta_all equals the brute-force energy difference of
    each flip (the 4-spin term's edges counted once)."""
    pm = pt.GraphTopologicalLocalEntropy(
        8, 3, 0.5, 0.3, 1.1, pt.GraphRRG(8, 3, seed=3, **CPU)).inner_m
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(2), 3,
                                          pm.N))
    E0 = pm.energy(sigma)
    flips = torch.ones(pm.N, pm.N, dtype=torch.int8) - 2 * torch.eye(
        pm.N, dtype=torch.int8)
    bf = torch.stack([pm.energy(sigma * flips[j]) - E0
                      for j in range(pm.N)], dim=1)
    torch.testing.assert_close(pm.delta_all(sigma, ()), bf, rtol=0,
                               atol=1e-5)


def test_le_observables_match_jax():
    """LEenergies, TLEenergies, center_config, cenergy and distances
    against the JAX package (integer bases: EQUAL)."""
    base = rt.GraphRRG(NK, 3, (-1, 1), seed=11)
    for jm in (rt.GraphLocalEntropy(NK, 3, 0.4, 2.0, base),
               rt.GraphTopologicalLocalEntropy(NK, 3, 0.4, 0.2, 2.0, base)):
        pm = port_wrapper(jm)
        sigma = random_sigma(np.random.default_rng(6), B, jm.N)
        s = torch.from_numpy(sigma)
        name = "LEenergies" if hasattr(jm, "LEenergies") else "TLEenergies"
        keys = (name, "cenergy", "distances", "center_config")
        jout = jax.jit(jax.vmap(lambda x: [getattr(jm, k)(x) for k in keys]))(
            jnp.asarray(sigma))
        for key, want in zip(keys, jout):
            np.testing.assert_array_equal(getattr(pm, key)(s).numpy(),
                                          _np(want), err_msg=key)
        d = pm.distances(s)
        assert d.dtype == torch.int32 and d.shape == (B, 3, 3)


@pytest.mark.parametrize("kind", ["Quant", "RE", "LE", "TLE"])
def test_reference_layouts_match_jax(kind):
    """reference_permutation equals the JAX package's for each wrapper, and
    to / from_reference_layout are inverse and agree with it on a batch."""
    jb = rt.GraphRRG(8, 3, (-1, 1), seed=1)
    pb = port_model(jb)
    j, p = {
        "Quant": (rt.GraphQuant(8, 4, 0.3, 1.0, jb),
                  pt.GraphQuant(8, 4, 0.3, 1.0, pb)),
        "RE": (rt.GraphRobustEnsemble(8, 3, 0.2, 1.0, jb),
               pt.GraphRobustEnsemble(8, 3, 0.2, 1.0, pb)),
        "LE": (rt.GraphLocalEntropy(8, 3, 0.2, 1.0, jb),
               pt.GraphLocalEntropy(8, 3, 0.2, 1.0, pb)),
        "TLE": (rt.GraphTopologicalLocalEntropy(8, 3, 0.2, 0.1, 1.0, jb),
                pt.GraphTopologicalLocalEntropy(8, 3, 0.2, 0.1, 1.0, pb)),
    }[kind]
    perm = prep.reference_permutation(p)
    np.testing.assert_array_equal(perm, jrep.reference_permutation(j))
    sigma = random_sigma(np.random.default_rng(3), B, p.N)
    ref = prep.to_reference_layout(p, torch.from_numpy(sigma))
    for b in range(B):
        np.testing.assert_array_equal(
            ref[b].numpy(), _np(jrep.to_reference_layout(j, sigma[b])))
        np.testing.assert_array_equal(
            prep.from_reference_layout(p, ref[b]).numpy(),
            _np(jrep.from_reference_layout(j, ref[b].numpy())))
    assert torch.equal(prep.from_reference_layout(p, ref),
                       torch.from_numpy(sigma))
    with pytest.raises(TypeError):
        prep.reference_permutation(pt.GraphRRG(8, 3, seed=1, **CPU))


#: (JAX builder, port builder) of the aliases of this slice, one seed
ALIASES = {
    "Graph0LE": (lambda: jal.Graph0LE(10, 3, 0.5, 2.0),
                 lambda: pt.Graph0LE(10, 3, 0.5, 2.0, **CPU)),
    "GraphSKLE": (lambda: jal.GraphSKLE(10, 3, 0.5, 2.0, seed=22),
                  lambda: pt.GraphSKLE(10, 3, 0.5, 2.0, seed=22, **CPU)),
    "GraphEALE": (lambda: jal.GraphEALE(3, 2, 4, 0.5, 2.0, seed=3),
                  lambda: pt.GraphEALE(3, 2, 4, 0.5, 2.0, seed=3, **CPU)),
    "Graph0TLE": (lambda: jal.Graph0TLE(10, 3, 0.5, 0.3, 2.0),
                  lambda: pt.Graph0TLE(10, 3, 0.5, 0.3, 2.0, **CPU)),
    "GraphSKTLE": (lambda: jal.GraphSKTLE(6, 3, 0.5, 0.3, 2.0, seed=4),
                   lambda: pt.GraphSKTLE(6, 3, 0.5, 0.3, 2.0, seed=4,
                                         **CPU)),
    "GraphEATLE": (lambda: jal.GraphEATLE(3, 2, 3, 0.5, 0.3, 2.0, seed=5),
                   lambda: pt.GraphEATLE(3, 2, 3, 0.5, 0.3, 2.0, seed=5,
                                         **CPU)),
    "GraphSATRE": (lambda: rt.GraphSATRE(12, 3, 2.0, 3, 0.5, 1.0, seed=6),
                   lambda: pt.GraphSATRE(12, 3, 2.0, 3, 0.5, 1.0, seed=6,
                                         **CPU)),
    "GraphSATLE": (lambda: rt.GraphSATLE(12, 3, 2.0, 3, 0.5, 1.0, seed=6),
                   lambda: pt.GraphSATLE(12, 3, 2.0, 3, 0.5, 1.0, seed=6,
                                         **CPU)),
    "GraphSATTLE": (lambda: rt.GraphSATTLE(12, 3, 2.0, 3, 0.5, 0.2, 1.0,
                                           seed=6),
                    lambda: pt.GraphSATTLE(12, 3, 2.0, 3, 0.5, 0.2, 1.0,
                                           seed=6, **CPU)),
    "GraphPercStepLE": (lambda: rt.GraphPercStepLE(9, 5, 3, 0.5, 1.0,
                                                   seed=7),
                        lambda: pt.GraphPercStepLE(9, 5, 3, 0.5, 1.0,
                                                   seed=7, **CPU)),
    "GraphPercLinearLE": (lambda: rt.GraphPercLinearLE(9, 5, 3, 0.5, 1.0,
                                                       seed=7),
                          lambda: pt.GraphPercLinearLE(9, 5, 3, 0.5, 1.0,
                                                       seed=7, **CPU)),
}


def _tensor_fields(m):
    return {k: v for k, v in vars(m).items()
            if torch.is_tensor(v) or isinstance(v, jnp.ndarray)}


@pytest.mark.parametrize("name", list(ALIASES))
def test_aliases_draw_the_same_tables(name):
    """Every LE / TLE / SAT / perceptron alias of this slice builds the JAX
    package's base and wrapper tables from the same seed (float tables
    within float32 rounding), and its energies agree."""
    jm, pm = ALIASES[name][0](), ALIASES[name][1]()
    assert type(pm).__name__ == type(jm).__name__ and pm.N == jm.N
    assert pm.M == jm.M and pm.Nk == jm.Nk
    for jp, pp in ((jm.resid_m.base, pm.resid_m.base),
                   (jm.inner_m, pm.inner_m)):
        assert type(pp).__name__ == type(jp).__name__
        jt, ptab = _tensor_fields(jp), _tensor_fields(pp)
        assert set(jt) == set(ptab), (set(jt), set(ptab))
        for key in jt:
            a, b = ptab[key].numpy(), _np(jt[key])
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(a, b.astype(a.dtype),
                                              err_msg=key)
        assert pp.scale == jp.scale
    sigma = random_sigma(np.random.default_rng(8), B, jm.N)
    jE = _np(jax.jit(jax.vmap(jm.energy))(jnp.asarray(sigma)))
    _close(pm.energy(torch.from_numpy(sigma)).numpy(), jE,
           float(np.abs(jE).max()) + jm.N, "energy")


@pytest.mark.parametrize("kind", ["LE", "TLE"])
def test_composite_masks_match_jax(kind):
    """sweepMC's masks for LE and TLE over a sparse base: one per (slot,
    colour) over all n_slots, the centre slot included, in the order
    s * ncol + c, as the JAX array; None over a dense base. LE and TLE never
    take a race kernel (no family), and sweepMC runs them on the mask
    route with an exact-to-float32 energy."""
    jb = rt.GraphRRG(20, 3, (-1, 1), seed=12)
    jm = (rt.GraphLocalEntropy(20, 3, 0.5, 1.0, jb) if kind == "LE" else
          rt.GraphTopologicalLocalEntropy(20, 3, 0.5, 0.3, 1.0, jb))
    pm = port_wrapper(jm)
    masks = composite_masks(pm)
    np.testing.assert_array_equal(masks.numpy(), _np(jax_composite_masks(jm)))
    assert masks.shape[0] % (jm.M + 1) == 0
    assert family_of(pm) is None
    with pytest.raises(NotImplementedError, match="not eligible"):
        pt.bklMC(pm, 1.0, 10, chains=2, backend="kernel", **CPU)
    Es, st = pt.sweepMC(pm, 1.0, 4, step=2, chains=4, seed=3, **CPU)
    assert pt.LAST_ROUTE == {"backend": "torch", "impl": "torch",
                             "n_masks": masks.shape[0]}
    assert Es.shape == (4, 2) and torch.equal(Es[:, -1], st.E)
    E_re = pm.energy(st.sigma)
    assert float((E_re - st.E).abs().max()) <= 1e-4 * max(
        1.0, float(E_re.abs().max()))
    dense = pt.GraphSKLE(8, 3, 0.5, 1.0, seed=1, **CPU)
    assert composite_masks(dense) is None
    with pytest.raises(NotImplementedError, match="requires a Pairwise"):
        pt.sweepMC(dense, 1.0, 1, chains=2, **CPU)
    with pytest.raises(NotImplementedError, match="no sweep kernel"):
        pt.sweepMC(pm, 1.0, 1, chains=2, backend="kernel", **CPU)


def test_converters_match_builders():
    """replica_from_arrays kinds "le", "tle", "af" and "addsub" give the
    builders' tables; unknown kinds and a malformed neighb are refused."""
    base = pt.GraphRRG(NK, 3, seed=2, **CPU)
    h = np.linspace(-1, 1, NK)
    pairs = (
        (pt.replica_from_arrays("le", base, M=3, coupling=0.5, beta=2.0),
         pt.GraphLocalEntropy(NK, 3, 0.5, 2.0, base)),
        (pt.replica_from_arrays("tle", base, M=3, coupling=0.5, lambda_=0.2,
                                beta=2.0, neighb=base.neigh.numpy()),
         pt.GraphTopologicalLocalEntropy(NK, 3, 0.5, 0.2, 2.0, base)),
        (pt.replica_from_arrays("af", base, fields=h),
         pt.GraphAddFields(h, base)),
        (pt.replica_from_arrays("addsub", base, fields=h),
         pt.GraphAddSubFields(h, base)))
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(1), B,
                                          pairs[0][0].N))
    for a, b in pairs:
        s = sigma[:, : a.N]
        assert type(a) is type(b)
        assert torch.equal(a.energy(s), b.energy(s))
        assert torch.equal(a.delta_all(s, a.init_aux(s)),
                           b.delta_all(s, b.init_aux(s)))
    with pytest.raises(ValueError, match="kind"):
        pt.replica_from_arrays("xx", base, M=3, coupling=1.0, beta=1.0)
    with pytest.raises(ValueError, match="neighb"):
        pt.replica_from_arrays("tle", base, M=3, coupling=1.0, lambda_=1.0,
                               beta=1.0, neighb=np.zeros(3))
    with pytest.raises(ValueError, match="incompatible length"):
        pt.GraphAddFields(h[:-1], base)


def _boltzmann_mean_energy(pm, beta):
    n = pm.N
    states = ((torch.arange(2 ** n)[:, None] >> torch.arange(n)) & 1)
    E = pm.to_physical(pm.energy((2 * states - 1).to(torch.int8)))
    E = E.double().numpy()
    w = np.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


def test_le_standard_stationarity():
    """standardMC on GraphSKLE(3, 3) (12 spins) samples the exact Boltzmann
    mean energy, within the JAX test's 0.06 (tests/test_replicas.py)."""
    model = pt.GraphSKLE(3, 3, 0.5, 2.0, seed=22, **CPU)
    beta = 2.0
    E_exact = _boltzmann_mean_energy(model, beta)
    Es, _ = pt.standardMC(model, beta, 6000, step=20, chains=512, seed=3,
                          **CPU)
    err = abs(float(Es[:, 100:].double().mean()) - E_exact)
    assert err < 0.06, (float(Es[:, 100:].double().mean()), E_exact)


def test_le_wtm_stationarity():
    """wtmMC (the generic path) on an LE wrapper, GraphSKLE(3, 3) at
    beta = 1.5: the time-averaged energy within max(5 SEM, 0.05) of the
    exact Boltzmann mean, the JAX wrapper test's bound."""
    model = pt.GraphSKLE(3, 3, 0.4, 1.5, seed=23, **CPU)
    beta = 1.5
    E_exact = _boltzmann_mean_energy(model, beta)
    Es, _ = pt.wtmMC(model, beta, 400, step=20.0, chains=64, seed=9, **CPU)
    Es = Es[:, 100:].double().numpy()
    err = abs(Es.mean() - E_exact)
    sem = Es.std() / np.sqrt(Es.shape[0] * 3.0)
    assert err < max(5 * sem, 0.05), (err, sem, E_exact)


def test_le_rrr_double_invariant():
    """rrrMC on an LE and an AddFields Double takes the generic path, which
    samples the inner part exactly (inner_view, residual_delta_one), and
    keeps E == energy(sigma) within float32 accumulation; one chain too
    (the replica rows are then a view of the composite)."""
    base = pt.GraphRRG(NK, 3, seed=5, **CPU)
    for m in (pt.GraphLocalEntropy(NK, 4, 0.5, 1.0, base),
              pt.GraphAddFields(np.linspace(-1, 1, NK), base)):
        for chains in (1, 4):
            Es, st = pt.rrrMC(m, 1.0, 300, step=100, chains=chains, seed=4,
                              **CPU)
            assert pt.LAST_ROUTE["backend"] == "torch"
            E_re = m.energy(st.sigma)
            assert float((E_re - st.E).abs().max()) <= 1e-4 * max(
                1.0, float(E_re.abs().max()))
            assert int(st.accepted.sum()) > 0
