"""The generic torch paths of bklMC, wtmMC and rrrMC (rrrmc_tpu_torch/
samplers/{bkl,wtm,rrr}.py) against the JAX package's generic moves.

(a) Trajectories: the port's moves are fed the uniforms that the JAX moves
    (`make_bkl_move`, `make_wtm_move`, `make_rrr_step`) draw from their
    keys, for 200 moves on integer-coupling models: sites, skips, spins and
    energies are equal; wtm's float64 firing times agree to rtol 1e-12 (the
    last-bit differences of XLA's and torch's exp and log1p).
(b) Laws on the small zoo of tests/test_samplers.py, generic route: the
    energy invariant, total-variation stationarity of rrr (the Double path
    included), bkl and wtm mean energies, cross-sampler agreement and bkl's
    checkpoint semantics.
(c) Hooks that stop a run early; (d) observer snapshots whose energies
    equal the energy series.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu.samplers import bkl as jbkl
from rrrmc_tpu.samplers import rrr as jrrr
from rrrmc_tpu.samplers import wtm as jwtm
from rrrmc_tpu_torch.experiments import config_series_observer
from rrrmc_tpu_torch.observables import pack_config, unpack_config
from rrrmc_tpu_torch.samplers import bkl as pbkl
from rrrmc_tpu_torch.samplers import rrr as prrr
from rrrmc_tpu_torch.samplers import wtm as pwtm

from torch_port_helpers import CPU, port_lattice, port_model

torch.set_num_threads(1)

MOVES, B, BETA = 200, 8, 1.0

GRAPHS = {
    "RRG": (lambda: rt.GraphRRG(16, 3, (-1, 1), seed=31), port_model),
    "EA2D": (lambda: rt.GraphEA(3, 2, (-1, 1), seed=32), port_lattice),
}


def _instance(name):
    build, port = GRAPHS[name]
    jm = build()
    pm = port(jm)
    st = rt.init_state(jm, B, 7)
    return jm, pm, st


def _split_uniforms(keys, dtypes):
    """Per chain: the next key and one uniform for each further subkey of
    split(key, 1 + len(dtypes)), as the JAX moves draw them."""
    def one(k):
        ks = jax.random.split(k, 1 + len(dtypes))
        return (ks[0],) + tuple(jax.random.uniform(s, (), d)
                                for s, d in zip(ks[1:], dtypes))
    return jax.vmap(one)(keys)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flipped_site(s0, s1):
    """The site each chain flipped between two spin arrays (-1: none)."""
    d = np.asarray(s0) != np.asarray(s1)
    return np.where(d.any(1), d.argmax(1), -1)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_bkl_trajectory_matches_jax(graph):
    jm, pm, st = _instance(graph)
    iters = 10 ** 7
    jmove = jax.jit(jax.vmap(jbkl.make_bkl_move(jm, BETA, iters)))
    pmove = pbkl.make_bkl_move(pm, BETA, iters)
    sigma = _t(st.sigma)
    aux = pm.init_aux(sigma)
    E = pm.energy(sigma)
    acc = torch.zeros(B, dtype=torch.int32)
    it = torch.zeros(B, dtype=torch.int64)
    js = (st.sigma, st.aux, st.E, st.key, st.accepted,
          jnp.zeros(B, jnp.int64))
    for _ in range(MOVES):
        _, u_skip, u_mv = _split_uniforms(js[3], (jnp.float64, jnp.float64))
        s_before = js[0]
        js = jmove(*js)
        i, skip = pmove(sigma, aux, E, acc, it, _t(u_skip), _t(u_mv))
        np.testing.assert_array_equal(i.numpy(),
                                      _flipped_site(s_before, js[0]))
        np.testing.assert_array_equal(it.numpy(), np.asarray(js[5]))
        np.testing.assert_array_equal(sigma.numpy(), np.asarray(js[0]))
        np.testing.assert_array_equal(E.numpy(), np.asarray(js[2]))
    assert int(skip.max()) >= 0 and int(it.min()) > MOVES
    assert torch.equal(pm.energy(sigma), E)
    assert torch.equal(pm.init_aux(sigma), aux)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_wtm_trajectory_matches_jax(graph):
    jm, pm, st = _instance(graph)
    tmax = 1e9
    table = pwtm.redraw_table(pm)
    np.testing.assert_array_equal(table[:, 1:].numpy(),
                                  np.asarray(jm.neighbor_table()))
    jmove = jax.jit(jax.vmap(jwtm.make_wtm_move(jm, BETA, tmax)))
    pmove = pwtm.make_wtm_move(pm, BETA, tmax)
    # the initial clocks: the JAX sampler's uniforms, drawn from fold_in
    kt = jax.vmap(lambda k: jax.random.fold_in(k, 0x77777))(st.key)
    u0 = jax.vmap(lambda k: jax.random.uniform(k, (jm.N,), jnp.float64))(kt)
    jtimes = jax.jit(jax.vmap(lambda k, s, a: jwtm.draw_times(
        k, jm, s, a, BETA, jnp.zeros((), jnp.float64))))(kt, st.sigma,
                                                        st.aux)
    sigma = _t(st.sigma)
    aux = pm.init_aux(sigma)
    E = pm.energy(sigma)
    acc = torch.zeros(B, dtype=torch.int32)
    t = torch.zeros(B, dtype=torch.float64)
    times = torch.full((B, pm.N + 1), float("inf"), dtype=torch.float64)
    times[:, :pm.N] = pwtm.draw_times(_t(u0), pm, sigma, aux, BETA, t)
    np.testing.assert_allclose(times[:, :pm.N].numpy(), np.asarray(jtimes),
                               rtol=1e-12)
    js = (st.sigma, st.aux, st.E, st.key, st.accepted,
          jnp.zeros(B, jnp.float64), jtimes)
    K1 = table.shape[1]
    for _ in range(MOVES):
        _, kr = jax.vmap(jax.random.split, out_axes=1)(js[3])
        u = jax.vmap(lambda k: jax.random.uniform(k, (K1,), jnp.float64))(kr)
        i_jax = np.asarray(jnp.argmin(js[6], axis=1))
        js = jmove(*js)
        i = pmove(sigma, aux, E, acc, t, times, _t(u))
        np.testing.assert_array_equal(i.numpy(), i_jax)
        np.testing.assert_array_equal(sigma.numpy(), np.asarray(js[0]))
        np.testing.assert_array_equal(E.numpy(), np.asarray(js[2]))
        np.testing.assert_allclose(t.numpy(), np.asarray(js[5]), rtol=1e-12)
        np.testing.assert_allclose(times[:, :pm.N].numpy(),
                                   np.asarray(js[6]), rtol=1e-12)
    assert torch.equal(pm.energy(sigma), E)
    assert bool((times[:, :pm.N].min(1).values >= t).all())


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_rrr_trajectory_matches_jax(graph):
    jm, pm, st = _instance(graph)
    jmove = jax.jit(jax.vmap(jrrr.make_rrr_step(jm, BETA)))
    pmove = prrr.make_rrr_move(pm, BETA)
    sigma = _t(st.sigma)
    aux = pm.init_aux(sigma)
    E = pm.energy(sigma)
    acc = torch.zeros(B, dtype=torch.int32)
    js = (st.sigma, st.aux, st.E, st.key, st.accepted)
    rejected = 0
    for _ in range(MOVES):
        _, u_mv, u_acc = _split_uniforms(js[3], (jnp.float64, jnp.float32))
        js = jmove(*js)
        i, a = pmove(sigma, aux, E, acc, _t(u_mv), _t(u_acc))
        rejected += int((~a).sum())
        np.testing.assert_array_equal(sigma.numpy(), np.asarray(js[0]))
        np.testing.assert_array_equal(E.numpy(), np.asarray(js[2]))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(js[4]))
    assert rejected > 0                  # the reject branch was exercised
    assert torch.equal(pm.init_aux(sigma), aux)


# --- (b) laws on the small zoo, generic route ------------------------------

def small_zoo():
    return {
        "EA2D": pt.GraphEA(3, 2, (-1, 1), seed=21, **CPU),
        "RRG": pt.GraphRRG(8, 3, (-1, 1), seed=22, **CPU),
        "RRGNormal": pt.GraphRRGNormal(8, 3, seed=23, **CPU),
        "RRGNormalDiscr": pt.GraphRRGNormalDiscretized(8, 3, (-1.0, 1.0),
                                                       seed=24, **CPU),
        "Ising1D": pt.GraphIsing1D(8, **CPU),
        "Fields": pt.GraphFields(6, (0.5, 1.5), seed=25, **CPU),
    }


SMALL = small_zoo()
LAW_BETA = 2.0


def boltzmann(model, beta):
    """Exact 2^N distribution and mean energy."""
    ids = torch.arange(2 ** model.N, dtype=torch.int64)
    E = model.to_physical(model.energy(unpack_config(ids, model.N)))
    E = E.double().numpy()
    w = np.exp(-beta * (E - E.min()))
    p = w / w.sum()
    return p, float((p * E).sum())


def _run(name, model, beta, n, **kw):
    kw = dict(kw, backend="torch", **CPU)
    if name == "wtm":
        return pt.wtmMC(model, beta, n, **kw)
    return {"rrr": pt.rrrMC, "bkl": pt.bklMC}[name](model, beta, n, **kw)


def _energy_err(model, st):
    return float((model.energy(st.sigma).double()
                  - st.E.double()).abs().max())


@pytest.mark.parametrize("sampler", ["rrr", "bkl", "wtm"])
@pytest.mark.parametrize("graph", list(SMALL))
def test_energy_invariant(sampler, graph):
    """The running energy equals energy(sigma) after the run: exactly on
    integer couplings, to float32 rounding (1e-5 per spin) on float ones
    and on the Double's physical float32 E."""
    model = SMALL[graph]
    n, step = (20, 5.0) if sampler == "wtm" else (1500, 100)
    Es, st = _run(sampler, model, LAW_BETA, n, step=step, chains=8, seed=5)
    assert pt.LAST_ROUTE["backend"] == "torch"
    assert bool(torch.isfinite(Es).all()) and Es.shape[0] == 8
    if st.E.dtype.is_floating_point:
        assert _energy_err(model, st) <= 1e-5 * model.N
    else:
        assert torch.equal(model.energy(st.sigma), st.E)
    assert int(st.accepted.min()) > 0


def _pack(model, sigma, aux, E):
    return pack_config(sigma)


@pytest.mark.parametrize("graph", ["EA2D", "RRGNormal", "RRGNormalDiscr"])
def test_rrr_stationarity_exact(graph):
    """The empirical state distribution of generic rrr (the DoubleGraph
    law on RRGNormalDiscr: z/z' times the residual's Metropolis factor)
    against the exact Boltzmann law: total variation below 0.08, as in
    tests/test_samplers.py."""
    model = SMALL[graph]
    p_exact, _ = boltzmann(model, LAW_BETA)
    chains, iters = (128, 12_000) if graph == "RRGNormal" else (64, 6_000)
    Es, _ = _run("rrr", model, LAW_BETA, iters, step=25, chains=chains,
                 seed=11, observer=_pack)
    samples = Es[:, Es.shape[1] // 2:].numpy().astype(np.int64).ravel()
    p_emp = np.bincount(samples, minlength=2 ** model.N) / samples.size
    tv = 0.5 * np.abs(p_emp - p_exact).sum()
    assert tv < 0.08, f"total variation {tv:.4f}"


@pytest.mark.parametrize("sampler,graph", [
    ("bkl", "RRG"), ("bkl", "RRGNormalDiscr"), ("wtm", "EA2D"),
    ("wtm", "RRGNormal")])
def test_mean_energy_matches_boltzmann(sampler, graph):
    """bkl's and wtm's time-averaged energy over the second half against
    the exact mean, within max(5 standard errors, 0.05)."""
    model = SMALL[graph]
    _, E_exact = boltzmann(model, LAW_BETA)
    if sampler == "bkl":
        Es, _ = _run("bkl", model, LAW_BETA, 12_000, step=25, chains=64,
                     seed=11)
    else:
        Es, _ = _run("wtm", model, LAW_BETA, 400, step=20.0, chains=64,
                     seed=13)
    Es = Es[:, Es.shape[1] // 2:].double().numpy()
    err = abs(Es.mean() - E_exact)
    sem = Es.std() / np.sqrt(Es.shape[0] * 3.0)
    assert err < max(5 * sem, 0.05), (err, sem, E_exact)


def test_cross_sampler_energy_agreement():
    """standardMC and the three generic samplers agree on <E> of
    RRGNormal with the exact mean within 0.1 (tests/test_samplers.py)."""
    model = SMALL["RRGNormal"]
    _, E_exact = boltzmann(model, LAW_BETA)
    means = {}
    Es, _ = pt.standardMC(model, LAW_BETA, 8_000, step=20, chains=48, seed=3,
                          backend="torch", **CPU)
    means["standard"] = Es[:, 200:].double().mean()
    Es, _ = _run("rrr", model, LAW_BETA, 4_000, step=20, chains=48, seed=4)
    means["rrr"] = Es[:, 100:].double().mean()
    Es, _ = _run("bkl", model, LAW_BETA, 8_000, step=20, chains=48, seed=5)
    means["bkl"] = Es[:, 200:].double().mean()
    Es, _ = _run("wtm", model, LAW_BETA, 300, step=10.0, chains=48, seed=6)
    means["wtm"] = Es[:, 75:].double().mean()
    for k, v in means.items():
        assert abs(float(v) - E_exact) < 0.1, (k, v, E_exact, means)


def test_bkl_checkpoint_semantics():
    """At beta=6 EA2D freezes near its ground state: the series holds long
    constant stretches (checkpoints passed by one move take its pre-move
    energy), and the generic series equals the one filled from the same
    streams by the JAX package's _fill_checkpoints."""
    model = SMALL["EA2D"]
    Es, st = _run("bkl", model, 6.0, 50_000, step=100, chains=4, seed=2)
    assert Es.shape == (4, 500) and bool(torch.isfinite(Es).all())
    tail = Es[:, -50:].double()
    assert bool(((tail - tail.mean(1, keepdim=True)).abs() < 4.001).all())
    # several checkpoints passed by single moves
    runs = (Es[:, 1:] == Es[:, :-1]).double().mean()
    assert float(runs) > 0.5


@pytest.mark.parametrize("trail", [(), (5,), (3, 2)])
def test_fill_checkpoints_matches_jax(trail):
    """fill_checkpoints on observables with trailing dimensions, a
    coordinate that passes several checkpoints in one move, and chains that
    reach none: equal to the JAX package's _fill_checkpoints."""
    rng = np.random.default_rng(8)
    Bc, chunk, K, step = 6, 12, 9, 7
    x0 = rng.integers(0, 20, Bc)
    xs = x0[None] + np.cumsum(rng.integers(0, 15, (chunk, Bc)), axis=0)
    xs[:, 0] = x0[0]                       # a chain that does not move
    os_ = rng.normal(size=(chunk, Bc) + trail)
    o0 = rng.normal(size=(Bc,) + trail)
    S = rng.normal(size=(Bc, K) + trail)
    want = jbkl._fill_checkpoints(jnp.asarray(S), step, jnp.asarray(x0),
                                  jnp.asarray(o0), jnp.asarray(xs),
                                  jnp.asarray(os_))
    got = pbkl.fill_checkpoints(_t(S), step, _t(x0), _t(o0), _t(xs),
                                _t(os_))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- (c) hooks, (d) observers ---------------------------------------------

@pytest.mark.parametrize("sampler", ["bkl", "wtm", "rrr"])
def test_hook_stops_early(sampler):
    """A hook returning False stops the run, and the state is the one the
    hook saw: rrr returns the checkpoints collected so far (standardMC's
    protocol), bkl and wtm their whole series with the later checkpoints
    0."""
    m = pt.GraphRRG(16, 3, seed=5, **CPU)
    seen = []

    def hook(x, model, state):
        seen.append((x, state.E.clone()))
        return len(seen) < 2

    if sampler == "rrr":
        Es, st = _run("rrr", m, 1.0, 1000, step=10, chains=4, seed=1,
                      hook=hook, hook_every=20)
        assert [x for x, _ in seen] == [200, 400] and Es.shape == (4, 40)
        assert bool((Es != 0).all())
    elif sampler == "bkl":
        Es, st = _run("bkl", m, 1.0, 10 ** 6, step=1000, chains=4, seed=1,
                      hook=hook, chunk_moves=32)
        assert Es.shape == (4, 1000) and bool((Es[:, -1] == 0).all())
        assert 0 < seen[0][0] < seen[1][0] < 10 ** 6
    else:
        Es, st = _run("wtm", m, 1.0, 1000, step=1.0, chains=4, seed=1,
                      hook=hook, chunk_moves=32)
        assert Es.shape == (4, 1000) and bool((Es[:, -1] == 0).all())
        assert 0.0 < seen[0][0] < seen[1][0] < 1000 / m.N
    assert len(seen) == 2
    assert torch.equal(st.E, seen[-1][1])
    assert torch.equal(m.energy(st.sigma), st.E)


@pytest.mark.parametrize("sampler,n,step", [("bkl", 64, 4), ("wtm", 24, 2.0),
                                            ("rrr", 64, 4)])
def test_observer_snapshots_consistent_with_energies(sampler, n, step):
    """One seed, with and without the snapshot observer: the same
    trajectory, and each snapshot's energy equals the energy series
    (tests/test_overlaps.py's check)."""
    X = pt.GraphRRG(32, 3, (-1, 1), seed=3, **CPU)
    kw = dict(step=step, chains=4, seed=11)
    Es, st1 = _run(sampler, X, 1.5, n, **kw)
    snaps, st2 = _run(sampler, X, 1.5, n, observer=config_series_observer(),
                      **kw)
    assert snaps.shape == Es.shape + (X.N,) and snaps.dtype == torch.int8
    filled = (snaps != 0).any(-1)
    assert bool(filled[:, :-1].all())
    E_snap = X.to_physical(X.energy(snaps.reshape(-1, X.N))).reshape(
        Es.shape)
    assert torch.equal(E_snap[filled], Es[filled])
    assert torch.equal(st1.sigma, st2.sigma)


def test_snapshot_chunks_are_cut_to_memory(monkeypatch):
    """A snapshot stream over the STREAM_BYTES budget runs in shorter
    chunks with the same checkpoints as one long chunk."""
    X = pt.GraphRRG(32, 3, (-1, 1), seed=3, **CPU)
    kw = dict(step=50, chains=4, seed=11, observer=config_series_observer())
    full, _ = _run("bkl", X, 1.0, 4000, **kw)
    monkeypatch.setattr(pbkl, "STREAM_BYTES", 7 * 4 * (X.N + 8))
    cut, _ = _run("bkl", X, 1.0, 4000, **kw)
    assert torch.equal(full, cut)


def test_standardmc_float_series_is_not_aliased():
    """standardMC's torch route records each checkpoint's value, not the
    live float E that later moves update in place."""
    m = pt.GraphRRGNormal(16, 3, seed=2, **CPU)
    Es, st = pt.standardMC(m, 1.0, 400, step=20, chains=4, backend="torch",
                           **CPU)
    assert len(torch.unique(Es[0])) > 1
    assert torch.equal(Es[:, -1], m.to_physical(st.E))


@pytest.mark.parametrize("sampler", ["bkl", "rrr"])
def test_auto_refuses_iters_past_the_kernel(sampler):
    """backend "auto" raises, as "kernel" does, for an eligible call with
    no hook or observer whose iters pass MAX_ITERS, rather than moving it
    to the generic path; calls with a hook or an observer, ineligible
    models and backend "torch" still take the generic path."""
    m = pt.GraphRRG(16, 3, seed=5, **CPU)
    run = {"bkl": pt.bklMC, "rrr": pt.rrrMC}[sampler]
    name = {"bkl": "bklMC", "rrr": "rrrMC"}[sampler]
    over = pbkl.MAX_ITERS + 1
    for backend in ("auto", "kernel"):
        with pytest.raises(ValueError, match="iters must be <="):
            run(m, 1.0, over, step=over, chains=2, backend=backend, **CPU)
    assert pbkl.kernel_route(name, m, backend="auto", hook=None,
                             observer=None, iters=pbkl.MAX_ITERS)
    for kw in (dict(hook=lambda *a: True, observer=None),
               dict(hook=None, observer=config_series_observer())):
        assert not pbkl.kernel_route(name, m, backend="auto", iters=over,
                                     **kw)
    assert not pbkl.kernel_route(name, m, backend="torch", hook=None,
                                 observer=None, iters=over)
    d = pt.GraphRRGNormalDiscretized(16, 3, (-1, 1), seed=5, **CPU)
    assert pbkl.family_of(d) is None
    assert not pbkl.kernel_route(name, d, backend="auto", hook=None,
                                 observer=None, iters=over)
