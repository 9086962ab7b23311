"""The port's main path as a whole: standardMC (both backends), rrrMC,
bklMC and wtmMC through rrrmc_tpu_torch's public API, on a model and
starting spins carried over from the JAX package, held against the JAX
samplers run on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt

from torch_port_helpers import CPU, port_model, random_sigma

torch.set_num_threads(1)

N, BETA = 48, 1.0
CHAINS, JAX_CHAINS = 128, 64

#: (JAX call, port call) per sampler, from the same starting spins C0
RUNS = {
    "standard-torch": (
        lambda jm, C0: rt.standardMC(jm, BETA, 20_000, step=1000,
                                     chains=JAX_CHAINS, seed=4, C0=C0),
        lambda pm, C0: pt.standardMC(pm, BETA, 20_000, step=1000,
                                     chains=CHAINS, seed=4, C0=C0,
                                     backend="torch", **CPU)),
    "standard-kernel": (
        lambda jm, C0: rt.standardMC(jm, BETA, 20_000, step=1000,
                                     chains=JAX_CHAINS, seed=4, C0=C0),
        lambda pm, C0: pt.standardMC(pm, BETA, 20_000, step=1000,
                                     chains=CHAINS, seed=4, C0=C0,
                                     backend="kernel", **CPU)),
    "rrr": (
        lambda jm, C0: rt.rrrMC(jm, BETA, 4096, step=256, chains=JAX_CHAINS,
                                seed=4, C0=C0),
        lambda pm, C0: pt.rrrMC(pm, BETA, 4096, step=256, chains=CHAINS,
                                seed=4, C0=C0, **CPU)),
    "bkl": (
        lambda jm, C0: rt.bklMC(jm, BETA, 20_000, step=1000,
                                chains=JAX_CHAINS, seed=4, C0=C0),
        lambda pm, C0: pt.bklMC(pm, BETA, 20_000, step=1000, chains=CHAINS,
                                seed=4, C0=C0, **CPU)),
    "wtm": (
        lambda jm, C0: rt.wtmMC(jm, BETA, 20, step=1000.0, chains=JAX_CHAINS,
                                seed=4, C0=C0),
        lambda pm, C0: pt.wtmMC(pm, BETA, 20, step=1000.0, chains=CHAINS,
                                seed=4, C0=C0, **CPU)),
}
ROUTES = {"standard-torch": "torch", "standard-kernel": "kernel-site",
          "rrr": "kernel-rejfree-sparse", "bkl": "kernel-rejfree-sparse",
          "wtm": "kernel-rejfree-sparse"}


@pytest.fixture(scope="module")
def instance():
    jm = rt.GraphRRG(N, 3, (-1, 1), seed=11)
    C0 = random_sigma(np.random.default_rng(0), CHAINS, N)
    return jm, port_model(jm), C0, {}


def _second_half_mean(Es):
    """Mean E/N over the second half of the checkpoints, and its standard
    error from the spread of the per-chain means."""
    h = np.asarray(Es, np.float64)
    h = h[:, h.shape[1] // 2:].mean(axis=1) / N
    return h.mean(), h.std() / np.sqrt(len(h))


@pytest.mark.parametrize("name", list(RUNS))
def test_sampler_matches_jax(instance, name):
    """Exact running energy, shapes and route; and the equilibrium E/N of
    the port agrees with the JAX sampler's within max(5 sigma, 0.02 per
    spin), sigma the combined standard error of the two chain-mean
    estimates. The floor covers standardMC's kernel route, whose shared
    site schedule correlates the chains so that their spread understates
    the error."""
    jm, pm, C0, jax_cache = instance
    run_jax, run_port = RUNS[name]
    key = name.split("-")[0]
    if key not in jax_cache:
        Ej, _ = run_jax(jm, C0[:JAX_CHAINS])
        jax_cache[key] = _second_half_mean(Ej)
    Es, st = run_port(pm, C0)
    assert pt.LAST_ROUTE["backend"] == ROUTES[name]
    if name != "standard-torch":
        assert pt.LAST_ROUTE["impl"] == "plain"
    n_ckpt = 20 if name != "rrr" else 16
    assert Es.shape == (CHAINS, n_ckpt) and Es.dtype == torch.float32
    assert bool(torch.isfinite(Es).all())
    assert torch.equal(pm.energy(st.sigma), st.E)
    assert torch.equal(pm.local_fields(st.sigma), st.aux)
    assert int(st.accepted.min()) > 0
    a, sa = _second_half_mean(Es.numpy())
    b, sb = jax_cache[key]
    bound = max(5 * np.hypot(sa, sb), 0.02)
    assert abs(a - b) < bound, (a, b, bound)


def test_float_couplings_bkl_and_rrr():
    """GraphRRGNormal on the race route: float32 energy within 1e-5 per
    spin of energy(sigma)."""
    m = pt.GraphRRGNormal(32, 3, seed=2, **CPU)
    for run in (lambda: pt.bklMC(m, 1.5, 3000, step=300, chains=32, seed=1,
                                 **CPU),
                lambda: pt.rrrMC(m, 1.5, 1024, step=128, chains=32, seed=1,
                                 **CPU)):
        Es, st = run()
        assert Es.shape[0] == 32
        err = (m.energy(st.sigma).double() - st.E.double()).abs().max()
        assert float(err) < 1e-5 * m.N


def test_state_continuation():
    """state= continues the chains: accepted counts add up, the energy stays
    exact, and the kernel streams are fresh (the generator advances)."""
    m = pt.GraphRRG(16, 3, seed=5, **CPU)
    Es1, st1 = pt.bklMC(m, 1.0, 2000, step=500, chains=8, seed=3, **CPU)
    Es2, st2 = pt.bklMC(m, 1.0, 2000, step=500, state=st1, **CPU)
    assert torch.equal(m.energy(st2.sigma), st2.E)
    assert bool((st2.accepted > st1.accepted).all())
    Es3, st3 = pt.standardMC(m, 1.0, 1000, step=500, state=st2,
                             backend="kernel", **CPU)
    assert torch.equal(m.energy(st3.sigma), st3.E)
    assert not torch.equal(st3.sigma, st2.sigma)


def test_kernel_only_samplers_raise():
    """backend="torch", a hook, an observer or a model without a race
    kernel take the generic torch path (exact running energy); the kernel
    route, asked for, still raises on each of them."""
    m = pt.GraphRRG(16, 3, seed=5, **CPU)
    three = pt.GraphThreeSpin(**CPU)
    for f, n in ((pt.rrrMC, 100), (pt.bklMC, 100), (pt.wtmMC, 10)):
        for model, kw in ((m, dict(backend="torch")),
                          (m, dict(hook=lambda *a: True)),
                          (m, dict(observer=lambda mdl, s, a, E: s.sum(-1))),
                          (three, {})):
            Es, st = f(model, 1.0, n, chains=4, **kw, **CPU)
            assert pt.LAST_ROUTE["backend"] == "torch"
            assert torch.equal(model.energy(st.sigma), st.E)
            if kw.get("backend") == "torch":
                continue
            with pytest.raises(NotImplementedError,
                               match="hook or observer|not eligible"):
                f(model, 1.0, n, chains=4, **dict(kw, backend="kernel"),
                  **CPU)
    with pytest.raises(ValueError, match="backend"):
        pt.bklMC(m, 1.0, 100, backend="xla", **CPU)
    with pytest.raises(NotImplementedError):
        pt.standardMC(m, 1.0, 100, backend="kernel", hook=lambda *a: True,
                      **CPU)


def test_standardmc_hook_and_observer():
    """The generic torch route keeps the reference's hook protocol and the
    observer series."""
    m = pt.GraphRRG(16, 3, seed=5, **CPU)
    calls = []

    def hook(it, model, state):
        calls.append(it)
        return it < 200

    Es, st = pt.standardMC(m, 1.0, 1000, step=50, chains=4, seed=1,
                           hook=hook, hook_every=2, **CPU)
    assert calls == [100, 200] and Es.shape == (4, 4)
    Os, _ = pt.standardMC(m, 1.0, 100, step=50, chains=4, seed=1,
                          observer=lambda mdl, s, a, E: s.sum(-1), **CPU)
    assert Os.shape == (4, 2)
    Es, _ = pt.standardMC(m, 1.0, 100, step=50, chains=4, seed=1,
                          backend="auto", **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-site"


def test_experiments_factors():
    m = pt.GraphRRG(16, 3, seed=5, **CPU)
    r = pt.experiments.runtest(pt.bklMC, m, 1.0, 2000, chains=8, **CPU)
    assert r["backend"] == "kernel-rejfree-sparse" and r["iters_per_s"] > 0
    assert 0 < r["mean_z_over_n"] <= 1
    f = pt.experiments.equal_wallclock_factors(m, 1.0, iters=600, chains=8,
                                               **CPU)
    assert set(f) == {"standard", "rrr", "bkl", "wtm"} and f["rrr"] == 1.0


def test_import_without_jax():
    code = ("import sys, rrrmc_tpu_torch; "
            "bad = [m for m in sys.modules if m in ('jax', 'rrrmc_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'rrrmc_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _boltzmann_mean(model, beta):
    """Exact <E> (physical) by enumerating all 2^N configurations."""
    n = model.N
    idx = torch.arange(2 ** n)
    sigma = (((idx[:, None] >> torch.arange(n)) & 1) * 2 - 1).to(torch.int8)
    E = model.to_physical(model.energy(sigma)).double()
    w = torch.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


@pytest.mark.parametrize("name", ["standard-kernel", "rrr", "bkl", "wtm"])
def test_kernel_route_samples_boltzmann(name):
    """On a 10-spin RRG the checkpoint-series mean of each kernel-route
    sampler matches the exact Boltzmann mean within max(5 sigma, 0.05):
    bkl/wtm weight states by their holding times, so this also checks the
    skip and clock bookkeeping."""
    m = pt.GraphRRG(10, 3, (-1, 1), seed=6, **CPU)
    beta = 1.0
    calls = {
        "standard-kernel": lambda: pt.standardMC(
            m, beta, 8000, step=20, chains=128, seed=2, backend="kernel",
            **CPU),
        "rrr": lambda: pt.rrrMC(m, beta, 2048, step=8, chains=128, seed=2,
                                **CPU),
        "bkl": lambda: pt.bklMC(m, beta, 8000, step=20, chains=128, seed=2,
                                **CPU),
        "wtm": lambda: pt.wtmMC(m, beta, 400, step=20.0, chains=128,
                                seed=2, **CPU),
    }
    Es, _ = calls[name]()
    Es = Es.double().numpy()[:, Es.shape[1] // 4:]
    got = Es.mean()
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    want = _boltzmann_mean(m, beta)
    assert abs(got - want) < max(5 * sem, 0.05), (got, want, sem)
