"""The replica composites' sweep kernel through its plain version
(rrrmc_tpu_torch/ops/replica_sweep.py) against the JAX Pallas sweep
(`_ring_sweep_kernel`) in interpret mode, on identical couplings, spins and
random bits, for the ring and the star; and the laws of the race (bkl, rrr)
and the sweep against exact enumeration at Nk = 4, M = 3 (12 spins)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops.replica import (rejfree_replica_chunk,
                                         replica_state, replica_tables)
from rrrmc_tpu_torch.ops.replica_sweep import (ReplicaSweeper,
                                               replica_sweep_chunk)

from torch_port_helpers import (CPU, _salt0, blocked_commit_reference,
                                interpret_bits, pallas_interpret,
                                port_composite, random_sigma)

torch.set_num_threads(1)

B = 128
SEED = 31
NK, M = 128, 3
#: (JAX builder, beta)
DENSE = {
    "ring": (lambda: rt.GraphQSKT(NK, M, 0.5, 1.0, seed=5), 1.0),
    "star": (lambda: rt.GraphSKRE(NK, M, 1.0, 1.0, seed=5), 1.0),
}


@pytest.fixture(scope="module")
def quant_pallas():
    with pallas_interpret("rrrmc_tpu.ops.prng", "rrrmc_tpu.ops.rejfree_pallas",
                          "rrrmc_tpu.ops.quant_pallas") as mods:
        yield mods[2]


def _start(pm):
    sigma = random_sigma(np.random.default_rng(8), B, pm.N)
    return sigma, pm.energy(torch.from_numpy(sigma)).numpy()


#: the TPU sweep kernel's window, cut from 128 to 32 rows for interpret mode
#: (an integer base's decisions do not depend on it: the TPU kernel's fields
#: differ from the port's exact ones only by float32 rounding)
W_JAX = 32


def _sweep_bits(seed, N, W):
    """bits(t) of the JAX sweep kernel (one block of B chains): window w of
    sweep t at salt salt0 + t * n_win + w, one [W, B] draw each, stacked to
    the port's [B, N]."""
    s0 = _salt0(seed)
    n_win = N // W
    return lambda t: torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [interpret_bits((W, B), s0 + t * n_win + w)
         for w in range(n_win)]).T))


@pytest.mark.parametrize("term", ["ring", "star"])
def test_sweep_matches_jax_interpret(quant_pallas, term):
    """Two plain sweeps (two launches of one sweep each, the fields
    carried) against one two-sweep launch of `_pallas_ring_sweep` on its
    bits: spins and accepted counts
    EQUAL; E within 1e-5 relative (the TPU kernel adds a window's dE sum,
    the port each dE); the port's exact int32 base fields times sb against
    the TPU's float32 fields within 1e-4."""
    qp = quant_pallas
    build, beta = DENSE[term]
    jm = build()
    pm = port_composite(jm)
    sigma, E0 = _start(pm)
    sw = qp.PallasRingSweeper(jm, beta)
    s = sw.spec
    sig_j, E_j = jnp.asarray(sigma), jnp.asarray(E0, jnp.float32)
    acc_j, lfT = jnp.zeros(B, jnp.int32), sw.lf_init(jnp.asarray(sigma))
    sig_j, lfT, E_j, acc_j = qp._pallas_ring_sweep(
        sig_j, lfT, E_j, acc_j, s["Jb"], s["hph"], s["params"],
        jnp.asarray([SEED], jnp.int32), jnp.asarray([2], jnp.int32),
        sw.beta, term=term, Nk=NK, M=M, W=W_JAX, block_chains=B, flt=False)
    sig = torch.from_numpy(sigma.copy())
    lf, E = replica_state(pm, sig, torch.from_numpy(E0))
    acc = torch.zeros(B, dtype=torch.int32)
    runner = ReplicaSweeper(pm, beta)
    bits = _sweep_bits(SEED, pm.N, W_JAX)
    for t in range(2):
        runner(sig, lf, E, acc, seed=SEED, n_sweeps=1, sweep0=t,
               bits=lambda _t, t=t: bits(t))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_j))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert int(acc.sum()) > B * pm.N // 20          # the sweep moves
    np.testing.assert_allclose(E.numpy(), np.asarray(E_j), rtol=1e-5)
    sb = float(runner.tab.params[0])
    np.testing.assert_allclose(lf.numpy() * sb, np.asarray(lfT).T, atol=1e-4)


# --- laws against exact enumeration -----------------------------------------

SMALL = {
    "ring": lambda: pt.GraphQSKT(4, 3, 0.7, 1.0, seed=2, **CPU),
    "star": lambda: pt.GraphSKRE(4, 3, 0.8, 1.0, seed=2, **CPU),
    "ring-sparse": lambda: pt.GraphQuant(4, 3, 0.7, 1.0, pt.GraphRRG(
        4, 3, (-1, 1), seed=3, **CPU)),
    "star-sparse": lambda: pt.GraphRobustEnsemble(4, 3, 0.8, 1.0, pt.GraphRRG(
        4, 3, (-1, 1), seed=3, **CPU)),
}


def _exact_mean_energy(model, beta):
    """<E> under exp(-beta E) over all 2^N configurations."""
    n = model.N
    states = ((torch.arange(2 ** n)[:, None] >> torch.arange(n)) & 1)
    sigma = (2 * states - 1).to(torch.int8)
    E = model.energy(sigma).double()
    w = torch.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


def _check_mean(samples, weights, exact, what):
    """The weighted mean over each chain's samples, then the mean and its
    standard error over the chains: within 4.5 standard errors of `exact`
    (chains are independent; their time averages are the samples)."""
    per_chain = (samples * weights).sum(1) / weights.sum(1)
    mean, sem = float(per_chain.mean()), float(per_chain.std()) / \
        per_chain.numel() ** 0.5
    assert abs(mean - exact) < 4.5 * sem + 1e-9, (what, mean, exact, sem)


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("mode", ["bkl", "rrr"])
def test_race_law_exact(mode, name):
    """bkl (each state weighted by the iterations it is held, skip + 1 of
    the next move) and rrr (each state after a move, the SingleGraph law
    on the flat composite) sample exp(-beta E) of the 12-spin composite."""
    m, beta, n_moves, Bl = SMALL[name](), 1.0, 700, 48
    st = pt.init_state(m, Bl, seed=4, **CPU)
    lf, E = replica_state(m, st.sigma, st.E)
    sig = st.sigma.clone()
    coord = torch.zeros(Bl, dtype=torch.int32)
    acc = torch.zeros(Bl, dtype=torch.int32)
    zacc = torch.zeros(Bl, dtype=torch.float32)
    cs, es = rejfree_replica_chunk(
        sig, lf, E, coord, acc, zacc, *replica_tables(m), mode=mode,
        n_moves=n_moves, beta_s=beta, target=2 ** 30, seed=9)
    es, cs = es.t().double()[:, 60:], cs.t().double()[:, 60:]
    if mode == "bkl":   # state after move m is held until move m + 1
        w = cs[:, 1:] - cs[:, :-1]
        es = es[:, :-1]
    else:
        w = torch.ones_like(es)
    _check_mean(es, w, _exact_mean_energy(m, beta), f"{mode} {name}")
    assert (m.energy(sig) - E).abs().max() < 1e-4


@pytest.mark.parametrize("term", ["ring", "star"])
def test_sweep_law_exact(term):
    """The sequential sweep samples exp(-beta E): the energy after each of
    200 sweeps of 64 chains."""
    m, beta, Bl = SMALL[term](), 1.0, 64
    st = pt.init_state(m, Bl, seed=4, **CPU)
    sig = st.sigma.clone()
    lf, E = replica_state(m, sig, st.E)
    acc = torch.zeros(Bl, dtype=torch.int32)
    (tab,) = replica_tables(m)
    Es = []
    for t in range(200):
        replica_sweep_chunk(sig, lf, E, acc, tab, beta=beta, n_sweeps=1,
                            seed=6, sweep0=t)
        Es.append(E.clone())
    es = torch.stack(Es, dim=1).double()[:, 20:]
    _check_mean(es, torch.ones_like(es), _exact_mean_energy(m, beta),
                f"sweep {term}")
    assert torch.equal(lf, replica_state(m, sig, E)[0])




# --- the redesigned kernel's launch plan and commit -------------------------

from rrrmc_tpu_torch.ops import replica_sweep, sk  # noqa: E402

OPTIN = 232_448


@pytest.mark.parametrize("B", [1, 9, 203, 1024, 1584, 2048])
def test_sweep_plan_every_nk(B):
    """The composite sweep's plan for every Nk from 1 to 2048 at ragged B:
    an integer base takes ops/sk.py's blocks of 16 chains, spans of
    BLOCK_SPAN or Nk, 14 bytes a spin of the stride a chain beside the span's
    diagonal block of J, and the tensor-core commit; a float base 8 chains,
    the plain version's SPAN (its float32 sums follow it) and the commit on
    the CUDA cores. Both fit the card's shared memory."""
    chains = sk.BLOCK_CHAINS
    for nk in range(1, 2049):
        p = replica_sweep.sweep_plan(nk, B, True)
        assert p["path"] == "mma" and p["chains"] == chains
        assert p["span"] == min(nk, sk.BLOCK_SPAN)
        assert p["stride"] == sk.span_stride(p["span"])
        assert p["smem"] == (p["span"] * p["stride"]
                             + chains * p["stride"] * 14) <= OPTIN
        assert p["blocks"] * chains >= B > (p["blocks"] - 1) * chains
        assert p["loads"] == (16 if nk % 16 == 0 else 4 if nk % 4 == 0
                              else 1)
        f = replica_sweep.sweep_plan(nk, B, False)
        assert f["path"] == "scalar" and f["chains"] == 8
        assert f["span"] == min(nk, replica_sweep.SPAN)
        assert f["smem"] == 8 * f["stride"] * 15 <= OPTIN
        assert f["loads"] == (4 if nk % 4 == 0 else 1)


#: (B, Nk, M, k, i0, length): the mover's replica block k of M, at ragged
#: B and Nk
BLOCK_COMMITS = [(21, 100, 3, 1, 64, 36), (37, 72, 5, 4, 0, 72),
                 (9, 48, 3, 0, 0, 48)]


@pytest.mark.parametrize("case", BLOCK_COMMITS,
                         ids=[f"B{c[0]}-Nk{c[1]}-k{c[3]}" for c in
                              BLOCK_COMMITS])
def test_blocked_commit_into_replica_block(case):
    """The kernel's commit into the mover's block of the base fields
    (`blocked_commit_reference` at offset k Nk of rows of Nk M
    fields) equals the sequential commit, and leaves the other blocks."""
    B, nk, M, k, i0, length = case
    rng = np.random.default_rng(nk + k)
    a = rng.integers(-127, 128, size=(nk, nk))
    J = torch.from_numpy((np.triu(a, 1) + np.triu(a, 1).T).astype(np.int8))
    dlt = torch.zeros((B, sk.span_stride(length)), dtype=torch.int8)
    dlt[:, :length] = torch.from_numpy(
        rng.choice(np.array([-2, 0, 2], np.int8), size=(B, length)))
    lf = torch.from_numpy(rng.integers(-900, 900, size=(B, nk * M)).astype(
        np.int32))
    want = lf.clone()
    want[:, k * nk:(k + 1) * nk] += (dlt[:, :length].double()
                                     @ J[i0:i0 + length].double()).to(
        torch.int32)
    got = lf.clone()
    blocked_commit_reference(got, dlt, J, i0, length, off=k * nk)
    assert torch.equal(got, want)


def test_refuses_asymmetric_base():
    """A base whose couplings are not symmetric is refused when the sweeper
    is built (the kernel's commit reads J[span, n] as J[n, span])."""
    base = pt.GraphSK(8, seed=3, **CPU)
    J = base.J.clone()
    J[1, 4] += 1
    asym = pt.fully_connected_from_arrays(J.numpy(), base.h.numpy(),
                                          scale=base.scale, **CPU)
    for model in (pt.GraphQuant(8, 3, 0.5, 1.0, asym),
                  pt.GraphRobustEnsemble(8, 3, 0.5, 1.0, asym)):
        assert replica_sweep.replica_sweep_ok(model)
        with pytest.raises(ValueError, match="symmetric"):
            ReplicaSweeper(model, 1.0)
    ReplicaSweeper(pt.GraphQuant(8, 3, 0.5, 1.0, base), 1.0)


def test_float_base_takes_asymmetric_couplings():
    """The float kernel reads the flipped spins' rows of J, as the plain
    version does, and needs no symmetry: a float base whose couplings are
    not symmetric is taken by the sweeper (its launches skip the check)."""
    base = pt.GraphSKNormal(8, seed=3, **CPU)
    J = base.J.clone()
    J[1, 4] += 0.5
    asym = pt.fully_connected_from_arrays(J.numpy(), base.h.numpy(),
                                          scale=base.scale, **CPU)
    for model in (pt.GraphQuant(8, 3, 0.5, 1.0, asym),
                  pt.GraphRobustEnsemble(8, 3, 0.5, 1.0, asym)):
        assert replica_sweep.replica_sweep_ok(model)
        sw = ReplicaSweeper(model, 1.0)
        assert sw.tab.J.dtype == torch.float32
        assert not torch.equal(sw.tab.J, sw.tab.J.T)
