"""The port's replica-composite race kernel through its plain version
(rrrmc_tpu_torch/ops/replica.py) against the JAX Pallas kernels run in
interpret mode, on identical couplings, spins and random bits: over a dense
base (`_ring_rejfree_kernel`) and over a sparse one (`_sparse_comp_kernel`),
for the ring and the star in bkl, wtm and rrr mode. Then split launches
against one, for the race and the sweep, and the argument checks. The sweep
against its TPU kernel and the laws against exact enumeration are
tests/test_torch_replica_laws.py.

The TPU kernels need Nk % 128 == 0 and 128 chains, so the JAX side runs at
Nk = 128, M = 3, 128 chains, one short chunk."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops.rejfree import coord_dtype
from rrrmc_tpu_torch.ops.replica import (
    ReplicaTables, rejfree_replica_chunk, rejfree_replica_chunk_reference,
    replica_state, replica_tables)
from rrrmc_tpu_torch.ops.replica_sweep import (ReplicaSweeper,
                                               replica_sweep_chunk)

from torch_port_helpers import (CPU, pallas_interpret, port_composite,
                                race_bits, random_sigma)

torch.set_num_threads(1)

B = 128
N_MOVES = 16
SEED = 31
NK, M = 128, 3

#: (JAX builder, beta)
DENSE = {
    "ring": (lambda: rt.GraphQSKT(NK, M, 0.5, 1.0, seed=5), 1.0),
    "star": (lambda: rt.GraphSKRE(NK, M, 1.0, 1.0, seed=5), 1.0),
}
SPARSE = {
    "ring": (lambda: rt.GraphQuant(NK, M, 1.0, 1.0, rt.GraphRRG(
        NK, 3, (-1, 1), seed=11)), 1.0),
    "star": (lambda: rt.GraphRobustEnsemble(NK, M, 2.0, 1.0, rt.GraphRRG(
        NK, 3, (-1, 1), seed=12)), 1.0),
}


@pytest.fixture(scope="module")
def quant_pallas():
    with pallas_interpret("rrrmc_tpu.ops.prng", "rrrmc_tpu.ops.rejfree_pallas",
                          "rrrmc_tpu.ops.quant_pallas") as mods:
        yield mods[2]


def _start(pm):
    sigma = random_sigma(np.random.default_rng(8), B, pm.N)
    return sigma, pm.energy(torch.from_numpy(sigma)).numpy()


def _port_race(pm, beta, mode, sigma, E0, target, bits, threads=None):
    sig = torch.from_numpy(sigma.copy())
    lf, E = replica_state(pm, sig, torch.from_numpy(E0))
    coord = torch.zeros(B, dtype=coord_dtype(mode))
    acc = torch.zeros(B, dtype=torch.int32)
    zacc = torch.zeros(B, dtype=torch.float32)
    # the wrapper, or the plain version summing z as `threads` threads do
    chunk = rejfree_replica_chunk if threads is None else functools.partial(
        rejfree_replica_chunk_reference, threads=threads)
    cs, es = chunk(
        sig, lf, E, coord, acc, zacc, *replica_tables(pm), mode=mode,
        n_moves=N_MOVES, beta_s=beta, target=target, seed=SEED, bits=bits)
    return {k: v.numpy() for k, v in dict(
        sigma=sig, lf=lf, E=E, coord=coord, acc=acc, zacc=zacc, cs=cs,
        es=es).items()}


def _target(pm, beta, mode, sigma, E0, bits, threads=None):
    """The chunk's target: the median coordinate of a probe run with an
    unreachable one, so that about half the chains stop mid-chunk and the
    masking is compared too (rrr: every chain makes every move)."""
    if mode == "rrr":
        return N_MOVES
    p = _port_race(pm, beta, mode, sigma, E0, 1e30 if mode == "wtm"
                   else 2 ** 30, bits, threads)
    med = float(np.median(p["coord"]))
    return med if mode == "wtm" else int(med)


def _jax_args(mode, E0, target):
    ct = jnp.float32 if mode == "wtm" else jnp.int32
    return (jnp.asarray(E0, jnp.float32), jnp.zeros(B, ct),
            jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.float32)), dict(
        seed=jnp.asarray([SEED], jnp.int32), target=jnp.asarray([target],
                                                                   ct))


def _compare(p, j, mode, target):
    """Spins and accepted counts EQUAL, bkl / rrr coordinates EQUAL; E and
    the E stream within 1e-5 relative (float32 physical energies: the same
    dE in the same order, but XLA and torch may round exp/log-sums apart);
    the wtm clock and z/N within rtol 1e-5 (the TPU dense kernel sums z
    unshifted, the port as a shifted log-sum-exp)."""
    done = (j["coord"] >= target).sum()
    assert 0 < done < B or mode == "rrr", done
    np.testing.assert_array_equal(p["sigma"], j["sigma"])
    np.testing.assert_array_equal(p["acc"], j["acc"])
    np.testing.assert_allclose(p["E"], j["E"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p["es"], j["es"], rtol=1e-5, atol=1e-5)
    if mode == "wtm":
        np.testing.assert_allclose(p["coord"], j["coord"], rtol=1e-5)
    else:
        np.testing.assert_array_equal(p["coord"], j["coord"])
        np.testing.assert_array_equal(p["cs"], j["cs"])
    np.testing.assert_allclose(p["zacc"], j["zacc"], rtol=1e-5)


def _cases(extra):
    """(mode, term, threads) cases: each mode and term at the default block
    size, and the (mode, term) `extra` at 1024 threads."""
    return [*(pytest.param(m, t, None, id=f"{m}-{t}")
              for m in ("bkl", "wtm", "rrr") for t in ("ring", "star")),
            pytest.param(*extra, 1024,
                         id=f"{extra[0]}-{extra[1]}-1024threads")]


@pytest.mark.parametrize("mode,term,threads", _cases(("bkl", "ring")))
def test_dense_race_matches_jax_interpret(quant_pallas, mode, term, threads):
    """The plain race over a dense base against `_ring_rejfree_kernel` on
    the TPU kernel's bits (race at salt 3m, rrr and bkl at 3m + 1); z summed
    as a block of `threads` threads sums it (by default 256)."""
    qp = quant_pallas
    build, beta = DENSE[term]
    jm = build()
    pm = port_composite(jm)
    sigma, E0 = _start(pm)
    spec = qp.composite_spec(jm)
    assert spec is not None and spec["term"] == term
    bits = race_bits(SEED, B, pm.N, pm.N, skip_salt=1)
    target = _target(pm, beta, mode, sigma, E0, bits, threads)
    (E, coord, acc, zacc), kw = _jax_args(mode, E0, target)
    out = qp._pallas_ring_rejfree_chunk(
        jnp.asarray(sigma), E, coord, acc, zacc, spec["Jb"], spec["hph"],
        spec["params"], kw["seed"], jnp.asarray([beta], jnp.float32),
        kw["target"], term=term, Nk=NK, M=M, block_chains=B,
        n_moves=N_MOVES, mode=mode, flt=spec["flt"])
    j = {k: np.asarray(v) for k, v in zip(
        ("sigma", "E", "coord", "acc", "zacc", "cs", "es"), out)}
    p = _port_race(pm, beta, mode, sigma, E0, target, bits,
                   threads)
    _compare(p, j, mode, target)


@pytest.mark.parametrize("mode,term,threads", _cases(("rrr", "star")))
def test_sparse_race_matches_jax_interpret(quant_pallas, mode, term,
                                           threads):
    """The plain race over a sparse base against `_sparse_comp_kernel` on
    the TPU kernel's bits (race at salt 3m, rrr at 3m + 1, bkl at 3m + 2);
    the resident int32 base fields EQUAL too. z summed as a block of
    `threads` threads sums it (by default 256)."""
    qp = quant_pallas
    build, beta = SPARSE[term]
    jm = build()
    pm = port_composite(jm)
    sigma, E0 = _start(pm)
    bits = race_bits(SEED, B, pm.N, pm.N, skip_salt=2)
    target = _target(pm, beta, mode, sigma, E0, bits, threads)
    s = qp.composite_sparse_spec(jm)
    assert s is not None and s["NkP"] == NK and not s["flt"]
    sigp, lfT = qp._sparse_comp_prep(jm.resid_m.base, jnp.asarray(sigma),
                                     NK, NK, M, True)
    (E, coord, acc, zacc), kw = _jax_args(mode, E0, target)
    out = qp._pallas_sparse_comp_chunk(
        sigp, lfT, E, coord, acc, zacc, s["nbr"], s["jc"], s["hph"],
        s["vcol"], s["params"], kw["seed"], jnp.asarray([beta], jnp.float32),
        kw["target"], term=term, Nk=NK, NkP=NK, M=M, block_chains=B,
        n_moves=N_MOVES, mode=mode, flt=False)
    j = {k: np.asarray(v) for k, v in zip(
        ("sigma", "lf", "E", "coord", "acc", "zacc", "cs", "es"), out)}
    p = _port_race(pm, beta, mode, sigma, E0, target, bits,
                   threads)
    _compare(p, j, mode, target)
    np.testing.assert_array_equal(p["lf"], j["lf"].T)


# --- split launches, argument checks ----------------------------------------

SMALL = {
    "ring": lambda: pt.GraphQSKT(4, 3, 0.7, 1.0, seed=2, **CPU),
    "star": lambda: pt.GraphSKRE(4, 3, 0.8, 1.0, seed=2, **CPU),
    "ring-sparse": lambda: pt.GraphQuant(4, 3, 0.7, 1.0, pt.GraphRRG(
        4, 3, (-1, 1), seed=3, **CPU)),
    "star-sparse": lambda: pt.GraphRobustEnsemble(4, 3, 0.8, 1.0, pt.GraphRRG(
        4, 3, (-1, 1), seed=3, **CPU)),
}



@pytest.mark.parametrize("name", ["ring", "star-sparse"])
def test_split_launches_equal_one(name):
    """Two race launches (the second from move0) and two sweep launches
    (the second from sweep0) equal one launch of the same moves."""
    m = SMALL[name]()
    st = pt.init_state(m, 16, seed=4, **CPU)
    tabs = replica_tables(m)

    def race(splits):
        sig = st.sigma.clone()
        lf, E = replica_state(m, sig, st.E)
        coord = torch.zeros(16, dtype=torch.int32)
        acc = torch.zeros(16, dtype=torch.int32)
        zacc = torch.zeros(16)
        m0 = 0
        for n in splits:
            rejfree_replica_chunk(sig, lf, E, coord, acc, zacc, *tabs,
                                  mode="bkl", n_moves=n, beta_s=1.0,
                                  target=2 ** 30, seed=3, move0=m0)
            m0 += n
        return sig, lf, E, coord, acc, zacc

    assert all(torch.equal(a, b) for a, b in zip(race([40]), race([15, 25])))
    if name != "ring":
        return
    runner = ReplicaSweeper(m, 1.0)

    def sweep(splits):
        sig = st.sigma.clone()
        lf, E = replica_state(m, sig, st.E)
        acc = torch.zeros(16, dtype=torch.int32)
        s0 = 0
        for n in splits:
            runner(sig, lf, E, acc, seed=3, n_sweeps=n, sweep0=s0)
            s0 += n
        return sig, lf, E, acc

    assert all(torch.equal(a, b) for a, b in zip(sweep([5]), sweep([2, 3])))


def test_argument_checks_raise():
    m = SMALL["ring"]()
    st = pt.init_state(m, 4, seed=1, **CPU)
    lf, E = replica_state(m, st.sigma, st.E)
    (tab,) = replica_tables(m)
    z = dict(coord=torch.zeros(4, dtype=torch.int32),
             acc=torch.zeros(4, dtype=torch.int32), zacc=torch.zeros(4))

    def race(sig=st.sigma, lf=lf, E=E, tab=tab, mode="bkl", **over):
        a = {**z, **over}
        rejfree_replica_chunk(sig.clone(), lf.clone(), E.clone(), a["coord"],
                              a["acc"], a["zacc"], tab, mode=mode, n_moves=2,
                              beta_s=1.0, target=10, seed=1)

    with pytest.raises(ValueError, match="mode"):
        race(mode="metropolis")
    with pytest.raises(ValueError, match="E"):
        race(E=E.double())
    with pytest.raises(ValueError, match="lf"):
        race(lf=lf[:, :-1])
    with pytest.raises(ValueError, match="spins"):
        race(tab=tab._replace(M=2))
    with pytest.raises(ValueError, match="term"):
        race(tab=tab._replace(term="chain"))
    with pytest.raises(ValueError, match="coord"):
        race(coord=torch.zeros(4))
    with pytest.raises(ValueError, match="acc"):
        replica_sweep_chunk(st.sigma.clone(), lf.clone(), E.clone(),
                            torch.zeros(4, dtype=torch.int64), tab,
                            beta=1.0, n_sweeps=1, seed=1)
    sparse = replica_tables(SMALL["ring-sparse"]())[0]
    with pytest.raises(ValueError, match="dense base"):
        replica_sweep_chunk(st.sigma.clone(), lf.clone(), E.clone(),
                            z["acc"].clone(), sparse, beta=1.0, n_sweeps=1,
                            seed=1)
    assert isinstance(tab, ReplicaTables)
