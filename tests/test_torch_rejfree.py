"""The port's sparse race moves (rrrmc_tpu_torch/ops/rejfree.py) against the
JAX Pallas race kernels run in interpret mode, on identical tables, spins and
random bits, for bkl, wtm and rrr: the sparse kernel on random regular
graphs, and the lattice kernel (`_rejfree_kernel`, which the port folds into
the sparse one) on EA lattices; plus the port's Philox streams and
eligibility rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import rejfree
from rrrmc_tpu_torch.ops.rejfree import coord_dtype, rejfree_sparse_chunk

from torch_port_helpers import (CPU, lattice_race_bits, pallas_interpret,
                                port_lattice, port_model, race_bits,
                                random_sigma)

torch.set_num_threads(1)

B = 128
N_MOVES = 64
BETA = 1.0
SEED = 21
#: chunk targets that stop some chains mid-chunk, so the inactive-chain
#: masking is compared too
TARGETS = {"bkl": 260, "wtm": 4.0, "rrr": 40}


@pytest.fixture(scope="module")
def rejfree_pallas():
    with pallas_interpret("rrrmc_tpu.ops.rejfree_pallas") as (rp,):
        yield rp


def _port_chunk(jm, sigma, E0, mode, bits=None, chain0=0, seed=SEED):
    pm = port_model(jm)
    flt = pm.J.dtype == torch.float32
    sig = torch.from_numpy(sigma.copy())
    lf = pm.local_fields(sig) if bits is None else torch.from_numpy(
        np.asarray(jax.vmap(jm.local_fields)(jnp.asarray(sigma))).astype(
            np.float32 if flt else np.int32))
    E = torch.from_numpy(np.asarray(E0).astype(np.float32 if flt
                                                else np.int32))
    n = sig.shape[0]
    coord = torch.zeros(n, dtype=coord_dtype(mode))
    acc = torch.zeros(n, dtype=torch.int32)
    zacc = torch.zeros(n, dtype=torch.float32)
    cs, es = rejfree_sparse_chunk(
        sig, lf, E, coord, acc, zacc, pm.neigh, pm.J, mode=mode,
        n_moves=N_MOVES, beta_s=BETA * pm.scale, target=TARGETS[mode],
        seed=seed, chain0=chain0, bits=bits)
    return pm, dict(sigma=sig, lf=lf, E=E, coord=coord, acc=acc, zacc=zacc,
                    cs=cs, es=es)


@pytest.mark.parametrize("coupling", ["pm_j", "normal"])
@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_chunk_matches_jax_interpret(rejfree_pallas, mode, coupling):
    """Integer couplings: sigma, E, coord, acc and both streams EQUAL (the
    wtm clock, a float32 sum of exp(min score), and z/N within rtol 1e-6:
    XLA's and torch's float32 exp/log may differ in the last bit). Float
    couplings: at most one chain of 128 may diverge (a last-bit difference
    can flip a borderline race or acceptance); on the others E within 1e-4,
    coordinates and z/N within rtol 1e-5."""
    jm = (rt.GraphRRG(64, 3, (-1, 1), seed=3) if coupling == "pm_j"
          else rt.GraphRRGNormal(64, 3, seed=4))
    flt = coupling == "normal"
    rng = np.random.default_rng(8)
    sigma = random_sigma(rng, B, jm.N)
    sig_j = jnp.asarray(sigma)
    E0 = np.asarray(jax.vmap(jm.energy)(sig_j))

    rf = rejfree_pallas.PallasRejectionFree(jm, BETA, mode, chunk_moves=N_MOVES)
    ct = jnp.float32 if mode == "wtm" else jnp.int32
    out = rf.chunk(sig_j, jnp.asarray(E0), jnp.zeros(B, ct), seed=SEED,
                   target=TARGETS[mode])
    j = {k: np.asarray(v) for k, v in zip(
        ("sigma", "E", "coord", "acc", "zacc", "cs", "es"), out)}

    pm, p = _port_chunk(jm, sigma, E0, mode,
                        bits=race_bits(SEED, B, jm.N, rf.NP))
    p = {k: v.numpy() for k, v in p.items()}
    done = (j["coord"] >= TARGETS[mode]).sum()
    assert 0 < done < B or mode == "rrr", done   # the masking is exercised
    if not flt:
        for key in ("sigma", "E", "acc", "es"):
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
        if mode == "wtm":
            np.testing.assert_allclose(p["coord"], j["coord"], rtol=1e-6)
            np.testing.assert_allclose(p["cs"], j["cs"], rtol=1e-6)
        else:
            np.testing.assert_array_equal(p["coord"], j["coord"])
            np.testing.assert_array_equal(p["cs"], j["cs"])
        np.testing.assert_allclose(p["zacc"], j["zacc"], rtol=1e-6)
        # the resident local fields stay exact
        np.testing.assert_array_equal(
            p["lf"], pm.local_fields(torch.from_numpy(p["sigma"])).numpy())
        return
    same = (p["sigma"] == j["sigma"]).all(axis=1) & (p["acc"] == j["acc"])
    assert (~same).sum() <= 1, (~same).sum()
    np.testing.assert_allclose(p["E"][same], j["E"][same], atol=1e-4)
    np.testing.assert_allclose(p["coord"][same], j["coord"][same], rtol=1e-5)
    np.testing.assert_allclose(p["zacc"][same], j["zacc"][same], rtol=1e-5)
    lf_re = pm.local_fields(torch.from_numpy(p["sigma"])).numpy()
    np.testing.assert_allclose(p["lf"], lf_re, atol=1e-4)


#: targets that stop about half the lattice chains mid-chunk (rrr: all at
#: move 40)
LATTICE_TARGETS = {"bkl": 200, "wtm": 3.1, "rrr": 40}


@pytest.mark.parametrize("beta", [1.0, 2.0])
@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_lattice_chunk_matches_jax_interpret(rejfree_pallas, mode, beta):
    """A LatticeEA is a sparse Pairwise with K = 2D to the race: the port's
    race chunk on EA-3D L=4 +-J equals the JAX lattice kernel
    (`_pallas_rejfree_chunk`, lattice local fields by rolls) with its bits
    mapped (the bkl skip at salt 3m + 1). Spins, E, acc, the E stream and
    the bkl / rrr coordinates are EQUAL; the wtm clock and z/N within
    rtol 1e-6, float32 sums taken in another order (the JAX kernel sums
    exp(-bE), the port a shifted log-sum-exp)."""
    jm = rt.GraphEA(4, 3, (-1, 1), seed=4)
    N = jm.N
    rng = np.random.default_rng(8)
    sigma = random_sigma(rng, B, N)
    sig_j = jnp.asarray(sigma)
    E0 = np.asarray(jax.vmap(jm.energy)(sig_j)).astype(np.int32)
    Jp, Jm = rejfree_pallas._build_dir_tables(jm)
    ct = jnp.float32 if mode == "wtm" else jnp.int32
    target = LATTICE_TARGETS[mode]
    out = rejfree_pallas._pallas_rejfree_chunk(
        sig_j, jnp.asarray(E0), jnp.zeros(B, ct), jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.float32), jnp.asarray(Jp), jnp.asarray(Jm),
        jnp.asarray(np.asarray(jm.h, np.int32).reshape(N, 1)),
        jnp.asarray([SEED], jnp.int32), jnp.asarray([2 * beta], jnp.float32),
        jnp.asarray([target], ct), L=jm.L, D=jm.D, block_chains=B,
        n_moves=N_MOVES, mode=mode)
    j = {k: np.asarray(v) for k, v in zip(
        ("sigma", "E", "coord", "acc", "zacc", "cs", "es"), out)}

    pm = port_lattice(jm)
    assert rejfree.sparse_rejfree_ok(pm)
    sig = torch.from_numpy(sigma.copy())
    lf = pm.local_fields(sig)
    E = torch.from_numpy(E0.copy())
    coord = torch.zeros(B, dtype=coord_dtype(mode))
    acc = torch.zeros(B, dtype=torch.int32)
    zacc = torch.zeros(B, dtype=torch.float32)
    cs, es = rejfree_sparse_chunk(
        sig, lf, E, coord, acc, zacc, pm.neigh, pm.J, mode=mode,
        n_moves=N_MOVES, beta_s=beta * pm.scale, target=target,
        seed=SEED, bits=lattice_race_bits(SEED, B, N))
    p = dict(sigma=sig, E=E, coord=coord, acc=acc, zacc=zacc, cs=cs, es=es)
    p = {k: v.numpy() for k, v in p.items()}
    done = (j["coord"] >= target).sum()
    assert 0 < done < B or mode == "rrr", done   # chains stop mid-chunk
    for key in ("sigma", "E", "acc", "es"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    if mode == "wtm":
        np.testing.assert_allclose(p["coord"], j["coord"], rtol=1e-6)
        np.testing.assert_allclose(p["cs"], j["cs"], rtol=1e-6)
    else:
        np.testing.assert_array_equal(p["coord"], j["coord"])
        np.testing.assert_array_equal(p["cs"], j["cs"])
    np.testing.assert_allclose(p["zacc"], j["zacc"], rtol=1e-6)
    assert torch.equal(lf, pm.local_fields(sig))


@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_chunk_independent_of_batch_layout(mode):
    """Philox keys on the global chain id: the two halves of a batch, run
    as separate batches with chain0 offsets, give the whole batch's
    results."""
    jm = rt.GraphRRG(64, 3, (-1, 1), seed=3)
    rng = np.random.default_rng(9)
    sigma = random_sigma(rng, 64, jm.N)
    E0 = np.asarray(jax.vmap(jm.energy)(jnp.asarray(sigma)))
    _, whole = _port_chunk(jm, sigma, E0, mode)
    _, lo = _port_chunk(jm, sigma[:32], E0[:32], mode)
    _, hi = _port_chunk(jm, sigma[32:], E0[32:], mode, chain0=32)
    for key, v in whole.items():
        cat = torch.cat([lo[key], hi[key]], dim=1 if key in ("cs", "es")
                        else 0)
        assert torch.equal(v, cat), key


@pytest.mark.parametrize("n", [64, 1000])
def test_block_sum_follows_kernel_order(n):
    """The plain version's z sum adds in the CUDA kernel's order (strided
    per-thread sums, a pairwise fold within each warp, the warps in turn),
    spelled out here one float32 addition at a time."""
    rng = np.random.default_rng(n)
    x = rng.exponential(size=(3, n)).astype(np.float32)
    T = rejfree.THREADS
    want = []
    for row in x:
        part = [np.float32(0)] * T
        for t in range(T):
            for i in range(t, n, T):
                part[t] = np.float32(part[t] + row[i])
        warps = []
        for w in range(T // 32):
            lanes = part[32 * w:32 * w + 32]
            for o in (16, 8, 4, 2, 1):
                lanes = [np.float32(lanes[l] + lanes[l + o]) for l in range(o)]
            warps.append(lanes[0])
        s = warps[0]
        for v in warps[1:]:
            s = np.float32(s + v)
        want.append(s)
    got = rejfree.block_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    np.testing.assert_allclose(got, x.astype(np.float64).sum(1), rtol=1e-5)


def test_sparse_rejfree_ok():
    assert rejfree.sparse_rejfree_ok(pt.GraphRRG(64, 3, **CPU))
    assert rejfree.sparse_rejfree_ok(pt.GraphRRGNormal(64, 3, seed=1, **CPU))
    assert rejfree.sparse_rejfree_ok(pt.GraphEA(2, 3, **CPU))        # N = 8
    assert not rejfree.sparse_rejfree_ok(pt.GraphThreeSpin(**CPU))  # N < 8
    m = pt.GraphRRGNormal(16, 3, seed=1, **CPU)
    bad = pt.pairwise_from_arrays(
        m.neigh.numpy(), np.where(m.J.numpy() > 0, np.inf, m.J.numpy()),
        m.h.numpy(), 0.0, N=16, K=3, scale=1.0, **CPU)
    assert not rejfree.sparse_rejfree_ok(bad)


def test_wrapper_checks_arguments():
    m = pt.GraphRRG(16, 3, seed=1, **CPU)
    st = pt.init_state(m, 4, seed=2, **CPU)
    lf = m.local_fields(st.sigma)
    z = dict(acc=torch.zeros(4, dtype=torch.int32),
             zacc=torch.zeros(4, dtype=torch.float32))
    kw = dict(mode="bkl", n_moves=2, beta_s=1.0, target=10, seed=1)
    with pytest.raises(ValueError, match="coord"):
        rejfree_sparse_chunk(st.sigma, lf, st.E, torch.zeros(4), z["acc"],
                             z["zacc"], m.neigh, m.J, **kw)
    with pytest.raises(ValueError, match="lf"):
        rejfree_sparse_chunk(st.sigma, lf.float(), st.E,
                             torch.zeros(4, dtype=torch.int32), z["acc"],
                             z["zacc"], m.neigh, m.J, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rejfree_sparse_chunk(st.sigma.t().contiguous().t(), lf, st.E,
                             torch.zeros(4, dtype=torch.int32), z["acc"],
                             z["zacc"], m.neigh, m.J, **kw)
