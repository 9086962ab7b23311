"""The port's tau-EO moves (rrrmc_tpu_torch/ops/eo.py, ops/eo_dense.py)
against the JAX Pallas EO kernels run in interpret mode, on identical
couplings, spins, local fields and random bits: the sparse kernel
(`_eo_sparse_kernel`) on random regular graphs and float lattices, the
lattice and dense branches of `_eo_kernel` (the port folds the first into
its sparse kernel and the second into its dense one) and the streamed
kernel (`_eo_stream_kernel`, several small windows per move, which the port
also folds into its dense kernel). Integer couplings agree bit for bit;
float couplings within the tolerance `_compare` states."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu.samplers.eo import _rank_cdf as jax_rank_cdf
from rrrmc_tpu_torch.ops import prng
from rrrmc_tpu_torch.ops.eo import eo_sparse_chunk
from rrrmc_tpu_torch.ops.eo_dense import eo_dense_chunk
from rrrmc_tpu_torch.ops.rejfree_dense import kernel_couplings
from rrrmc_tpu_torch.samplers.eo import rank_table

from torch_port_helpers import (CPU, _salt0, eo_bits, jax_random_bits,
                                pallas_interpret, port_lattice, port_model,
                                random_sigma)

torch.set_num_threads(1)

B = 128
N_MOVES = 64
TAU = 1.4
SEED = 21


def _fields_lattice():
    """GraphEA(4, 2, +-J) with integer fields in [-2, 2]."""
    jm = rt.GraphEA(4, 2, (-1, 1), seed=11)
    h = np.random.default_rng(3).integers(-2, 3, jm.N)
    return dataclasses.replace(jm, h=jnp.asarray(h, jm.h.dtype))


#: name -> (JAX model, the TPU kernel that takes it, streamed window)
CASES = {
    "sparse RRG150": (lambda: rt.GraphRRG(150, 3, (-1, 1), seed=21),
                      "sparse", None),
    "sparse RRG96": (lambda: rt.GraphRRG(96, 3, seed=23), "sparse", None),
    "lattice EA(4,3)": (lambda: rt.GraphEA(4, 3, (-1, 1), seed=5),
                        "lattice", None),
    "lattice EA(4,2) fields": (_fields_lattice, "lattice", None),
    "dense SK64": (lambda: rt.GraphSK(64, seed=3), "dense", None),
    "stream densify(RRG150)": (lambda: rt.densify(rt.GraphRRG(
        150, 3, (-1, 1), seed=21)), "stream", 64),
}
FLOAT_CASES = {
    "sparse RRGNormal96": (lambda: rt.GraphRRGNormal(96, 3, seed=5),
                           "sparse", None),
    "sparse EANormal(4,2)": (lambda: rt.GraphEANormal(4, 2, seed=7),
                             "sparse", None),
    "dense SKNormal64": (lambda: rt.GraphSKNormal(64, seed=3), "dense",
                         None),
    "stream SKNormal96": (lambda: rt.GraphSKNormal(96, seed=5), "stream",
                          32),
}


@pytest.fixture(scope="module")
def eo_pallas():
    with pallas_interpret("rrrmc_tpu.ops.eo_pallas",
                          "rrrmc_tpu.ops.prng") as (ep, jprng):
        yield ep, jprng


def _stream_tables(jm, W, flt):
    """The streamed kernel's tables at window W: J [NP, NP] (int8, or f32),
    h and the rank table as [NP, 1] columns (pad rows 0 and 2.0), and its
    search trip count (PallasEO's, which sends only large N there)."""
    N = jm.N
    NP = -(-N // W) * W
    J = np.zeros((NP, NP), np.float32 if flt else np.int8)
    J[:N, :N] = np.asarray(jm.J)
    h = np.zeros((NP, 1), np.float32 if flt else np.int32)
    h[:N, 0] = np.asarray(jm.h)
    cdf = np.full((NP, 1), 2.0, np.float32)
    cdf[:N, 0] = jax_rank_cdf(N, TAU)
    max_half = int(np.abs(np.asarray(jm.J, np.int64)).sum(1).max()
                   + np.abs(h).max()) if not flt else 0
    t_bits = 32 if flt else max(1, int(np.ceil(np.log2(2 * max_half + 2))))
    return J, h, cdf, t_bits


def _run_jax(ep, jm, kind, W, sigma, flt):
    """The TPU kernel's n-move chunk from sigma (Emin = E, sigma_min =
    sigma, itmin = 0, as PallasEO.run starts it); returns its outputs and
    the initial local fields."""
    N = jm.N
    lf0 = np.asarray(jax.vmap(jm.local_fields)(jnp.asarray(sigma)))
    E0 = np.asarray(jax.vmap(jm.energy)(jnp.asarray(sigma)))
    et = np.float32 if flt else np.int32
    E0, lf0 = E0.astype(et), lf0.astype(et)
    if kind == "stream":
        J, h, cdf, t_bits = _stream_tables(jm, W, flt)
        NP = J.shape[0]
    else:
        pe = ep.PallasEO(jm, TAU, block_chains=B)
        assert pe.kind == kind and pe.flt == flt, (pe.kind, pe.flt)
        NP = pe.NP
    sig = np.concatenate([sigma, np.ones((B, NP - N), np.int8)], axis=1)
    sig, E = jnp.asarray(sig), jnp.asarray(E0)
    zeros = jnp.zeros(B, jnp.int32)
    scal = (jnp.asarray([SEED], jnp.int32), jnp.asarray([N_MOVES], jnp.int32))
    if kind == "stream":
        out = ep._pallas_eo_stream_run(
            sig, E, E, sig, zeros, jnp.asarray(cdf), jnp.asarray(h),
            jnp.asarray(J), *scal, block_chains=B, t_bits=t_bits, n_phys=N,
            window=W, flt=flt)
    elif kind == "sparse":
        lfT = np.zeros((NP, B), et)
        lfT[:N] = lf0.T
        out = ep._pallas_eo_sparse_run(
            sig, jnp.asarray(lfT), E, E, sig, zeros, pe.cdf, pe.A, pe.B,
            *scal, block_chains=B, t_bits=pe.t_bits, n_phys=N, flt=flt)
    else:
        out = ep._pallas_eo_run(
            sig, E, E, sig, zeros, pe.cdf, pe.A, pe.B, *scal, L=pe.L, D=pe.D,
            block_chains=B, t_bits=pe.t_bits, dense=pe.dense, n_phys=N,
            flt=flt)
    s, E, emin, smin, itmin = (np.asarray(v) for v in out)
    return dict(sigma=s[:, :N], E=E, emin=emin, smin=smin[:, :N],
                itmin=itmin), lf0, E0


def _port_model(jm):
    if isinstance(jm, rt.FullyConnected):
        return pt.fully_connected_from_arrays(
            np.asarray(jm.J), np.asarray(jm.h), scale=jm.scale, **CPU)
    if isinstance(jm, rt.LatticeEA):
        return port_lattice(jm)
    return port_model(jm)


def _run_port(pm, sigma, lf0, E0, bits):
    """The port's plain EO moves from the same state and bits."""
    sig = torch.from_numpy(sigma.copy())
    lf = torch.from_numpy(lf0.copy())
    E = torch.from_numpy(E0.copy())
    emin, smin = E.clone(), sig.clone()
    itmin = torch.zeros(B, dtype=torch.int32)
    kw = dict(n_moves=N_MOVES, seed=SEED, bits=bits)
    cdf = rank_table(pm.N, TAU, "cpu")
    if isinstance(pm, pt.FullyConnected):
        eo_dense_chunk(sig, lf, E, emin, smin, itmin, kernel_couplings(pm),
                       cdf, **kw)
    else:
        eo_sparse_chunk(sig, lf, E, emin, smin, itmin, pm.neigh, pm.J, cdf,
                        **kw)
    return dict(sigma=sig, lf=lf, E=E, emin=emin, smin=smin, itmin=itmin)


def _case(eo_pallas, cases, name):
    ep, _ = eo_pallas
    build, kind, W = cases[name]
    jm = build()
    flt = not np.issubdtype(np.asarray(jm.J).dtype, np.integer)
    sigma = random_sigma(np.random.default_rng(8), B, jm.N)
    j, lf0, E0 = _run_jax(ep, jm, kind, W, sigma, flt)
    pm = _port_model(jm)
    p = _run_port(pm, sigma, lf0, E0, eo_bits(SEED, B, jm.N))
    return pm, {k: v.numpy() for k, v in p.items()}, j


@pytest.mark.parametrize("name", list(CASES))
def test_eo_matches_jax_interpret(eo_pallas, name):
    """Integer couplings: sigma, E, Emin, sigma_min and itmin EQUAL, and the
    resident local fields exact."""
    pm, p, j = _case(eo_pallas, CASES, name)
    for key in ("sigma", "E", "emin", "smin", "itmin"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    assert (j["itmin"] > 0).any()          # a best state was recorded
    np.testing.assert_array_equal(
        p["lf"], pm.local_fields(torch.from_numpy(p["sigma"])).numpy())


@pytest.mark.parametrize("name", list(FLOAT_CASES))
def test_float_eo_matches_jax_interpret(eo_pallas, name):
    """Float couplings: the TPU's dense kernels recompute lf = J sigma by an
    f32 matmul every move, the port adds the winner's row of J (the sparse
    kernels both update lf, in another order of the same roundings). So at
    most one chain of 128 may take another path (a last-bit difference can
    reorder two nearly equal keys); on the others sigma and sigma_min are
    equal and E and Emin agree within 1e-5 * N. itmin may differ where a
    chain returns to its best configuration: the last bits of the two
    float32 energies then decide whether the return is strictly lower."""
    pm, p, j = _case(eo_pallas, FLOAT_CASES, name)
    same = ((p["sigma"] == j["sigma"]).all(axis=1)
            & (p["smin"] == j["smin"]).all(axis=1))
    assert (~same).sum() <= 1, (~same).sum()
    for key in ("E", "emin"):
        np.testing.assert_allclose(p[key][same], j[key][same],
                                   atol=1e-5 * pm.N, rtol=0, err_msg=key)
    assert ((p["itmin"] >= 0) & (p["itmin"] <= N_MOVES)).all()


def test_eo_bits_helper_matches_jax_random_bits(eo_pallas):
    """eo_bits gives the JAX kernels' draws of move m: the rank at salt0 +
    2m ([1, B]) and the tie race at salt0 + 2m + 1 ([NP, B], its N physical
    rows), each the JAX random_bits in interpret mode."""
    _, jprng = eo_pallas
    N, NP, nb = 150, 192, 8
    bits = eo_bits(SEED, nb, N)
    s0 = _salt0(SEED)
    for m in (0, 5):
        rank = jax_random_bits(jprng, (1, nb), s0 + 2 * m)[0]
        np.testing.assert_array_equal(bits(m, prng.DRAW_EO_RANK).numpy(),
                                      rank)
        tie = jax_random_bits(jprng, (NP, nb), s0 + 2 * m + 1)[:N].T
        np.testing.assert_array_equal(bits(m, prng.DRAW_EO_TIE).numpy(), tie)


@pytest.mark.parametrize("n", [16, 150])
def test_rank_table_is_the_kernels_cast(eo_pallas, n):
    """The port's float32 rank table is the JAX kernels' cdf column: the
    float64 cumulative k^-tau table cast once."""
    ep, _ = eo_pallas
    pe = ep.PallasEO(rt.GraphSK(n, seed=1), TAU, block_chains=B)
    np.testing.assert_array_equal(rank_table(n, TAU, "cpu").numpy(),
                                  np.asarray(pe.cdf)[:n, 0])
