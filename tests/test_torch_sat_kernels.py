"""The port's K-SAT race and EO moves (rrrmc_tpu_torch/ops/sat.py and
ops/eo_sat.py, the plain versions of its CUDA kernels) against the JAX Pallas
kernels `_rejfree_sat_kernel` and `_eo_sat_kernel` run in interpret mode, on
identical clauses, spins and random bits (the race at salt 3m, the rrr
acceptance at 3m + 1, the bkl skip at 3m + 2; the EO rank at 2m, its tie race
at 2m + 1). Energies and counts are integers, so spins, E, coordinates,
accepted counts, both streams, Emin, sigma_min and itmin agree bit for bit;
the wtm clock and z/N within rtol 1e-6 (XLA's and torch's float32 exp/log may
differ in the last bit). The K = 4 case takes the TPU kernels' 3-bit count
fields. The plain version sums z as a block of 256 threads does, and in
one case per mode as a block of 512 does (the race kernel's other block
size)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
from rrrmc_tpu_torch.ops.eo_sat import eo_sat_chunk
from rrrmc_tpu_torch.ops.sat import (rejfree_sat_chunk,
                                     rejfree_sat_chunk_reference,
                                     sat_rejfree_ok, sat_tables)
from rrrmc_tpu_torch.ops.rejfree import coord_dtype
from rrrmc_tpu_torch.samplers.eo import rank_table

from torch_port_helpers import (eo_bits, pallas_interpret, port_sat,
                                race_bits, random_sigma)

torch.set_num_threads(1)

B = 128
N_MOVES = 48
BETA = 1.0
TAU = 1.4
SEED = 21
#: name -> JAX model (N = 30 pads to NP = 32 rows on the TPU)
MODELS = {
    "SAT(40, 3, 3.0)": lambda: rt.GraphSAT(40, 3, 3.0, seed=5),
    "SAT(30, 4, 2.5)": lambda: rt.GraphSAT(30, 4, 2.5, seed=7),
}


@pytest.fixture(scope="module")
def pallas():
    with pallas_interpret("rrrmc_tpu.ops.rejfree_pallas",
                          "rrrmc_tpu.ops.eo_pallas") as mods:
        yield mods


def _start(jm):
    sigma = random_sigma(np.random.default_rng(8), B, jm.N)
    E0 = np.asarray(jax.vmap(jm.energy)(jnp.asarray(sigma))).astype(np.int32)
    return sigma, E0


def _port_race(pm, sigma, E0, mode, target, NP, threads=None):
    """The wrapper (its plain version on the CPU), or the plain version
    summing z as a block of `threads` threads does."""
    chunk = rejfree_sat_chunk if threads is None else functools.partial(
        rejfree_sat_chunk_reference, threads=threads)
    sig = torch.from_numpy(sigma.copy())
    sat = pm.init_aux(sig)
    E = torch.from_numpy(E0.copy())
    coord = torch.zeros(B, dtype=coord_dtype(mode))
    acc = torch.zeros(B, dtype=torch.int32)
    zacc = torch.zeros(B, dtype=torch.float32)
    cs, es = chunk(
        sig, sat, E, coord, acc, zacc, *sat_tables(pm), mode=mode,
        n_moves=N_MOVES, beta_s=BETA * pm.scale, target=target, seed=SEED,
        bits=race_bits(SEED, B, pm.N, NP))
    return {k: v.numpy() for k, v in dict(
        sigma=sig, sat=sat, E=E, coord=coord, acc=acc, zacc=zacc, cs=cs,
        es=es).items()}


@pytest.mark.parametrize("mode,name,threads", [
    *(pytest.param(m, n, None, id=f"{m}-{n}")
      for m in ("bkl", "wtm", "rrr") for n in MODELS),
    *(pytest.param(m, "SAT(40, 3, 3.0)", 512,
                   id=f"{m}-SAT(40, 3, 3.0)-512threads")
      for m in ("bkl", "wtm", "rrr"))])
def test_race_matches_jax_interpret(pallas, mode, name, threads):
    """One chunk of N_MOVES moves from the same spins and bits; the target
    (the median coordinate of an unbounded run, half the chunk for rrr)
    stops chains mid-chunk, so the masking of finished chains is compared
    too. `threads`: the plain version at that block size's order of z."""
    rp, _ = pallas
    jm = MODELS[name]()
    pm = port_sat(jm)
    assert sat_rejfree_ok(pm)
    sigma, E0 = _start(jm)
    rf = rp.PallasRejectionFree(jm, BETA, mode, chunk_moves=N_MOVES)
    assert rf.kind == "sat"
    free = _port_race(pm, sigma, E0, mode, 1e30 if mode == "wtm" else 2 ** 30,
                      rf.NP, threads)
    target = {"wtm": float(np.median(free["coord"])),
              "bkl": int(np.median(free["coord"])),
              "rrr": N_MOVES // 2}[mode]
    ct = jnp.float32 if mode == "wtm" else jnp.int32
    out = rf.chunk(jnp.asarray(sigma), jnp.asarray(E0), jnp.zeros(B, ct),
                   seed=SEED, target=target)
    j = {k: np.asarray(v) for k, v in zip(
        ("sigma", "E", "coord", "acc", "zacc", "cs", "es"), out)}
    p = _port_race(pm, sigma, E0, mode, target, rf.NP, threads)
    done = (j["coord"] >= target).sum()
    assert 0 < done < B or mode == "rrr", done
    for key in ("sigma", "E", "acc", "es"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    if mode == "wtm":
        np.testing.assert_allclose(p["coord"], j["coord"], rtol=1e-6)
        np.testing.assert_allclose(p["cs"], j["cs"], rtol=1e-6)
    else:
        np.testing.assert_array_equal(p["coord"], j["coord"])
        np.testing.assert_array_equal(p["cs"], j["cs"])
    np.testing.assert_allclose(p["zacc"], j["zacc"], rtol=1e-6)
    # the resident counts stay exact
    np.testing.assert_array_equal(
        p["sat"], pm.init_aux(torch.from_numpy(p["sigma"])).numpy())


@pytest.mark.parametrize("name", list(MODELS))
def test_eo_matches_jax_interpret(pallas, name):
    """N_MOVES EO moves from the same spins and bits (the rank at salt 2m,
    the tie race at 2m + 1): sigma, E, Emin, sigma_min and itmin EQUAL."""
    _, ep = pallas
    jm = MODELS[name]()
    pm = port_sat(jm)
    sigma, E0 = _start(jm)
    pe = ep.PallasEO(jm, TAU, block_chains=B)
    assert pe.kind == "sat"
    out = pe.run(jnp.asarray(sigma), jnp.asarray(E0), N_MOVES, SEED)
    j = dict(zip(("sigma", "E", "emin", "smin", "itmin"),
                 (np.asarray(v) for v in out)))
    sig = torch.from_numpy(sigma.copy())
    sat = pm.init_aux(sig)
    E = torch.from_numpy(E0.copy())
    emin, smin = E.clone(), sig.clone()
    itmin = torch.zeros(B, dtype=torch.int32)
    eo_sat_chunk(sig, sat, E, emin, smin, itmin, *sat_tables(pm),
                 rank_table(pm.N, TAU, "cpu"), n_moves=N_MOVES, seed=SEED,
                 bits=eo_bits(SEED, B, pm.N))
    p = dict(sigma=sig, E=E, emin=emin, smin=smin, itmin=itmin)
    for key, v in p.items():
        np.testing.assert_array_equal(v.numpy(), j[key], err_msg=key)
    assert (j["itmin"] > 0).any()
    assert torch.equal(sat, pm.init_aux(sig))
