"""The port's PSpin3 race and EO moves (rrrmc_tpu_torch/ops/pspin.py and
ops/eo_pspin.py, the plain versions of its CUDA kernels) against the JAX
Pallas kernels `_rejfree_pspin_kernel` and `_eo_pspin_kernel` run in interpret
mode, on identical partner tables, spins and random bits. Energies and cavity
sums are integers, so spins, E, coordinates, accepted counts, both streams,
Emin, sigma_min and itmin agree bit for bit; the wtm clock and z/N within rtol
1e-6 (XLA's and torch's float32 exp/log may differ in the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
from rrrmc_tpu_torch.ops.eo_pspin import eo_pspin_chunk
from rrrmc_tpu_torch.ops.pspin import pspin_rejfree_ok, rejfree_pspin_chunk
from rrrmc_tpu_torch.ops.rejfree import coord_dtype
from rrrmc_tpu_torch.samplers.eo import rank_table

from torch_port_helpers import (eo_bits, pallas_interpret, port_pspin,
                                race_bits, random_sigma)

torch.set_num_threads(1)

B = 128
N_MOVES = 48
BETA = 1.0
TAU = 1.4
SEED = 21
#: name -> JAX model (N = 30 pads to NP = 32 rows on the TPU)
MODELS = {
    "PSpin3(48, 3)": lambda: rt.GraphPSpin3(48, 3, seed=3),
    "PSpin3(30, 4)": lambda: rt.GraphPSpin3(30, 4, seed=5),
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


def _port_race(pm, sigma, E0, mode, target, NP):
    sig = torch.from_numpy(sigma.copy())
    c = pm.local_fields(sig)
    E = torch.from_numpy(E0.copy())
    coord = torch.zeros(B, dtype=coord_dtype(mode))
    acc = torch.zeros(B, dtype=torch.int32)
    zacc = torch.zeros(B, dtype=torch.float32)
    cs, es = rejfree_pspin_chunk(
        sig, c, E, coord, acc, zacc, pm.A, mode=mode, n_moves=N_MOVES,
        beta_s=BETA * pm.scale, target=target, seed=SEED,
        bits=race_bits(SEED, B, pm.N, NP))
    return {k: v.numpy() for k, v in dict(
        sigma=sig, c=c, E=E, coord=coord, acc=acc, zacc=zacc, cs=cs,
        es=es).items()}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_race_matches_jax_interpret(pallas, mode, name):
    """One chunk of N_MOVES moves from the same spins and bits; the target
    (the median coordinate of an unbounded run, half the chunk for rrr)
    stops chains mid-chunk, so the masking of finished chains is compared
    too."""
    rp, _ = pallas
    jm = MODELS[name]()
    pm = port_pspin(jm)
    assert pspin_rejfree_ok(pm)
    sigma, E0 = _start(jm)
    rf = rp.PallasRejectionFree(jm, BETA, mode, chunk_moves=N_MOVES)
    assert rf.kind == "pspin"
    free = _port_race(pm, sigma, E0, mode, 1e30 if mode == "wtm" else 2 ** 30,
                      rf.NP)
    target = {"wtm": float(np.median(free["coord"])),
              "bkl": int(np.median(free["coord"])),
              "rrr": N_MOVES // 2}[mode]
    ct = jnp.float32 if mode == "wtm" else jnp.int32
    out = rf.chunk(jnp.asarray(sigma), jnp.asarray(E0), jnp.zeros(B, ct),
                   seed=SEED, target=target)
    j = {k: np.asarray(v) for k, v in zip(
        ("sigma", "E", "coord", "acc", "zacc", "cs", "es"), out)}
    p = _port_race(pm, sigma, E0, mode, target, rf.NP)
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
    # the resident cavity sums stay exact
    np.testing.assert_array_equal(
        p["c"], pm.local_fields(torch.from_numpy(p["sigma"])).numpy())


@pytest.mark.parametrize("name", list(MODELS))
def test_eo_matches_jax_interpret(pallas, name):
    """N_MOVES EO moves from the same spins and bits (the rank at salt 2m,
    the tie race at 2m + 1): sigma, E, Emin, sigma_min and itmin EQUAL."""
    _, ep = pallas
    jm = MODELS[name]()
    pm = port_pspin(jm)
    sigma, E0 = _start(jm)
    pe = ep.PallasEO(jm, TAU, block_chains=B)
    assert pe.kind == "pspin"
    out = pe.run(jnp.asarray(sigma), jnp.asarray(E0), N_MOVES, SEED)
    j = dict(zip(("sigma", "E", "emin", "smin", "itmin"),
                 (np.asarray(v) for v in out)))
    sig = torch.from_numpy(sigma.copy())
    c = pm.local_fields(sig)
    E = torch.from_numpy(E0.copy())
    emin, smin = E.clone(), sig.clone()
    itmin = torch.zeros(B, dtype=torch.int32)
    eo_pspin_chunk(sig, c, E, emin, smin, itmin, pm.A,
                   rank_table(pm.N, TAU, "cpu"), n_moves=N_MOVES, seed=SEED,
                   bits=eo_bits(SEED, B, pm.N))
    p = dict(sigma=sig, E=E, emin=emin, smin=smin, itmin=itmin)
    for key, v in p.items():
        np.testing.assert_array_equal(v.numpy(), j[key], err_msg=key)
    assert (j["itmin"] > 0).any()
    assert torch.equal(c, pm.local_fields(sig))
