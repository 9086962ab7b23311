"""The port's perceptron race and EO moves (rrrmc_tpu_torch/ops/perc.py and
ops/eo_perc.py, the plain versions of its CUDA kernels) against the JAX
Pallas kernels `_rejfree_perc_kernel` and `_eo_perc_kernel` run in
interpret mode, on identical patterns, spins and random bits (the race at
salt 3m, the rrr acceptance at 3m + 1, the bkl skip at 3m + 2; the EO rank
at 2m, its tie race at 2m + 1). Each case has its own patterns: the JAX
package caches a perceptron's family on id(xi).

Step and linear energies and stabilities are integers, so spins, E,
coordinates, accepted counts, both streams, Emin, sigma_min and itmin agree
bit for bit; the wtm clock and z/N within rtol 1e-6 (XLA's and torch's
float32 exp and log may differ in the last bit). Xentr's dE is a float32
sum of P terms, which XLA and the port add in different orders: at most one
chain of 128 may take another path, and on the others E, Emin and the
energy streams agree within 1e-5 * max(1, |E|), z/N and the wtm clock
within rtol 1e-5. Its EO moves are held one at a time (see
test_eo_xentr_picks_match_jax_interpret)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
from rrrmc_tpu_torch.ops.eo_perc import eo_perc_chunk
from rrrmc_tpu_torch.ops.perc import (perc_family, perc_rejfree_ok,
                                      perc_tables, rejfree_perc_chunk)
from rrrmc_tpu_torch.ops.rejfree import coord_dtype
from rrrmc_tpu_torch.samplers.eo import rank_table

from torch_port_helpers import (eo_bits, pallas_interpret, port_perceptron,
                                race_bits, random_sigma)

torch.set_num_threads(1)

B = 128
N_MOVES = 48
BETA = 1.0
TAU = 1.4
SEED = 21
#: family -> JAX model, each with its own patterns
MODELS = {
    "step": lambda: rt.GraphPercStep(31, 15, seed=5),
    "linear": lambda: rt.GraphPercLinear(31, 15, seed=6),
    "xentr": lambda: rt.GraphPercXEntr(31, 15, 1.0, seed=7),
}
FLOAT_RTOL = 1e-5
#: moves of the move-by-move xentr EO comparison
XENTR_EO_MOVES = 24


@pytest.fixture(scope="module")
def pallas():
    with pallas_interpret("rrrmc_tpu.ops.perc_pallas",
                          "rrrmc_tpu.ops.rejfree_pallas",
                          "rrrmc_tpu.ops.eo_pallas") as mods:
        yield mods[1:]


def _start(jm, fam):
    sigma = random_sigma(np.random.default_rng(8), B, jm.N)
    E0 = np.asarray(jax.vmap(jm.energy)(jnp.asarray(sigma)))
    return sigma, E0.astype(np.float32 if fam == "xentr" else np.int32)


def _port_race(pm, sigma, E0, mode, target, NP):
    sig = torch.from_numpy(sigma.copy())
    delta = pm.init_aux(sig)
    E = torch.from_numpy(E0.copy())
    coord = torch.zeros(B, dtype=coord_dtype(mode))
    acc = torch.zeros(B, dtype=torch.int32)
    zacc = torch.zeros(B, dtype=torch.float32)
    cs, es = rejfree_perc_chunk(
        sig, delta, E, coord, acc, zacc, *perc_tables(pm), mode=mode,
        n_moves=N_MOVES, beta_s=BETA * pm.scale, target=target, seed=SEED,
        bits=race_bits(SEED, B, pm.N, NP))
    return {k: v.numpy() for k, v in dict(
        sigma=sig, delta=delta, E=E, coord=coord, acc=acc, zacc=zacc, cs=cs,
        es=es).items()}


def _close(a, b, key, same=None):
    """The float rule: equal on integers, within FLOAT_RTOL * max(1, |b|)
    on floats, over the chains `same` (the last axis)."""
    if same is not None:
        a, b = a[..., same], b[..., same]
    if np.issubdtype(np.asarray(b).dtype, np.floating):
        tol = FLOAT_RTOL * np.maximum(1.0, np.abs(b))
        assert (np.abs(a.astype(np.float64) - b) <= tol).all(), key
    else:
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("fam", list(MODELS))
@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_race_matches_jax_interpret(pallas, mode, fam):
    """One chunk of N_MOVES moves from the same spins and bits; the target
    (the median coordinate of an unbounded run, half the chunk for rrr)
    stops chains mid-chunk, so the masking of finished chains is compared
    too."""
    rp, _ = pallas
    jm = MODELS[fam]()
    pm = port_perceptron(jm)
    assert perc_rejfree_ok(pm) and perc_family(pm) == fam
    sigma, E0 = _start(jm, fam)
    rf = rp.PallasRejectionFree(jm, BETA, mode, chunk_moves=N_MOVES)
    assert rf.kind == "perc"
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
    # the stabilities stay exact
    np.testing.assert_array_equal(
        p["delta"], pm.init_aux(torch.from_numpy(p["sigma"])).numpy())
    rtol = 1e-6
    if fam == "xentr":
        same = (p["sigma"] == j["sigma"]).all(axis=1) & (p["acc"] == j["acc"])
        if mode != "wtm":
            same &= p["coord"] == j["coord"]
        assert (~same).sum() <= 1, (~same).sum()
        rtol = FLOAT_RTOL
    else:
        same = np.ones(B, bool)
        for key in ("sigma", "acc"):
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    for key in ("E", "es"):
        _close(p[key], j[key], key, same)
    if mode == "wtm":
        np.testing.assert_allclose(p["coord"][same], j["coord"][same],
                                   rtol=rtol)
        np.testing.assert_allclose(p["cs"][:, same], j["cs"][:, same],
                                   rtol=rtol)
    else:
        np.testing.assert_array_equal(p["coord"][same], j["coord"][same])
        np.testing.assert_array_equal(p["cs"][:, same], j["cs"][:, same])
    np.testing.assert_allclose(p["zacc"][same], j["zacc"][same], rtol=rtol)


def _port_eo(pm, sigma, E0, n_moves, seed):
    sig = torch.from_numpy(sigma.copy())
    delta = pm.init_aux(sig)
    E = torch.from_numpy(E0.copy())
    emin, smin = E.clone(), sig.clone()
    itmin = torch.zeros(B, dtype=torch.int32)
    eo_perc_chunk(sig, delta, E, emin, smin, itmin, *perc_tables(pm),
                  rank_table(pm.N, TAU, "cpu"), n_moves=n_moves, seed=seed,
                  bits=eo_bits(seed, B, pm.N))
    assert torch.equal(delta, pm.init_aux(sig))
    return {k: v.numpy() for k, v in dict(sigma=sig, E=E, emin=emin,
                                          smin=smin, itmin=itmin).items()}


@pytest.mark.parametrize("fam", ["step", "linear"])
def test_eo_matches_jax_interpret(pallas, fam):
    """N_MOVES EO moves from the same spins and bits (the rank at salt 2m,
    the tie race at 2m + 1): sigma, E, Emin, sigma_min and itmin EQUAL."""
    _, ep = pallas
    jm = MODELS[fam]()
    pm = port_perceptron(jm)
    sigma, E0 = _start(jm, fam)
    pe = ep.PallasEO(jm, TAU, block_chains=B)
    assert pe.kind == "perc"
    out = pe.run(jnp.asarray(sigma), jnp.asarray(E0), N_MOVES, SEED)
    j = dict(zip(("sigma", "E", "emin", "smin", "itmin"),
                 (np.asarray(v) for v in out)))
    p = _port_eo(pm, sigma, E0, N_MOVES, SEED)
    for key, v in p.items():
        np.testing.assert_array_equal(v, j[key], err_msg=key)
    assert (j["itmin"] > 0).any()


def test_eo_xentr_picks_match_jax_interpret(pallas):
    """Xentr's EO keys are float32 sums whose exact ties (patterns sharing a
    stability give equal g) round differently in XLA's order and the
    port's, so a whole run cannot follow the JAX one. Each of XENTR_EO_MOVES
    moves is therefore held alone, from the port's state, with the move's
    seed: where a chain picks another site than the JAX kernel, both picks
    have the same dE within FLOAT_RTOL (a rounded tie), and fewer than 5% of
    the picks differ (about 1%); elsewhere E agrees within
    FLOAT_RTOL * max(1, |E|)."""
    _, ep = pallas
    jm = MODELS["xentr"]()
    pm = port_perceptron(jm)
    sigma, E = _start(jm, "xentr")
    pe = ep.PallasEO(jm, TAU, block_chains=B)
    rows = np.arange(B)
    n_other = 0
    for k in range(XENTR_EO_MOVES):
        seed = SEED + k
        out = pe.run(jnp.asarray(sigma), jnp.asarray(E), 1, seed)
        js, jE = np.asarray(out[0]), np.asarray(out[1])
        p = _port_eo(pm, sigma, E, 1, seed)
        jw = (js != sigma).argmax(axis=1)
        pw = (p["sigma"] != sigma).argmax(axis=1)
        sig = torch.from_numpy(sigma).to(torch.int32)
        de = pm.delta_all(sig, pm.init_aux(sig)).numpy()
        other = jw != pw
        n_other += int(other.sum())
        a, b = de[rows, jw][other], de[rows, pw][other]
        assert (np.abs(a - b) <= FLOAT_RTOL * np.maximum(1, np.abs(a))).all()
        _close(p["E"], jE, "E", ~other)
        sigma, E = p["sigma"], p["E"]
    assert n_other <= 0.05 * B * XENTR_EO_MOVES, n_other
