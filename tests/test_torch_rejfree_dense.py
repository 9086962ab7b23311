"""The port's dense race moves (rrrmc_tpu_torch/ops/rejfree_dense.py) against
the JAX Pallas dense race kernels run in interpret mode, on identical
couplings, spins and random bits, for bkl, wtm and rrr: the VMEM-resident
kernel (`_rejfree_dense_kernel`) and the HBM-streamed one
(`_rejfree_stream_kernel`, forced at small N with small windows), on
GraphSK and a densified RRG; float couplings (GraphSKNormal); the dense race
against the sparse one on the same graph; and the samplers' law."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import rejfree_dense
from rrrmc_tpu_torch.ops.rejfree import coord_dtype, rejfree_sparse_chunk
from rrrmc_tpu_torch.ops.rejfree_dense import (kernel_couplings,
                                               rejfree_dense_chunk)

from torch_port_helpers import (CPU, _salt0, dense_race_bits,
                                jax_random_bits, pallas_interpret,
                                random_sigma, stream_race_bits)

torch.set_num_threads(1)

B = 128
N_MOVES = 64
SEED = 21

#: (JAX model, beta, chunk targets): each bkl / wtm target stops about half
#: the chains mid-chunk, so the masking is compared too (rrr: all chains at
#: move 40)
MODELS = {
    "SK64": (lambda: rt.GraphSK(64, seed=5), 1.0,
             {"bkl": 135, "wtm": 2.2, "rrr": 40}),
    "denseRRG150": (lambda: rt.densify(rt.GraphRRG(150, 3, (-1, 1),
                                                   seed=21)), 2.0,
                    {"bkl": 500, "wtm": 3.2, "rrr": 40}),
}


@pytest.fixture(scope="module")
def rejfree_pallas():
    with pallas_interpret("rrrmc_tpu.ops.rejfree_pallas",
                          "rrrmc_tpu.ops.prng") as (rp, prng):
        yield rp, prng


@pytest.fixture
def stream_small(rejfree_pallas):
    """Small models take the streamed kernel with 32-row windows (as the
    JAX tests' `stream_small`), restored afterwards."""
    rp, _ = rejfree_pallas
    old = (rp._DENSE_NP_MAX, rp._STREAM_W, rp._STREAM_W_F)
    rp._DENSE_NP_MAX, rp._STREAM_W, rp._STREAM_W_F = 16, 32, 32
    yield rp
    rp._DENSE_NP_MAX, rp._STREAM_W, rp._STREAM_W_F = old


def port_dense(jm):
    return pt.fully_connected_from_arrays(np.asarray(jm.J), np.asarray(jm.h),
                                          scale=jm.scale, **CPU)


def _jax_chunk(rp, jm, beta, mode, sigma, E0, target):
    rf = rp.PallasRejectionFree(jm, beta, mode, chunk_moves=N_MOVES)
    ct = jnp.float32 if mode == "wtm" else jnp.int32
    out = rf.chunk(jnp.asarray(sigma), jnp.asarray(E0), jnp.zeros(B, ct),
                   seed=SEED, target=target)
    return rf, {k: np.asarray(v) for k, v in zip(
        ("sigma", "E", "coord", "acc", "zacc", "cs", "es"), out)}


def _port_chunk(pm, beta, mode, sigma, E0, target, bits=None, chain0=0):
    sig = torch.from_numpy(sigma.copy())
    lf = pm.local_fields(sig)
    E = torch.from_numpy(np.asarray(E0).copy()).to(lf.dtype)
    n = sig.shape[0]
    coord = torch.zeros(n, dtype=coord_dtype(mode))
    acc = torch.zeros(n, dtype=torch.int32)
    zacc = torch.zeros(n, dtype=torch.float32)
    cs, es = rejfree_dense_chunk(
        sig, lf, E, coord, acc, zacc, kernel_couplings(pm), mode=mode,
        n_moves=N_MOVES, beta_s=beta * pm.scale, target=target,
        seed=SEED, chain0=chain0, bits=bits)
    return dict(sigma=sig, lf=lf, E=E, coord=coord, acc=acc, zacc=zacc,
                cs=cs, es=es)


def _compare(p, j, mode, target):
    """Spins, E, acc and the E stream EQUAL; bkl / rrr coordinates EQUAL;
    the wtm clock and z/N within rtol 1e-6: the JAX kernels sum z as
    exp(-bE) directly or as a streamed log-sum-exp, the port as a shifted
    log-sum-exp in its own order, so those float32 sums differ in the last
    bits (2.5e-7 relative at most on these inputs)."""
    p = {k: v.numpy() for k, v in p.items()}
    done = (j["coord"] >= target).sum()
    assert 0 < done < B or mode == "rrr", done   # the masking is exercised
    for key in ("sigma", "E", "acc", "es"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    if mode == "wtm":
        np.testing.assert_allclose(p["coord"], j["coord"], rtol=1e-6)
        np.testing.assert_allclose(p["cs"], j["cs"], rtol=1e-6)
    else:
        np.testing.assert_array_equal(p["coord"], j["coord"])
        np.testing.assert_array_equal(p["cs"], j["cs"])
    np.testing.assert_allclose(p["zacc"], j["zacc"], rtol=1e-6)


def _inputs(jm):
    sigma = random_sigma(np.random.default_rng(8), B, jm.N)
    E0 = np.asarray(jax.vmap(jm.energy)(jnp.asarray(sigma))).astype(np.int32)
    return sigma, E0


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_chunk_matches_jax_dense_interpret(rejfree_pallas, mode, name):
    """The VMEM-resident TPU kernel (N padded to a lane multiple with frozen
    spins masked out of the race and z), see `_compare`."""
    rp, _ = rejfree_pallas
    build, beta, targets = MODELS[name]
    jm = build()
    sigma, E0 = _inputs(jm)
    rf, j = _jax_chunk(rp, jm, beta, mode, sigma, E0, targets[mode])
    assert rf.kind == "dense"
    pm = port_dense(jm)
    p = _port_chunk(pm, beta, mode, sigma, E0, targets[mode],
                    bits=dense_race_bits(SEED, B, jm.N, rf.Jb.shape[0]))
    _compare(p, j, mode, targets[mode])
    assert torch.equal(p["lf"], pm.local_fields(p["sigma"]))


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_chunk_matches_jax_stream_interpret(stream_small, mode, name):
    """The HBM-streamed TPU kernel, several 32-row blocks per move, its race
    drawn per block and z reduced as a streamed log-sum-exp, see
    `_compare`."""
    rp = stream_small
    build, beta, targets = MODELS[name]
    jm = build()
    sigma, E0 = _inputs(jm)
    rf, j = _jax_chunk(rp, jm, beta, mode, sigma, E0, targets[mode])
    assert rf.kind == "stream" and rf.Jhbm.shape[0] // rf.window > 1
    p = _port_chunk(port_dense(jm), beta, mode, sigma, E0, targets[mode],
                    bits=stream_race_bits(SEED, B, jm.N, rf.Jhbm.shape[0],
                                          rf.window))
    _compare(p, j, mode, targets[mode])


def test_float_chunk_matches_jax_stream(stream_small):
    """GraphSKNormal rides the float32 streamed TPU kernel, which recomputes
    lf = J sigma every move; the port adds the winner's row of J instead.
    At most one chain of 128 may diverge (a last-bit difference can flip a
    borderline race); on the others E within 1e-4, the bkl coordinate
    equal and z/N within rtol 1e-5."""
    rp = stream_small
    jm = rt.GraphSKNormal(96, seed=5)
    sigma = random_sigma(np.random.default_rng(8), B, jm.N)
    E0 = np.asarray(jax.vmap(jm.energy)(jnp.asarray(sigma)))
    rf, j = _jax_chunk(rp, jm, 1.0, "bkl", sigma, E0, 125)
    assert rf.kind == "stream" and rf.flt
    pm = port_dense(jm)
    p = _port_chunk(pm, 1.0, "bkl", sigma, E0.astype(np.float32), 125,
                    bits=stream_race_bits(SEED, B, jm.N, rf.Jhbm.shape[0],
                                          rf.window))
    p = {k: v.numpy() for k, v in p.items()}
    same = (p["sigma"] == j["sigma"]).all(axis=1) & (p["acc"] == j["acc"])
    assert (~same).sum() <= 1, (~same).sum()
    np.testing.assert_allclose(p["E"][same], j["E"][same], atol=1e-4)
    np.testing.assert_array_equal(p["coord"][same], j["coord"][same])
    np.testing.assert_allclose(p["zacc"][same], j["zacc"][same], rtol=1e-5)
    lf_re = pm.local_fields(torch.from_numpy(p["sigma"])).numpy()
    np.testing.assert_allclose(p["lf"], lf_re, atol=1e-4)


def test_stream_bits_helper_matches_interpret_bits(rejfree_pallas):
    """The streamed kernel's draws of move m: race block w at msalt + w,
    msalt = salt0 + m * (n_blk + 2), and the rrr acceptance / bkl skip at
    msalt + n_blk, each the JAX random_bits in interpret mode."""
    _, prng = rejfree_pallas
    N, NP, W, nb = 150, 192, 64, 8
    bits = stream_race_bits(SEED, nb, N, NP, W)
    s0 = _salt0(SEED)
    for m in (0, 3):
        msalt = s0 + m * (NP // W + 2)
        race = np.concatenate([jax_random_bits(prng, (W, nb), msalt + w)
                               for w in range(NP // W)])[:N].T
        np.testing.assert_array_equal(bits(m, 0).numpy(), race)
        second = jax_random_bits(prng, (1, nb), msalt + NP // W)[0]
        for d in (1, 2):
            np.testing.assert_array_equal(bits(m, d).numpy(), second)


@pytest.mark.parametrize("mode", ["bkl", "wtm", "rrr"])
def test_dense_race_equals_sparse_race(mode):
    """On a graph and its densified copy the two race kernels' plain
    versions make the same moves from the same Philox streams: the same
    race, the same z in the same order of additions, exact int32 fields."""
    m = pt.GraphRRG(150, 3, (-1, 1), seed=21, **CPU)
    d = pt.densify(m)
    sigma = random_sigma(np.random.default_rng(2), 32, m.N)
    target = {"bkl": 10 ** 6, "wtm": 1e9, "rrr": 10 ** 6}[mode]
    p = _port_chunk(d, 2.0, mode, sigma, m.energy(torch.from_numpy(sigma)),
                    target)
    sig = torch.from_numpy(sigma.copy())
    lf = m.local_fields(sig)
    E = m.energy(sig)
    coord = torch.zeros(32, dtype=coord_dtype(mode))
    acc = torch.zeros(32, dtype=torch.int32)
    zacc = torch.zeros(32)
    cs, es = rejfree_sparse_chunk(sig, lf, E, coord, acc, zacc, m.neigh, m.J,
                                  mode=mode, n_moves=N_MOVES,
                                  beta_s=2.0 * m.scale, target=target,
                                  seed=SEED)
    s = dict(sigma=sig, lf=lf, E=E, coord=coord, acc=acc, zacc=zacc, cs=cs,
             es=es)
    for key in s:
        assert torch.equal(p[key], s[key]), key


def test_chunk_independent_of_batch_layout():
    """Philox keys on the global chain id: two halves run with chain0
    offsets give the whole batch's results."""
    pm = pt.GraphSK(40, seed=3, **CPU)
    sigma = random_sigma(np.random.default_rng(9), 32, pm.N)
    E0 = pm.energy(torch.from_numpy(sigma))
    whole = _port_chunk(pm, 1.0, "bkl", sigma, E0, 10 ** 6)
    lo = _port_chunk(pm, 1.0, "bkl", sigma[:16], E0[:16], 10 ** 6)
    hi = _port_chunk(pm, 1.0, "bkl", sigma[16:], E0[16:], 10 ** 6, chain0=16)
    for key, v in whole.items():
        cat = torch.cat([lo[key], hi[key]], dim=1 if key in ("cs", "es")
                        else 0)
        assert torch.equal(v, cat), key


def test_dense_rejfree_ok_and_checks():
    ok = rejfree_dense.dense_rejfree_ok
    assert ok(pt.GraphSK(16, **CPU)) and ok(pt.GraphSKNormal(16, **CPU))
    assert not ok(pt.GraphSK(6, **CPU))                        # N < 8
    assert not ok(pt.make_fully_connected(200 * (1 - np.eye(8)), scale=1.0,
                                          **CPU))              # |J| > 127
    assert not ok(pt.GraphRRG(16, 3, **CPU))                   # sparse
    fl = pt.GraphSKNormal(8, seed=1, **CPU)
    assert not ok(dataclasses.replace(fl, J=torch.full((8, 8), np.inf)))
    m = pt.GraphSK(16, seed=1, **CPU)
    st = pt.init_state(m, 4, seed=2, **CPU)
    lf = m.local_fields(st.sigma)
    z = (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
         torch.zeros(4))
    kw = dict(mode="bkl", n_moves=2, beta_s=1.0, target=10, seed=1)
    with pytest.raises(ValueError, match="J"):
        rejfree_dense_chunk(st.sigma, lf, st.E, *z, m.J, **kw)
    with pytest.raises(ValueError, match="lf"):
        rejfree_dense_chunk(st.sigma, lf.float(), st.E, *z,
                            kernel_couplings(m), **kw)
    with pytest.raises(ValueError, match="mode"):
        rejfree_dense_chunk(st.sigma, lf, st.E, *z, kernel_couplings(m),
                            **dict(kw, mode="metropolis"))
    with pytest.raises(NotImplementedError, match="not eligible"):
        pt.bklMC(pt.GraphSK(6, **CPU), 1.0, 10, **CPU)


def _boltzmann_mean(model, beta):
    return float((pt.analysis.truep(model, beta)
                  * pt.analysis.energy_table(model)).sum())


def _fields_model():
    """An integer FullyConnected with fields (N=12), the JAX law test's."""
    rng = np.random.default_rng(13)
    A = rng.integers(-2, 3, size=(12, 12))
    h = rng.integers(-2, 3, size=12)
    return pt.make_fully_connected((A + A.T) * 0.25, h * 0.25, scale=0.25,
                                   **CPU)


#: sampler calls on the 12-spin model with fields and on GraphSKNormal(10)
LAW = {
    "bkl": lambda m, b: pt.bklMC(m, b, 6000, step=20, chains=128, seed=9,
                                 **CPU),
    "wtm": lambda m, b: pt.wtmMC(m, b, 300, step=20.0, chains=128, seed=9,
                                 **CPU),
    "rrr": lambda m, b: pt.rrrMC(m, b, 2048, step=8, chains=128, seed=9,
                                 **CPU),
}


@pytest.mark.parametrize("coupling", ["fields", "normal"])
@pytest.mark.parametrize("mode", list(LAW))
def test_samplers_match_boltzmann(mode, coupling):
    """The checkpoint series of bklMC / wtmMC / rrrMC on the dense race
    reaches the exact Boltzmann mean energy within max(5 sigma, 0.05)
    (bkl / wtm weight states by their holding times, so the skip and clock
    bookkeeping are checked too); the running energy equals energy(sigma),
    exactly for integer J and within 1e-4 * N for float J."""
    m = _fields_model() if coupling == "fields" else pt.GraphSKNormal(
        10, seed=4, **CPU)
    beta = 0.8
    Es, st = LAW[mode](m, beta)
    assert pt.LAST_ROUTE["backend"] == "kernel-rejfree-dense"
    if coupling == "fields":
        assert torch.equal(m.energy(st.sigma), st.E)
    else:
        assert float((m.energy(st.sigma) - st.E).abs().max()) < 1e-4 * m.N
    Es = Es.double().numpy()[:, Es.shape[1] // 4:]
    got = Es.mean()
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    want = _boltzmann_mean(m, beta)
    assert abs(got - want) < max(5 * sem, 0.05), (got, want, sem)


def test_warm_start_and_field_variant():
    """A second run continues from the returned state; a field variant made
    by dataclasses.replace keeps its own fields on the race route."""
    m = pt.densify(pt.GraphRRG(32, 3, (-1, 1), seed=21, **CPU))
    _, st = pt.wtmMC(m, 2.0, 20, step=5.0, chains=16, seed=5, **CPU)
    _, st2 = pt.wtmMC(m, 2.0, 20, step=5.0, state=st, **CPU)
    assert torch.equal(m.energy(st2.sigma), st2.E)
    assert int(st2.accepted.min()) > int(st.accepted.min()) >= 0
    f = dataclasses.replace(m, h=torch.ones(m.N, dtype=torch.int32))
    _, st3 = pt.bklMC(f, 2.0, 500, step=100, chains=16, seed=5, **CPU)
    assert torch.equal(f.energy(st3.sigma), st3.E)
