"""The port's dense (SK) sweep (rrrmc_tpu_torch/ops/sk.py) against the JAX
Pallas dense sweep kernel (`PallasSKSweeper`, both its VMEM and its
HBM-streamed variant) run in interpret mode, on identical couplings, spins
and random bits; its threshold table, Philox stream and argument checks;
and sweepMC_dense's two backends held against exact enumeration."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import sk
from rrrmc_tpu_torch.ops.sk import SKSweeper, sk_sweep_chunk

from torch_port_helpers import (CPU, _salt0, blocked_commit_reference,
                                hmax_table, jax_random_bits,
                                pallas_interpret, random_sigma, sk_bits)

torch.set_num_threads(1)

B = 128
SEED = 11
N_SWEEPS = 3


@pytest.fixture(scope="module")
def sk_pallas():
    with pallas_interpret("rrrmc_tpu.ops.sk_pallas",
                          "rrrmc_tpu.ops.prng") as (skp, prng):
        yield skp, prng


def _with_fields(m):
    h = np.random.RandomState(9).randint(-2, 3, size=m.N)
    return dataclasses.replace(m, h=jnp.asarray(h, m.h.dtype))


#: (JAX model, stream_j): two full windows; N = 200, a ragged last window
#: (the TPU pads it with free spins) through both TPU variants; and fields
CASES = {
    "N256": (lambda: rt.GraphSK(256, seed=1), False),
    "N200-vmem": (lambda: rt.GraphSK(200, seed=1), False),
    "N200-stream": (lambda: rt.GraphSK(200, seed=1), True),
    "N200-fields": (lambda: _with_fields(rt.GraphSK(200, seed=7)), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_matches_jax_interpret(sk_pallas, case):
    """Spins, local fields and energies EQUAL after 3 sweeps at beta=1.2:
    the integer arithmetic is exact, and the threshold table holds the TPU
    kernel's float32 thresholds."""
    skp, _ = sk_pallas
    build, stream = CASES[case]
    jm = build()
    sigma = random_sigma(np.random.default_rng(3), B, jm.N)
    E0 = np.asarray(jax.vmap(jm.energy)(jnp.asarray(sigma))).astype(np.int32)
    jsw = skp.PallasSKSweeper(jm, 1.2, window=128, block_chains=B,
                              stream_j=stream)
    sig_o, E_o, lfT = jsw(jnp.asarray(sigma), jnp.asarray(E0), seed=SEED,
                          n_sweeps=N_SWEEPS)

    pm = pt.fully_connected_from_arrays(np.asarray(jm.J), np.asarray(jm.h),
                                        scale=jm.scale, **CPU)
    psw = SKSweeper(pm, 1.2)
    sig = torch.from_numpy(sigma.copy())
    lf = pm.local_fields(sig)
    E = torch.from_numpy(E0.copy())
    psw(sig, lf, E, seed=SEED, n_sweeps=N_SWEEPS,
        bits=sk_bits(SEED, B, jm.N))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_o))
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_o))
    np.testing.assert_array_equal(lf.numpy(), np.asarray(lfT)[:jm.N].T)
    assert torch.equal(pm.energy(sig), E)
    assert not torch.equal(sig, torch.from_numpy(sigma))


def test_sk_bits_helper_matches_interpret_bits(sk_pallas):
    """The helper's bits of window w in sweep s are the JAX kernel's draw
    random_bits((W, B), salt0 + s * n_win + w), salt0 = program_seed(seed,
    0) * 1000003, in interpret mode."""
    _, prng = sk_pallas
    N, W = 300, 128
    s0 = int(prng.program_seed(jnp.int32(SEED), 0) * jnp.int32(1000003))
    assert s0 == _salt0(SEED)
    bits = sk_bits(SEED, 8, N)
    for sw, w in ((0, 0), (2, 1), (5, 2)):
        want = jax_random_bits(prng, (W, 8), s0 + sw * 3 + w).T
        np.testing.assert_array_equal(bits(sw, w).numpy(), want)


def test_threshold_table():
    """The table is the TPU kernel's float32 formula evaluated in numpy;
    XLA's float32 exp may differ from numpy's in the last bit, which moves a
    threshold by at most 1024 of 2^32 (p * 2^32 * 2^-22, plus the float32
    spacing of 256 near 2^31). It ends where the thresholds reach INT32_MIN
    (one entry later at most, for the same reason)."""
    for beta_s in (0.3, 2.0 / 32, 4.0 / 32):
        th = sk.accept_thresholds(beta_s, 8191)
        v = jnp.arange(1, 8192, dtype=jnp.int32) * 2
        p = jnp.exp(-jnp.float32(beta_s) * v.astype(jnp.float32))
        tj = np.asarray(jnp.clip(
            p * jnp.float32(4294967296.0) - jnp.float32(2147483648.0),
            jnp.float32(-2147483648.0),
            jnp.float32(2147483520.0)).astype(jnp.int32))
        n = th.shape[0]
        assert np.abs(th.astype(np.int64) - tj[:n]).max() <= 1024
        end = int(np.flatnonzero(tj == -2 ** 31)[0])
        assert abs(n - end) <= 1 and th.min() > -2 ** 31
    assert sk.accept_thresholds(0.0, 5).tolist() == [2147483520] * 5
    assert sk.accept_thresholds(50.0, 5).shape == (0,)


def test_split_runs_equal_one_launch():
    """Sweeps numbered from sweep0 continue one Philox stream: three
    launches of 2 sweeps equal one of 6. Keys follow the global chain id:
    the two halves of a batch, run with chain0, equal the whole batch."""
    pm = pt.GraphSK(150, seed=5, **CPU)
    psw = SKSweeper(pm, 1.0)
    st = pt.init_state(pm, 16, seed=4, **CPU)

    def run(sigma, E, parts, chain0=0):
        sigma, E = sigma.clone(), E.clone()
        lf = pm.local_fields(sigma)
        done = 0
        for n in parts:
            psw(sigma, lf, E, seed=SEED, n_sweeps=n, sweep0=done,
                chain0=chain0)
            done += n
        return sigma, lf, E

    whole = run(st.sigma, st.E, [6])
    split = run(st.sigma, st.E, [2, 2, 2])
    lo = run(st.sigma[:8], st.E[:8], [6])
    hi = run(st.sigma[8:], st.E[8:], [6], chain0=8)
    for i in range(3):
        assert torch.equal(whole[i], split[i])
        assert torch.equal(whole[i], torch.cat([lo[i], hi[i]]))
    assert torch.equal(pm.energy(whole[0]), whole[2])
    assert torch.equal(pm.local_fields(whole[0]), whole[1])


def test_wrapper_checks_arguments():
    pm = pt.GraphSK(16, seed=1, **CPU)
    psw = SKSweeper(pm, 1.0)
    st = pt.init_state(pm, 4, seed=2, **CPU)
    lf = pm.local_fields(st.sigma)
    kw = dict(n_sweeps=1, seed=1)
    with pytest.raises(ValueError, match="E"):
        sk_sweep_chunk(st.sigma, lf, st.E.float(), psw.J8, psw.th, **kw)
    with pytest.raises(ValueError, match="J8"):
        sk_sweep_chunk(st.sigma, lf, st.E, pm.J, psw.th, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sk_sweep_chunk(st.sigma, lf.t().contiguous().t(), st.E, psw.J8,
                       psw.th, **kw)
    big = pt.make_fully_connected(200 * (1 - np.eye(4)), scale=1.0, **CPU)
    for bad in (pt.GraphSKNormal(8, seed=1, **CPU), big):
        assert not sk.sk_sweep_eligible(bad)
        with pytest.raises(ValueError, match="127"):
            SKSweeper(bad, 1.0)


def _boltzmann_mean(model, beta):
    return float((pt.analysis.truep(model, beta)
                  * pt.analysis.energy_table(model)).sum())


#: (model builder, backend, beta, sweeps, window)
LAW = {
    "kernel-fields": (lambda: dataclasses.replace(
        pt.GraphSK(12, seed=7, **CPU),
        h=torch.as_tensor(np.random.RandomState(9).randint(-2, 3, 12),
                          dtype=torch.int32)), "kernel", 1.0, 160, 128),
    "torch-int": (lambda: pt.GraphSK(12, seed=2, **CPU), "torch", 1.2, 160,
                  4),
    "torch-float": (lambda: pt.GraphSKNormal(10, seed=4, **CPU), "torch",
                    1.2, 160, 5),
}


@pytest.mark.parametrize("name", list(LAW))
def test_sweepmc_dense_samples_boltzmann(name):
    """Each backend of sweepMC_dense reaches the exact Boltzmann mean energy
    (analysis.truep) within max(5 sigma, 0.05), sigma the standard error of
    the chain means; the running energy equals energy(sigma) (float J:
    within 1e-4 * N, float32 sums)."""
    build, backend, beta, sweeps, window = LAW[name]
    m = build()
    Es, st = pt.sweepMC_dense(m, beta, sweeps, step=2, chains=256, seed=7,
                              window=window, backend=backend, **CPU)
    route = "kernel-sk-sweep" if backend == "kernel" else "torch"
    assert pt.LAST_ROUTE["backend"] == route
    if m.J.dtype.is_floating_point:
        assert float((m.energy(st.sigma) - st.E).abs().max()) < 1e-4 * m.N
    else:
        assert torch.equal(m.energy(st.sigma), st.E)
        assert torch.equal(m.local_fields(st.sigma), st.aux)
    Es = Es.double().numpy()[:, Es.shape[1] // 4:]
    got = Es.mean()
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    want = _boltzmann_mean(m, beta)
    assert abs(got - want) < max(5 * sem, 0.05), (got, want, sem)


def test_sweepmc_dense_remainder_and_zero_sweeps():
    """The kernel backend runs a remainder of sweeps after the last
    checkpoint (as the JAX kernel route does); zero sweeps leave the state
    as it was."""
    m = pt.GraphSK(32, seed=3, **CPU)
    st0 = pt.init_state(m, 8, seed=2, **CPU)
    Es, st = pt.sweepMC_dense(m, 1.0, 0, chains=8, state=st0, **CPU)
    assert Es.shape == (8, 0) and torch.equal(st.sigma, st0.sigma)
    Es, st = pt.sweepMC_dense(m, 1.0, 5, step=2, chains=8, state=st0, **CPU)
    assert Es.shape == (8, 2) and torch.equal(m.energy(st.sigma), st.E)
    with pytest.raises(ValueError, match="FullyConnected"):
        pt.sweepMC_dense(pt.GraphRRG(16, 3, **CPU), 1.0, 2, **CPU)


# --- the redesigned kernel's arithmetic: hmax, the launch plan, the commit --

#: (beta_s, half_max): tables that end at INT32_MIN (cut before it) and at
#: half_max (beta_s small enough that no threshold reaches INT32_MIN), and
#: beta = 0 (every threshold clipped to its largest value)
HMAX_TABLES = {"ends-int32-min": (2.0 / 32, 4000),
               "ends-int32-min-steep": (0.5, 500),
               "ends-at-half-max": (0.004, 300),
               "beta-zero": (0.0, 40)}


@pytest.mark.parametrize("table", list(HMAX_TABLES))
def test_hmax_matches_table_comparison(table):
    """half <= hmax(u) is the kernel's whole decision: it must equal
    half <= 0 or (half <= n_th and u < th[half - 1]) for every half from
    -2 to n_th + 2 and words at, just above and just below each
    threshold (and the int32 extremes)."""
    beta_s, half_max = HMAX_TABLES[table]
    th = sk.accept_thresholds(beta_s, half_max)
    sk.check_thresholds(th)
    n_th = th.shape[0]
    if table == "ends-at-half-max":
        assert n_th == half_max and th[-1] > -2 ** 31
    elif table != "beta-zero":
        assert 0 < n_th < half_max
    t64 = th.astype(np.int64)
    u = np.unique(np.clip(np.concatenate(
        [t64 - 1, t64, t64 + 1, [-2 ** 31, -2 ** 31 + 1, 2 ** 31 - 1, 0]]),
        -2 ** 31, 2 ** 31 - 1)).astype(np.int32)
    tt = torch.from_numpy(th)
    hm = hmax_table(torch.from_numpy(u), tt).numpy()
    halves = np.arange(-2, n_th + 3)
    want = (halves[None, :] <= 0) | (
        (halves[None, :] <= n_th)
        & (u[:, None].astype(np.int64)
           < np.concatenate([t64, [-2 ** 31]])[np.clip(halves - 1, 0, n_th)]
           [None, :]))
    got = halves[None, :] <= hm[:, None]
    np.testing.assert_array_equal(got, want)
    assert hm.min() >= 0 and hm.max() <= n_th
    if n_th:
        assert hm.max() == n_th     # the smallest word passes every entry


def test_check_thresholds_refuses_an_increasing_table():
    """hmax equals the table comparison only on a table that does not
    increase: another is refused. accept_thresholds gives one for every
    beta (beta < 0 clips every entry to the largest threshold)."""
    with pytest.raises(ValueError, match="increase"):
        sk.check_thresholds(np.array([5, 7, 2], np.int32))
    sk.check_thresholds(np.array([7, 7, 2, -2 ** 31 + 1], np.int32))
    for beta_s in (-0.1, 0.0, 0.05, 3.0):
        sk.check_thresholds(sk.accept_thresholds(beta_s, 300))
    assert (sk.accept_thresholds(-0.1, 20) == 2147483520).all()


#: the shared memory an H100 block may opt in to
OPTIN = 232_448


@pytest.mark.parametrize("B", [1, 7, 8, 9, 1003, 1583, 1584, 2048, 8191])
def test_sweep_plan_every_n(B):
    """The launch plan for every N from 1 to 4096 and a few large N, at
    ragged B: the span is BLOCK_SPAN or N, its stride a whole number of
    64-site chunks, blocks of 16 chains cover B with a last block that may
    be ragged (B <= 8 included), the block's shared memory (the span's diagonal block of J and
    6 + hmax bytes a site a chain) fits the card, hmax takes 16 bits where
    the table fits, the J loads follow N's alignment, and the commit is the
    tensor-core product."""
    chains = sk.BLOCK_CHAINS
    assert chains == 16
    for N in list(range(1, 4097)) + [8192, 8193, 46_476, 100_000]:
        for n_th in (0, 65_535, 65_536):
            p = sk.sweep_plan(N, B, n_th)
            assert p["span"] == min(N, sk.BLOCK_SPAN) and p["path"] == "mma"
            assert p["stride"] % sk.CHUNK == 0
            assert p["span"] <= p["stride"] < p["span"] + sk.CHUNK
            assert p["chains"] == chains
            assert p["blocks"] * chains >= B > (p["blocks"] - 1) * chains
            hb = 2 if n_th < 65_536 else 4
            assert p["hmax_bytes"] == hb
            assert p["smem"] == (p["span"] * p["stride"]
                                 + chains * p["stride"] * (6 + hb))
            assert p["smem"] <= OPTIN
            assert p["loads"] == (16 if N % 16 == 0 else
                                  4 if N % 4 == 0 else 1)
    assert sk.sweep_plan(1024, B, 10, aligned16=False)["loads"] == 1


def _sym_int8(n, rng):
    a = rng.integers(-127, 128, size=(n, n))
    J = np.triu(a, 1)
    return torch.from_numpy((J + J.T).astype(np.int8))


#: (B, N, col0, length): ragged B (not a multiple of the block's 16
#: chains, fewer than 8 included), N not a multiple of the 16-row tile or of
#: 16 bytes, spans that end before a whole chunk, and the last span of a
#: model
COMMITS = [(19, 45, 0, 45), (19, 45, 13, 32), (37, 100, 64, 36),
           (37, 130, 0, 128), (5, 70, 64, 6), (24, 64, 0, 64)]


@pytest.mark.parametrize("case", COMMITS,
                         ids=[f"B{c[0]}-N{c[1]}-k{c[2]}+{c[3]}"
                              for c in COMMITS])
def test_blocked_commit_equals_sequential(case):
    """The kernel's commit, tile by tile through mma.m16n8k32's fragment
    layouts in the symmetric-J operand layout (`blocked_commit_reference`),
    equals the sequential commit lf += dlt J[span, :] on ragged B and N;
    the same tiles on an asymmetric J would not."""
    B, N, col0, length = case
    rng = np.random.default_rng(B * N + col0)
    J = _sym_int8(N, rng)
    sp = sk.span_stride(length)
    dlt = torch.from_numpy(rng.choice(np.array([-2, 0, 2], np.int8),
                                      size=(B, sp)))
    dlt[:, length:] = 0
    lf = torch.from_numpy(rng.integers(-5000, 5000, size=(B, N)).astype(
        np.int32))
    want = lf + (dlt[:, :length].double()
                 @ J[col0:col0 + length].double()).to(torch.int32)
    got = lf.clone()
    blocked_commit_reference(got, dlt, J, col0, length)
    assert torch.equal(got, want)
    Ja = J.clone()
    Ja[(col0 + 1) % N, col0] += 1   # off the diagonal: asymmetric
    seq = lf + (dlt[:, :length].double()
                @ Ja[col0:col0 + length].double()).to(torch.int32)
    bad = lf.clone()
    blocked_commit_reference(bad, dlt, Ja, col0, length)
    assert bool((dlt[:, 0] != 0).any()) and not torch.equal(bad, seq)


def test_refuses_asymmetric_couplings():
    """The commit reads J[span, n] as J[n, span]: an asymmetric J is refused
    when the sweeper is built."""
    rng = np.random.default_rng(3)
    J = _sym_int8(12, rng).numpy().astype(np.int32)
    J[2, 5] += 1
    m = pt.fully_connected_from_arrays(J, np.zeros(12, np.int32), scale=1.0,
                                       **CPU)
    assert sk.sk_sweep_eligible(m)
    with pytest.raises(ValueError, match="symmetric"):
        SKSweeper(m, 1.0)
    with pytest.raises(ValueError, match="symmetric"):
        sk.check_symmetric(torch.zeros((3, 4), dtype=torch.int8), "dense")
    sk.check_symmetric(_sym_int8(12, rng), "dense sweep")
