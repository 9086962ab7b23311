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
test_eo_xentr_picks_match_jax_interpret). The race's plain version sums z
(and xentr's tot) as a block of 256 threads does, and in one case per
family and mode as a block of 512 does (the race kernel's other block
size).

The race kernel reads the patterns as bits (ops/perc.py::pack_patterns) and
takes its integer product by popcounts (`_bits_product` below is its
arithmetic in plain torch): both are held against xi^T g in int64. Patterns
other than +-1 are refused (`perc_rejfree_ok`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops.eo_perc import eo_perc_chunk
from rrrmc_tpu_torch.ops.perc import (pack_patterns, perc_family,
                                      perc_rejfree_ok, perc_state,
                                      perc_tables, rejfree_perc_chunk,
                                      rejfree_perc_chunk_reference)
from rrrmc_tpu_torch.models.perceptron import gen_xi
from rrrmc_tpu_torch.ops import perc as perc_ops
from rrrmc_tpu_torch.samplers import families
from rrrmc_tpu_torch.samplers.families import family_of
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


def _port_race(pm, sigma, E0, mode, target, NP, threads=None):
    """The wrapper (its plain version on the CPU), or the plain version
    summing z and xentr's tot as a block of `threads` threads does."""
    chunk = rejfree_perc_chunk if threads is None else functools.partial(
        rejfree_perc_chunk_reference, threads=threads)
    sig = torch.from_numpy(sigma.copy())
    delta = pm.init_aux(sig)
    E = torch.from_numpy(E0.copy())
    coord = torch.zeros(B, dtype=coord_dtype(mode))
    acc = torch.zeros(B, dtype=torch.int32)
    zacc = torch.zeros(B, dtype=torch.float32)
    cs, es = chunk(
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


@pytest.mark.parametrize("mode,fam,threads", [
    *(pytest.param(m, f, t, id=f"{m}-{f}" + ("-512threads" if t else ""))
      for t in (None, 512) for m in ("bkl", "wtm", "rrr") for f in MODELS)])
def test_race_matches_jax_interpret(pallas, mode, fam, threads):
    """One chunk of N_MOVES moves from the same spins and bits; the target
    (the median coordinate of an unbounded run, half the chunk for rrr)
    stops chains mid-chunk, so the masking of finished chains is compared
    too. `threads`: the plain version at that block size's order of z and
    of xentr's tot."""
    rp, _ = pallas
    jm = MODELS[fam]()
    pm = port_perceptron(jm)
    assert perc_rejfree_ok(pm) and perc_family(pm) == fam
    sigma, E0 = _start(jm, fam)
    rf = rp.PallasRejectionFree(jm, BETA, mode, chunk_moves=N_MOVES)
    assert rf.kind == "perc"
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


def _popcount(x):
    """Set bits of each int64 value in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _bits_product(xb, g):
    """The race kernel's integer product (csrc/rejfree_perc.cu, the step and
    linear site): [B, N] sum_a xi_ai g_a for g [B, P] in {0, 1, 2} from the
    pattern bits xb [W, N], as the sum over the planes m = [g >= 1] and
    [g >= 2] (packed as the patterns are) and the words j of
    2 popc(x_ij & m_j) - popc(m_j)."""
    x = xb.to(torch.int64) & 0xFFFFFFFF                       # [W, N]
    proj = torch.zeros((g.shape[0], xb.shape[1]), dtype=torch.int64)
    for plane in (g >= 1, g >= 2):
        m = pack_patterns(torch.where(plane, 1, -1).t()).t().to(
            torch.int64) & 0xFFFFFFFF                         # [B, W]
        s = _popcount(x[None] & m[:, :, None]).sum(1)         # [B, N]
        proj += 2 * s - _popcount(m).sum(1, keepdim=True)
    return proj


@pytest.mark.parametrize("N", [15, 1023])
@pytest.mark.parametrize("P", [9, 31, 32, 33, 511])
def test_bit_product_matches_matmul(P, N):
    """The race kernel's patterns as bits (bit a % 32 of word a // 32, zero
    past P) and its popcount product give xi^T g exactly, in int64, for
    random +-1 patterns and g in {0, 1, 2} (P not a multiple of 32, N not
    a multiple of 4 included)."""
    rng = np.random.default_rng(P * 10_000 + N)
    xi = torch.from_numpy(gen_xi(N, P, rng))
    g = torch.from_numpy(rng.integers(0, 3, size=(6, P)))
    xb = pack_patterns(xi)
    W = -(-P // 32)
    assert xb.shape == (W, N) and xb.dtype == torch.int32
    words = xb.to(torch.int64) & 0xFFFFFFFF
    a = torch.arange(32 * W)
    bits = (words[a // 32] >> (a % 32)[:, None]) & 1
    assert torch.equal(bits[:P], (xi > 0).to(torch.int64))
    assert not bits[P:].any()
    assert torch.equal(_bits_product(xb, g), g @ xi.to(torch.int64))


def test_patterns_not_pm_one_are_refused():
    """A perceptron whose patterns hold a 0 is not eligible for the
    kernels (the model's formula and the race kernel's bits assume +-1
    patterns), and the race samplers refuse it."""
    N, P = 15, 9
    xi = gen_xi(N, P, np.random.default_rng(3))
    xi[4, 7] = 0
    m = pt.GraphPercStep(N, P, xi=xi, device="cpu")
    assert perc_family(m) == "step" and not perc_rejfree_ok(m)
    assert family_of(m) is None
    assert perc_rejfree_ok(pt.GraphPercStep(N, P, xi=gen_xi(
        N, P, np.random.default_rng(3)), device="cpu"))
    with pytest.raises(NotImplementedError, match=r"\+-1 patterns"):
        pt.bklMC(m, 1.0, 100, chains=4, device="cpu")


def test_pack_patterns_refuses_non_pm_one():
    """The packing takes +-1 patterns only: a 0 or a 2 has no bit."""
    xi = torch.from_numpy(gen_xi(15, 9, np.random.default_rng(4)))
    for bad in (0, 2):
        wrong = xi.clone()
        wrong[2, 3] = bad
        with pytest.raises(ValueError, match=r"\+-1 patterns"):
            pack_patterns(wrong)


def test_patterns_packed_once_per_call(monkeypatch):
    """A race sampler call packs the patterns once (`perc_tables`) and
    hands every chunk the same bits."""
    m = pt.GraphPercStep(31, 15, seed=5, device="cpu")
    packed, seen = [], []

    def pack(xi):
        packed.append(xi)
        return pack_patterns(xi)

    perc_race = next(f.race for f in families.FAMILIES if f.name == "perc")

    def race(*a, **kw):
        seen.append(a[9])
        return perc_race(*a, **kw)

    monkeypatch.setattr(perc_ops, "pack_patterns", pack)
    monkeypatch.setattr(families, "FAMILIES", tuple(
        f._replace(race=race) if f.name == "perc" else f
        for f in families.FAMILIES))
    pt.bklMC(m, 1.0, 600, step=100, chains=4, chunk_moves=64, device="cpu")
    assert len(packed) == 1 and len(seen) >= 2
    assert all(x is seen[0] for x in seen)
    assert torch.equal(seen[0], pack_patterns(m.xi))


def test_race_checks_pattern_bits():
    """The race wrapper checks the bits' shape [ceil(P/32), N] and dtype
    int32 as it checks the other tables."""
    m = pt.GraphPercStep(15, 33, seed=5, device="cpu")
    st = pt.init_state(m, 4, seed=SEED, device="cpu")
    delta, E = perc_state(m, st.sigma, st.E)
    xi4, xiT, loss, xb = perc_tables(m)
    assert xb.shape == (2, 15)
    z = torch.zeros(4, dtype=torch.int32)
    for wrong in (xb[:1], xb.to(torch.int64)):
        with pytest.raises(ValueError, match="xb"):
            rejfree_perc_chunk(st.sigma, delta, E, z.clone(), z.clone(),
                               torch.zeros(4), xi4, xiT, loss, wrong,
                               mode="bkl", n_moves=4, beta_s=1.0,
                               target=10, seed=SEED)
