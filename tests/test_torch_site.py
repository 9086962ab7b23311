"""The port's single-site Metropolis (rrrmc_tpu_torch/ops/site.py) against the
JAX Pallas site kernel run in interpret mode, on identical tables, spins,
site schedule and random bits; and the port's kernel route through
standardMC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import site
from rrrmc_tpu_torch.ops.site import SiteSampler, site_chunk

from torch_port_helpers import (CPU, group_lengths_reference,
                                pallas_interpret, port_model, random_sigma,
                                site_bits)

torch.set_num_threads(1)

B = 128
N_MOVES = 200


@pytest.fixture(scope="module")
def site_pallas():
    with pallas_interpret("rrrmc_tpu.ops.site_pallas") as (sp,):
        yield sp


@pytest.mark.parametrize("coupling", ["pm_j", "normal"])
def test_site_chunk_matches_jax_interpret(site_pallas, coupling):
    """Integer couplings: sigma, lf, E and acc EQUAL. Float couplings: E and
    lf within 1e-4, sigma and acc equal on all chains but at most 1 in 128
    (an f32 rounding difference between XLA's and torch's exp can flip a
    borderline acceptance)."""
    from rrrmc_tpu.samplers.common import init_lfT

    jm = (rt.GraphRRG(64, 3, (-1, 1), seed=2) if coupling == "pm_j"
          else rt.GraphRRGNormal(64, 3, seed=1))
    flt = coupling == "normal"
    beta, seed = 1.5, 11
    rng = np.random.default_rng(5)
    sigma = random_sigma(rng, B, jm.N)
    sites = rng.integers(0, jm.N, N_MOVES).astype(np.int32)

    sig_j = jnp.asarray(sigma)
    lfT0 = np.asarray(init_lfT(jm, sig_j))
    E0 = np.asarray(jax.vmap(jm.energy)(sig_j))
    jd = jnp.float32 if flt else jnp.int32
    sig_o, E_o, lf_o, acc_o = site_pallas._pallas_site(
        sig_j, jnp.asarray(lfT0), jnp.asarray(E0), jnp.zeros(B, jnp.int32),
        jnp.asarray(sites), jm.neigh.reshape(-1).astype(jnp.int32),
        jm.J.reshape(-1).astype(jd), jnp.asarray([seed], jnp.int32),
        jnp.asarray([N_MOVES], jnp.int32),
        jnp.asarray([beta * jm.scale], jnp.float32), K=jm.K, block_chains=B)

    pm = port_model(jm)
    et = np.float32 if flt else np.int32
    sigT = torch.from_numpy(sigma.T.copy())
    lfT = torch.from_numpy(lfT0.copy())
    E = torch.from_numpy(E0.astype(et))
    acc = torch.zeros(B, dtype=torch.int32)
    site_chunk(sigT, lfT, E, acc, torch.from_numpy(sites), pm.neigh, pm.J,
               seed=seed, beta_s=beta * pm.scale, bits=site_bits(seed, B))

    sig_j, lf_j = np.asarray(sig_o), np.asarray(lf_o)
    acc_j = np.asarray(acc_o)
    if not flt:
        np.testing.assert_array_equal(sigT.numpy().T, sig_j)
        np.testing.assert_array_equal(lfT.numpy(), lf_j)
        np.testing.assert_array_equal(E.numpy(), np.asarray(E_o))
        np.testing.assert_array_equal(acc.numpy(), acc_j)
        assert acc_j.min() > 0
        return
    same = (sigT.numpy().T == sig_j).all(axis=1) & (acc.numpy() == acc_j)
    assert (~same).sum() <= 1, (~same).sum()
    dE_j = np.asarray(E_o, np.float64) - E0
    dE_p = E.numpy().astype(np.float64) - E0.astype(np.float32)
    np.testing.assert_allclose(dE_p[same], dE_j[same], atol=1e-4)
    np.testing.assert_allclose(lfT.numpy()[:, same], lf_j[:, same],
                               atol=1e-4)


def test_standardmc_kernel_route_cpu():
    """standardMC(backend="kernel") on CPU runs the plain site kernel:
    exact running energy, shapes, accepted counts in range."""
    m = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    Es, st = pt.standardMC(m, 1.5, 3000, step=1000, chains=B, seed=9,
                           backend="kernel", **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-site"
    assert pt.LAST_ROUTE["impl"] == "plain"
    assert Es.shape == (B, 3) and Es.dtype == torch.float32
    assert torch.equal(m.energy(st.sigma), st.E)
    assert torch.equal(m.local_fields(st.sigma), st.aux)
    a = st.accepted
    assert int(a.min()) >= 0 and int(a.max()) <= 3000 and float(
        a.double().mean()) > 0
    # the last checkpoint is the final state's energy
    assert torch.equal(Es[:, -1], st.E.to(torch.float32))


def test_standardmc_kernel_float_couplings():
    m = pt.GraphRRGNormal(64, 3, seed=1, **CPU)
    Es, st = pt.standardMC(m, 1.5, 3000, step=1000, chains=B, seed=9,
                           backend="kernel", **CPU)
    err = (m.energy(st.sigma).double() - st.E.double()).abs().max()
    assert float(err) < 2e-3
    assert int(st.accepted.min()) > 0


def test_sweep_schedule_covers_every_site():
    """beta = 0: every proposal accepts (up to a ~2^-25 bit edge), so ONE
    sweep of the permutation schedule flips EVERY spin exactly once."""
    m = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    st = pt.init_state(m, B, seed=1, **CPU)
    sigT = st.sigma.t().contiguous()
    lfT = m.local_fields(st.sigma).t().contiguous()
    E, acc = st.E.clone(), torch.zeros(B, dtype=torch.int32)
    ps = SiteSampler(m, 0.0)
    # one sweep split over two calls: the permutation phase carries over
    ps(sigT, lfT, E, acc, generator=st.generator, seed=3, n_moves=40,
       sweep_schedule=True)
    ps(sigT, lfT, E, acc, generator=st.generator, seed=3, n_moves=24,
       move0=40, sweep_schedule=True)
    assert torch.equal(sigT.t(), -st.sigma)
    assert torch.equal(E, m.energy(sigT.t().contiguous()))
    assert torch.equal(acc, torch.full((B,), 64, dtype=torch.int32))


# ---- the redesigned kernel's groups and launch plan (ops/site.py) ----


def _padded_graph(N, seed):
    """A sparse +-J graph with fields whose degrees run from 1 to 6, so its
    neighbour rows are padded with N (K = 6)."""
    rng = np.random.default_rng(seed)
    adj = [set() for _ in range(N)]
    for i in range(N):
        for j in rng.choice(N, size=rng.integers(1, 4), replace=False):
            if j != i and len(adj[i]) < 6 and len(adj[j]) < 6:
                adj[i].add(int(j))
                adj[j].add(int(i))
    for i in range(N):
        if not adj[i]:
            j = (i + 1) % N
            adj[i].add(j)
            adj[j].add(i)
    adj = [sorted(a) for a in adj]
    J = [[1.0 if (i + j) % 3 else -1.0 for j in a] for i, a in enumerate(adj)]
    return pt.make_pairwise(adj, J, N, h=rng.integers(-2, 3, N).astype(float),
                            integer_scale=1.0, **CPU)


#: (graph, schedule) cases of the group tests: random sites, the
#: site-sweep route's permutation schedule, padded rows, repeated sites
GROUP_CASES = {
    "rrg64-random": (lambda: pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU),
                     "random"),
    "rrg1000-random": (lambda: pt.GraphRRG(1000, 3, (-1, 1), seed=3, **CPU),
                       "random"),
    "rrg1000-perm": (lambda: pt.GraphRRG(1000, 3, (-1, 1), seed=3, **CPU),
                     "perm"),
    "padded-random": (lambda: _padded_graph(200, 4), "random"),
    "ea4d-random": (lambda: pt.GraphEA(4, 4, (-1, 1), seed=2, **CPU),
                    "random"),
    "rrg64-repeats": (lambda: pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU),
                      "repeats"),
}


def _schedule(m, kind, n=2000):
    from rrrmc_tpu_torch.ops.site import _perm_of

    rng = np.random.default_rng(11)
    if kind == "random":
        s = rng.integers(0, m.N, n)
    elif kind == "perm":
        s = np.concatenate([_perm_of(5, k, m.N) for k in range(-(-n // m.N))])
    else:   # runs of a repeated site among a few
        s = np.repeat(rng.integers(0, 8, n // 4), 4)
    return torch.as_tensor(s[:n].astype(np.int32))


def _closed(m, i):
    return {int(i)} | {int(x) for x in m.neigh[i] if int(x) != m.N}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_site_groups_disjoint_maximal(case):
    """site_groups cuts the schedule into groups of at most the cap whose
    closed neighbourhoods are pairwise disjoint (padding left out); each
    group ends at the cap or where the next move meets it; the cut kernel's
    plain version walks to the same groups."""
    build, kind = GROUP_CASES[case]
    m = build()
    sites = _schedule(m, kind)
    for cap in (32, 7, 1):
        lens = site.site_groups(sites, m.neigh, m.N, cap=cap)
        assert lens.sum() == sites.shape[0] and lens.min() >= 1
        assert lens.max() <= cap
        starts = np.concatenate([[0], np.cumsum(lens)])
        for a, b in zip(starts[:-1], starts[1:]):
            union = set()
            for i in sites[a:b].tolist():
                assert not union & _closed(m, i)
                union |= _closed(m, i)
            if b < sites.shape[0]:
                assert b - a == cap or union & _closed(m, int(sites[b]))
        walked = site.walk_groups(group_lengths_reference(sites, m.neigh,
                                                          m.N, cap))
        np.testing.assert_array_equal(walked, lens)
    if kind == "repeats":
        # a repeated site always cuts: no group holds a site twice
        assert (site.site_groups(sites, m.neigh, m.N) <= 4).all()


def test_group_lengths_refuses_cpu():
    """The cut kernel runs on the card only: a CPU schedule is refused, not
    cut on the host."""
    m = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    with pytest.raises(ValueError, match="no cut kernel"):
        site.group_lengths(_schedule(m, "random", 100), m.neigh, m.N)


def test_site_groups_lengths():
    """The lengths that make the kernel pay: on GraphRRG(10^4, 3) a random
    schedule's groups average over 25 moves at the cap of 32, GraphRRG(64,
    3)'s about 3."""
    big = pt.GraphRRG(10_000, 3, (-1, 1), seed=7, **CPU)
    s = torch.as_tensor(np.random.default_rng(1).integers(0, big.N, 20_000)
                        .astype(np.int32))
    assert 20_000 / len(site.site_groups(s, big.neigh, big.N)) > 25
    small = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    s = _schedule(small, "random")
    assert 2 < 2000 / len(site.site_groups(s, small.neigh, small.N)) < 5


@pytest.mark.parametrize("coupling", ["pm_j", "fields", "normal"])
@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_group_moves_commute(coupling, order):
    """Running the plain version with each group's moves reversed or
    shuffled (each move keeping its own bits) gives the schedule order's
    result bit for bit: spins, fields and counts, and E for integer
    couplings (float32 E sums in another order, so it may round apart)."""
    m = {"pm_j": lambda: pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU),
         "fields": lambda: _padded_graph(64, 5),
         "normal": lambda: pt.GraphRRGNormal(64, 3, seed=1, **CPU)}[
             coupling]()
    rng = np.random.default_rng(9)
    n, Bc = 600, 64
    sites = torch.as_tensor(rng.integers(0, m.N, n).astype(np.int32))
    bits = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (n, Bc),
                                        dtype=np.int64).astype(np.int32))
    perm = []
    lens = site.site_groups(sites, m.neigh, m.N)
    assert lens.max() > 1
    for a, ln in zip(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens):
        idx = np.arange(a, a + ln)
        perm.extend(idx[::-1] if order == "reversed" else rng.permutation(idx))
    perm = np.asarray(perm)
    st = pt.init_state(m, Bc, seed=3, **CPU)

    def run(sched, moves):
        sigT = st.sigma.t().contiguous()
        lfT = m.local_fields(st.sigma).t().contiguous()
        E, acc = st.E.clone(), torch.zeros(Bc, dtype=torch.int32)
        site.site_chunk_reference(
            sigT, lfT, E, acc, sched, m.neigh, m.J, seed=1, beta_s=1.2,
            bits=lambda k, d: bits[moves[k]])
        return sigT, lfT, E, acc

    a = run(sites, np.arange(n))
    b = run(sites[torch.as_tensor(perm)], perm)
    for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):
        assert torch.equal(x, y)
    if coupling == "normal":
        torch.testing.assert_close(a[2], b[2], rtol=0, atol=1e-4)
    else:
        assert torch.equal(a[2], b[2])
    assert int(a[3].sum()) > 0


@pytest.mark.parametrize("bound,want", [
    (3, torch.int8), (127, torch.int8), (128, torch.int16),
    (32767, torch.int16), (32768, torch.int32), (None, torch.int32)])
def test_site_field_type(bound, want):
    J = torch.zeros((4, 3), dtype=torch.int32)
    assert site.field_type(J, bound) == want
    assert site.field_type(J.float(), bound) == torch.float32


def test_site_sampler_bound():
    """SiteSampler's bound on |lf| is the family's half_bound: the largest
    row sum of |J| plus |h| (3 on +-J RRG(K=3)); None for float J."""
    from rrrmc_tpu_torch.samplers.families import half_bound

    for m in (pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU), _padded_graph(64, 5),
              pt.GraphRRGNormal(64, 3, seed=1, **CPU)):
        assert SiteSampler(m, 1.0).field_bound == half_bound(m)
    assert SiteSampler(pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU),
                       1.0).field_bound == 3


#: the H100's shared memory a SM and a block may have (opt-in), its SMs
SM_SMEM, BLOCK_SMEM, N_SM = 233472, 232448, 132


def _site_info(w, need):
    """site_plan's info(W, need) of a card like the H100: blocks per SM by
    shared memory (1 KB reserved a block), 64 warps and 32 blocks an SM;
    info(0, 0): the global kernel's."""
    if w == 0:
        return [32, 34, 0, 0, BLOCK_SMEM]
    return [min(SM_SMEM // (need + 1024), 64 // w, 32), 40, 0, 0, BLOCK_SMEM]


@pytest.mark.parametrize("N,B,field,route,chains", [
    (10_000, 1024, torch.int8, "resident", 4),    # the row: one wave
    (10_000, 1003, torch.int8, "resident", 4),    # ragged: the last block 3
    (10_000, 1024, torch.int32, "resident", 4),   # 50 KB a chain: 2 waves
    (10_000, 1024, torch.float32, "resident", 4),
    (10_000, 37, torch.int8, "resident", 1),      # fewer chains than SMs
    (116_224, 64, torch.int8, "resident", 1),     # the largest int8 chain
    (116_225, 64, torch.int8, "global", 32),      # above: global memory
    (46_480, 64, torch.float32, "resident", 1),   # the largest float32
    (46_490, 64, torch.float32, "global", 32)])
def test_site_plan(N, B, field, route, chains):
    p = site.site_plan(N, B, field, N_SM, _site_info)
    assert p["route"] == route and p["chains"] == chains
    assert p["field"] == str(field).replace("torch.", "")
    assert p["blocks"] == -(-B // chains)
    if route == "resident":
        assert p["smem"] == chains * site.chain_bytes(N, field) <= BLOCK_SMEM
        assert p["warps"] == chains and p["blocks_per_sm"] >= 1
    else:
        assert p["smem"] == 0


def test_site_chunk_cpu_takes_bound():
    """The plain version ignores the bound: one result with or without it."""
    m = pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU)
    st = pt.init_state(m, 8, seed=1, **CPU)
    sites = _schedule(m, "random", 300)
    outs = []
    for fb in (None, 3):
        sigT = st.sigma.t().contiguous()
        lfT = m.local_fields(st.sigma).t().contiguous()
        E, acc = st.E.clone(), torch.zeros(8, dtype=torch.int32)
        site_chunk(sigT, lfT, E, acc, sites, m.neigh, m.J, seed=4,
                   beta_s=1.0, field_bound=fb)
        outs.append((sigT, lfT, E, acc))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
