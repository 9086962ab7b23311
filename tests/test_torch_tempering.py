"""The port's replica exchange (rrrmc_tpu_torch/parallel/tempering.py)
against the JAX package's (rrrmc_tpu/parallel/tempering.py):

1. the rank swap, the ensemble swap and `energies_by_rank` equal the JAX
   functions exactly on the same energies, ranks, spins and uniforms;
2. the laws, as tests/test_parallel.py and tests/test_tempered_ensembles.py
   hold the JAX package: per-rung means against exact Boltzmann means,
   ranks and walkers that stay permutations, running energies equal to
   energy(sigma);
3. the site kernel's beta per chain: its plain version with one beta in
   every chain equals the scalar call, and with distinct betas each chain
   equals a run of that chain alone at its own beta.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu.parallel import tempering as jt
from rrrmc_tpu_torch.ops.site import site_chunk
from rrrmc_tpu_torch.parallel import tempering as tt

from torch_port_helpers import (CPU, port_composite, port_lattice,
                                random_sigma)

torch.set_num_threads(1)

BETAS = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0]


def exact_mean_energy(model, beta):
    """The Boltzmann mean of the physical energy over all 2^N states."""
    n = model.N
    bits = (np.arange(2 ** n)[:, None] >> np.arange(n)) & 1
    states = torch.tensor((2 * bits - 1).astype(np.int8))
    E = model.to_physical(model.energy(states)).double().numpy()
    w = np.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


# ---- 1. the swaps against the JAX functions ----

_jax_swap = jax.jit(jt._swap_ranks, static_argnums=(4, 5))


@pytest.mark.parametrize("T", [2, 3, 8])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("ties", [False, True])
def test_swap_ranks_matches_jax(T, parity, ties):
    """New ranks and the moved mask EQUAL JAX `_swap_ranks` on the same
    energies, ranks, betas and uniforms (ties: energies from three values,
    so that many adjacent rungs hold equal energies and swap surely)."""
    B = 64
    rng = np.random.default_rng(100 * T + 10 * parity + ties)
    E = (rng.integers(-1, 2, (T, B)) * 4.0 if ties
         else rng.normal(0.0, 3.0, (T, B)))
    rank = np.stack([rng.permutation(T) for _ in range(B)], 1).astype(
        np.int32)
    betas = np.linspace(0.4, 2.5, T)
    u = rng.random((T, B))
    new_j, moved_j = _jax_swap(jnp.asarray(E), jnp.asarray(rank),
                               jnp.asarray(betas), jnp.asarray(u), parity,
                               None)
    new_p, moved_p = tt.swap_ranks(torch.tensor(E), torch.tensor(rank),
                                   torch.tensor(betas), torch.tensor(u),
                                   parity)
    np.testing.assert_array_equal(new_p.numpy(), np.asarray(new_j))
    np.testing.assert_array_equal(moved_p.numpy(), np.asarray(moved_j))
    for b in range(B):
        assert sorted(new_p[:, b].tolist()) == list(range(T))
    if ties and parity < T - 1:     # some pair leads this round
        assert bool(moved_p.any())


def test_energies_by_rank_matches_jax():
    rng = np.random.default_rng(4)
    rounds, T, B = 5, 6, 7
    Es = rng.normal(size=(rounds, T, B)).astype(np.float32)
    ranks = np.stack([np.stack([rng.permutation(T) for _ in range(B)], 1)
                      for _ in range(rounds)]).astype(np.int32)
    want = jt.energies_by_rank(Es, ranks)
    got = pt.energies_by_rank(torch.tensor(Es), torch.tensor(ranks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ladders():
    """(JAX models, port models, betas): a beta ladder of one GraphEA(4, 2)
    and a Gamma ladder of GraphQuant(3, 3, Gamma, 1) over one GraphSK(3)."""
    ea = rt.GraphEA(4, 2, (-1, 1), seed=3)
    base = rt.GraphSK(3, seed=5)
    quant = [rt.GraphQuant(3, 3, g, 1.0, base) for g in (0.3, 0.8, 1.5)]
    return {"beta": ([ea] * 4, [port_lattice(ea)] * 4, [0.5, 1.0, 1.5, 2.0]),
            "gamma": (quant, [port_composite(m) for m in quant],
                      [1.0, 1.0, 1.0])}


@pytest.mark.parametrize("ladder", ["beta", "gamma"])
def test_ensemble_swap_matches_jax(ladder):
    """Six swap rounds of the port's `ensemble_swap` against JAX
    `_ensemble_round` with an identity slot kernel and JAX's own uniforms
    (fold_in(key(seed ^ 0x7E3B), i)), from the same spins: the same pairs
    swap, so walkers, swap counts and spins are EQUAL, energies equal
    (integer) or within 1e-5 (the float32 physical energies of the port's
    composites against JAX's float64)."""
    from rrrmc_tpu.samplers.common import init_state as j_init_state

    jms, pms, betas = _ladders()[ladder]
    T, B, seed = len(jms), 32, 9
    slots = tuple(j_init_state(m, B, seed + 7919 * t)
                  for t, m in enumerate(jms))
    jst = jt.ETState(slots=slots,
                     walker=jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)
                                             [:, None], (T, B)),
                     swap_acc=jnp.zeros((T, B), jnp.int32))
    pst = pt.et_state_from_arrays(pms, [np.asarray(s.sigma) for s in slots],
                                  **CPU)
    p_slots, walker, swap_acc = pst.slots, pst.walker, pst.swap_acc
    base_key = jax.random.key(seed ^ 0x7E3B)
    jax_round = jax.jit(functools.partial(
        jt._ensemble_round, tuple(jms), tuple(betas), 1,
        lambda m, b, n, st: st, None))
    swaps = 0
    for i in range(6):
        key = jax.random.fold_in(base_key, i)
        u = jax.random.uniform(key, (max(T - 1, 1), B), jnp.float64)
        jst, E_j = jax_round(jst, key, i % 2)
        p_slots, acc, E_p = tt.ensemble_swap(pms, betas, p_slots,
                                             torch.tensor(np.asarray(u)),
                                             i % 2)
        walker = tt.exchange(walker, acc)
        swap_acc = swap_acc + tt.swap_counts(acc, T)
        swaps += int(acc.sum())
        np.testing.assert_array_equal(walker.numpy(), np.asarray(jst.walker))
        np.testing.assert_array_equal(swap_acc.numpy(),
                                      np.asarray(jst.swap_acc))
        np.testing.assert_allclose(E_p.double().numpy(), np.asarray(E_j),
                                   rtol=0, atol=1e-5)
        for js, ps, pm in zip(jst.slots, p_slots, pms):
            np.testing.assert_array_equal(ps.sigma.numpy(),
                                          np.asarray(js.sigma))
            np.testing.assert_allclose(ps.E.double().numpy(),
                                       np.asarray(js.E, np.float64),
                                       rtol=0, atol=1e-5)
            E_re = pm.energy(ps.sigma)
            assert (E_re.double() - ps.E.double()).abs().max() <= 1e-5
    assert swaps > 0


# ---- 2. the laws ----

def _pt_run(rounds=300, chains=16, **kw):
    X = pt.GraphEA(4, 2, (-1, 1), seed=3, **CPU)
    Es, ranks, st = pt.parallel_tempering(X, BETAS, rounds,
                                          sweeps_per_round=2, chains=chains,
                                          seed=1, device="cpu", **kw)
    return X, Es, ranks, st


def test_pt_route_ranks_and_energies():
    """One site-kernel launch a round (the plain version on the CPU):
    ranks a permutation of every column after every round, the int32
    running energy equal to energy(sigma) on every chain, swaps flowing."""
    X, Es, ranks, st = _pt_run(rounds=40)
    assert pt.LAST_ROUTE["backend"] == "kernel-site-tempering"
    assert pt.LAST_ROUTE["impl"] == "plain"
    T, B = len(BETAS), 16
    assert Es.shape == ranks.shape == (40, T, B)
    want = torch.arange(T, dtype=torch.int32)[:, None].expand(T, B)
    assert torch.equal(ranks.sort(dim=1).values, want.expand(40, T, B))
    assert st.E.dtype == torch.int32
    assert torch.equal(X.energy(st.sigma.reshape(T * B, -1)).view(T, B),
                       st.E)
    assert torch.equal(X.local_fields(st.sigma.reshape(T * B, -1)),
                       st.aux.reshape(T * B, -1))
    assert int(st.swap_acc.sum()) > 0


def test_pt_matches_boltzmann():
    """Rung means, colder lower, and rungs 1 and 3 (beta 1 and 2) within
    0.2 of the exact Boltzmann means, as the JAX test holds."""
    X, Es, ranks, _ = _pt_run()
    means = pt.energies_by_rank(Es, ranks)[150:].double().mean(dim=(0, 2))
    assert bool((torch.diff(means) < 0.2).all())
    for r, beta in [(1, 1.0), (3, 2.0)]:
        want = exact_mean_energy(X, beta)
        assert abs(float(means[r]) - want) < 0.2, (beta, means[r], want)


def test_pt_rungs_within_five_se():
    """Every rung of a six-rung ladder on a 12-spin RRG within 5 standard
    errors (over the ladder's independent columns) of its exact Boltzmann
    mean: a bias of the beta per chain or of the swap of 0.01 a spin
    would show."""
    X = pt.GraphRRG(12, 3, (-1, 1), seed=5, **CPU)
    betas = [0.6, 0.8, 1.0, 1.2, 1.4, 1.6]
    Es, ranks, _ = pt.parallel_tempering(X, betas, 800, chains=64, seed=3,
                                         device="cpu")
    by_rank = pt.energies_by_rank(Es, ranks)[100:].double()
    for r, beta in enumerate(betas):
        cols = by_rank[:, r].mean(0)              # each column's average
        got, se = float(cols.mean()), float(cols.std()) / 8
        want = exact_mean_energy(X, beta)
        assert abs(got - want) < 5 * se, (beta, got, want, se)


def test_pt_colour_masks_below_eight_sites():
    """N < 8: the colour-mask route, each chain at its rank's beta, with
    its exact energies and the Boltzmann means of a 6-spin RRG."""
    X = pt.GraphRRG(6, 3, (-1, 1), seed=4, **CPU)
    betas = [0.5, 1.0, 2.0]
    Es, ranks, st = pt.parallel_tempering(X, betas, 500, chains=32, seed=2,
                                          device="cpu")
    assert pt.LAST_ROUTE["backend"] == "torch"
    assert torch.equal(X.energy(st.sigma.reshape(-1, 6)).view(3, 32), st.E)
    by_rank = pt.energies_by_rank(Es, ranks)[100:].double()
    for r, beta in enumerate(betas):
        got = float(by_rank[:, r].mean())
        sem = float(by_rank[:, r].std()) / (by_rank[:, r].numel() / 10) ** .5
        want = exact_mean_energy(X, beta)
        assert abs(got - want) < max(5 * sem, 0.05), (beta, got, want, sem)


def test_pt_colour_masks_run_unsharded():
    """N < 8 draws its mask uniforms from the ladder's generator, which
    shards could not share: a sharded ladder is refused."""
    from rrrmc_tpu_torch.parallel.mesh import make_mesh

    X = pt.GraphRRG(6, 3, (-1, 1), seed=4, **CPU)
    mesh = make_mesh({"temp": 2}, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="unsharded"):
        pt.parallel_tempering(X, [0.5, 1.0], 2, chains=4, mesh=mesh)


def test_pt_refuses_a_wrapper():
    base = pt.GraphSK(4, seed=2, **CPU)
    q = pt.GraphQuant(4, 3, 0.5, 1.0, base)
    with pytest.raises(TypeError, match="Pairwise"):
        pt.parallel_tempering(q, [1.0, 2.0], 2, chains=2, device="cpu")


def _check_ensembles(models, walkers, state, atol=0.0):
    T = len(models)
    for m, st in zip(models, state.slots):
        err = (m.energy(st.sigma).double() - st.E.double()).abs().max()
        assert float(err) <= atol
    w = walkers[-1]
    for b in range(w.shape[1]):
        assert sorted(w[:, b].tolist()) == list(range(T))


def test_beta_ladder_matches_boltzmann():
    """Identical models on a beta ladder, the default slot kernel (the site
    kernel's plain version): each rung's mean within 0.6 of its exact
    Boltzmann mean, as the JAX test holds."""
    X = pt.GraphEA(4, 2, (-1, 1), seed=3, **CPU)
    betas = [0.5, 1.0, 1.5, 2.0]
    Es, walkers, st = pt.tempered_ensembles([X] * 4, betas, 100,
                                            moves_per_round=32, chains=32,
                                            seed=11, device="cpu")
    assert pt.LAST_ROUTE["backend"] == "kernel-site"
    _check_ensembles([X] * 4, walkers, st)
    assert int(st.swap_acc.sum()) > 0
    for r, beta in enumerate(betas):
        got = float(Es[30:, r].double().mean())
        assert abs(got - exact_mean_energy(X, beta)) < 0.6, (beta, got)


def test_gamma_ladder_quant_cross_energies():
    """A Gamma ladder of GraphQuant over one GraphSK(3) (N = 9, 512
    states): slots pinned to their Hamiltonians, configurations swapped by
    the cross-energy rule; each slot's mean within 0.5 of the exact mean
    of its own Hamiltonian, as the JAX test holds, and swaps occur."""
    base = pt.GraphSK(3, seed=5, **CPU)
    models = [pt.GraphQuant(3, 3, g, 1.0, base) for g in (0.3, 0.8, 1.5)]
    Es, walkers, st = pt.tempered_ensembles(models, [1.0] * 3, 200,
                                            moves_per_round=12, chains=32,
                                            seed=7, device="cpu")
    _check_ensembles(models, walkers, st, atol=1e-4)
    assert int(st.swap_acc.sum()) > 0
    for r, m in enumerate(models):
        got = float(Es[60:, r].double().mean())
        assert abs(got - exact_mean_energy(m, 1.0)) < 0.5, (r, got)


def test_sweep_kernel_beta_ladder_boltzmann():
    """sweep_kernel (one site-kernel launch of whole sweeps a slot) on a
    14-spin RRG: each rung's mean within max(5 SE, 0.1) of the exact mean,
    as the JAX test holds."""
    X = pt.GraphRRG(14, 3, (-1, 1), seed=23, **CPU)
    betas = [0.4, 0.8, 1.4]
    Es, walkers, st = pt.tempered_ensembles(
        [X] * 3, betas, 120, moves_per_round=3 * X.N, chains=64, seed=11,
        kernel=pt.sweep_kernel, device="cpu")
    assert pt.LAST_ROUTE["backend"] == "kernel-site-sweep"
    _check_ensembles([X] * 3, walkers, st)
    assert float(st.swap_acc.double().mean()) > 1.0
    Es = Es[40:].double()
    for r, beta in enumerate(betas):
        got = float(Es[:, r].mean())
        sem = float(Es[:, r].std()) / (Es[:, r].numel() / 10.0) ** 0.5
        want = exact_mean_energy(X, beta)
        assert abs(got - want) < max(5 * sem, 0.1), (beta, got, want)


def test_aux_fresh_after_swaps():
    """After rounds with and without swaps, every slot's aux equals
    init_aux(sigma) (a slot re-derives it where some chain swapped)."""
    base = pt.GraphSK(3, seed=5, **CPU)
    models = [pt.GraphQuant(3, 3, g, 1.0, base) for g in (0.3, 0.8, 1.5)]
    _, _, st = pt.tempered_ensembles(models, [1.0] * 3, 30,
                                     moves_per_round=6, chains=16, seed=13,
                                     device="cpu")
    for m, slot in zip(models, st.slots):
        fresh = m.init_aux(slot.sigma)
        got = slot.aux if isinstance(slot.aux, tuple) else (slot.aux,)
        want = fresh if isinstance(fresh, tuple) else (fresh,)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.double(), b.double(), rtol=0,
                                       atol=1e-4)


def test_ensemble_refusals():
    base = pt.GraphSK(4, seed=2, **CPU)
    q = pt.GraphQuant(4, 3, 0.5, 1.0, base)
    with pytest.raises(ValueError, match="share N"):
        pt.tempered_ensembles([base, q], [1.0, 1.0], 2, chains=2,
                              device="cpu")
    q16 = pt.GraphQuant(16, 3, 0.5, 1.0, pt.GraphSK(16, seed=3, **CPU))
    with pytest.raises(TypeError, match="flatten"):
        pt.tempered_ensembles([q16, q16], [1.0, 1.0], 1, chains=8,
                              kernel=pt.sweep_kernel, device="cpu")


# ---- 3. the site kernel's beta per chain ----

@pytest.mark.parametrize("coupling", ["pm_j", "normal"])
def test_site_beta_tensor_of_one_value_equals_scalar(coupling):
    """The plain site version with a [B] tensor of one beta * scale equals
    the scalar call bit for bit (spins, fields, E, acc)."""
    m = (pt.GraphRRG(64, 3, (-1, 1), seed=2, **CPU) if coupling == "pm_j"
         else pt.GraphRRGNormal(64, 3, seed=1, **CPU))
    rng = np.random.default_rng(3)
    B = 24
    sig = torch.tensor(random_sigma(rng, B, m.N))
    sites = torch.tensor(rng.integers(0, m.N, 300).astype(np.int32))
    runs = []
    for beta_s in (1.3 * m.scale, torch.full((B,), 1.3 * m.scale)):
        a = [sig.t().contiguous(), m.local_fields(sig).t().contiguous(),
             m.energy(sig), torch.zeros(B, dtype=torch.int32)]
        site_chunk(*a, sites, m.neigh, m.J, seed=5, beta_s=beta_s)
        runs.append(a)
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("coupling", ["pm_j", "normal"])
def test_site_distinct_betas_equal_one_chain_runs(coupling):
    """With a distinct beta in every chain, chain b of the batch equals a
    run of chain b alone (chain0 = b) at its own beta, bit for bit."""
    m = (pt.GraphRRG(48, 3, (-1, 1), seed=6, **CPU) if coupling == "pm_j"
         else pt.GraphRRGNormal(48, 3, seed=6, **CPU))
    rng = np.random.default_rng(8)
    B = 8
    betas = torch.linspace(0.2, 3.0, B)
    sig = torch.tensor(random_sigma(rng, B, m.N))
    sites = torch.tensor(rng.integers(0, m.N, 200).astype(np.int32))

    def start(s):
        return [s.t().contiguous(), m.local_fields(s).t().contiguous(),
                m.energy(s), torch.zeros(s.shape[0], dtype=torch.int32)]
    batch = start(sig)
    site_chunk(*batch, sites, m.neigh, m.J, seed=7, beta_s=betas)
    for b in range(B):
        one = start(sig[b:b + 1])
        site_chunk(*one, sites, m.neigh, m.J, seed=7, chain0=b,
                   beta_s=float(betas[b]))
        assert torch.equal(one[0][:, 0], batch[0][:, b])
        assert torch.equal(one[1][:, 0], batch[1][:, b])
        assert torch.equal(one[2][0], batch[2][b])
        assert torch.equal(one[3][0], batch[3][b])


def test_site_beta_tensor_shape_refused():
    m = pt.GraphRRG(16, 3, (-1, 1), seed=2, **CPU)
    sig = m.energy(torch.ones((4, 16), dtype=torch.int8))
    s = torch.ones((16, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="beta_s"):
        site_chunk(s, m.local_fields(s.t()).t().contiguous(), sig,
                   torch.zeros(4, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int32), m.neigh, m.J, seed=1,
                   beta_s=torch.ones(3))
