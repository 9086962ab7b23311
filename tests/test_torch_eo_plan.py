"""The launch plans and the exact-by-construction steps of the redesigned
EO kernels (rrrmc_tpu_torch/csrc/eo_sparse.cu, eo_perc.cu), on the CPU:
the sparse kernel's plan (`ops/eo.py::eo_plan`: route, warps a chain,
chains a block, key type, shared bytes, the refusal) and the perceptron
kernel's (`ops/eo_perc.py::eo_perc_plan`: pattern bits in shared or global
memory), the key types the families' bounds give, the ranks drawn 32 moves
ahead against the per-move ranks, a model of the coarse float select
against `select_rank_with_ties`, the tie race's member groups that the
plain version counts, the perceptron EO wrapper's check of its pattern
bits and the bits perc_tables builds. The kernels themselves run only on the card
(chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import eo, prng
from rrrmc_tpu_torch.ops.eo_perc import (eo_perc_bytes, eo_perc_chunk,
                                         eo_perc_plan)
from rrrmc_tpu_torch.ops.perc import pack_patterns, perc_state, perc_tables
from rrrmc_tpu_torch.samplers.eo import rank_table
from rrrmc_tpu_torch.samplers.families import half_bound

from torch_port_helpers import CPU, coarse_select, random_sigma, ranks_ahead

torch.set_num_threads(1)

#: an H100's SMs and the most dynamic shared bytes a block may opt in to
N_SM, CAP = 132, 232_448 - 64


#: registers a thread of the sparse EO kernel's instantiations by key type
#: and hypergraph flip, and W warps a chain (ptxas, sm_90a)
REGS = {(torch.int8, False): {1: 95, 4: 91, 8: 93, 32: 64},
        (torch.int16, False): {1: 98, 4: 93, 8: 95, 32: 64},
        (torch.int32, False): {1: 96, 4: 92, 8: 92, 32: 64},
        (torch.float32, False): {1: 95, 4: 93, 8: 92, 32: 64},
        (torch.int8, True): {1: 95, 4: 92, 8: 92, 32: 64}}


def h100_info(key=torch.int8, pspin=False, regs=None):
    """info(W, need) of the sparse EO kernel as the card would give it: the
    blocks an SM by threads, registers (allocated 8 at a time) and shared
    memory (1 KB reserved a block)."""
    regs = regs or REGS[(key, pspin)]

    def info(w, need):
        threads = 32 * w * (eo.WARP_CHAINS if w == 1 else 1)
        blocks = min(2048 // threads,
                     65536 // (-(-regs[w] // 8) * 8 * threads),
                     233_472 // (need + 1024), 32)
        return [blocks if need <= CAP else 0, regs[w], 0, 0, CAP]

    return info


#: name -> (N, K, B, key type, bins, PSpin3, expected route, warps a
#: chain): the main paths' shapes and those of chip_smoke.py's route cases
PLANS = {
    "EA(8,3) 1024 chains": (512, 6, 1024, torch.int8, 13, False, "warp",
                            1),
    "RRG(10^4) 1024 chains": (10_000, 3, 1024, torch.int8, 7, False,
                              "block", 4),
    "RRG(10^4) 256 chains": (10_000, 3, 256, torch.int8, 7, False, "block",
                             8),
    "RRG(10^4) 128 chains": (10_000, 3, 128, torch.int8, 7, False, "block",
                             32),
    "RRGNormal(10^4) 1024 chains": (10_000, 3, 1024, torch.float32,
                                    eo.COARSE_BINS, False, "block", 4),
    "RRGNormal(10^4) 128 chains": (10_000, 3, 128, torch.float32,
                                   eo.COARSE_BINS, False, "block", 32),
    "RRGNormal(600) 256 chains": (600, 3, 256, torch.float32,
                                  eo.COARSE_BINS, False, "warp", 1),
    "PSpin3(7500, 3) 128 chains": (7_500, 6, 128, torch.int8, 7, True,
                                   "block", 32),
    "PSpin3(7500, 3) 256 chains": (7_500, 6, 256, torch.int8, 7, True,
                                   "block", 8),
    "PSpin3(7500, 3) 528 chains": (7_500, 6, 528, torch.int8, 7, True,
                                   "block", 4),
    "PSpin3(600, 3) 256 chains": (600, 6, 256, torch.int8, 7, True, "warp",
                                  1),
    "RRG(10^4) J*70 256 chains": (10_000, 3, 256, torch.int16, 421, False,
                                  "block", 8),
    "RRG(10^4) J*1000 256 chains": (10_000, 3, 256, torch.int32,
                                    eo.COARSE_BINS, False, "block", 8),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_eo_plan(name):
    """The route and the threads of a chain follow the chains an SM holds
    and the sites a lane; the block's shared bytes are its chains' parts
    and fit."""
    N, K, B, key, nb, pspin, route, warps = PLANS[name]
    plan = eo.eo_plan(N, B, key, nb, N_SM, h100_info(key, pspin))
    assert (plan["route"], plan["warps"]) == (route, warps), plan
    chains = eo.WARP_CHAINS if warps == 1 else 1
    assert plan["chains"] == chains
    assert plan["threads"] == 32 * warps * chains
    assert plan["key"] == str(key).replace("torch.", "")
    assert plan["select"] == ("coarse" if key in (torch.int32, torch.float32)
                              else "histogram")
    assert plan["smem"] == chains * eo.chain_bytes(N, key, nb, warps)
    assert plan["smem"] <= CAP and plan["blocks_per_sm"] > 0


@pytest.mark.parametrize("regs8", [51, 64, 93, 120])
def test_plan_keeps_four_warps_for_rrg_at_1024_chains(regs8):
    """GraphRRG(10^4) at 1024 chains ran fastest on 4 warps a chain (20
    warps an SM) and slower on 8 whatever their registers: the plan picks 4
    for any register count of the 8-warp build."""
    regs = {**REGS[(torch.int8, False)], 8: regs8}
    plan = eo.eo_plan(10_000, 1024, torch.int8, 7, N_SM,
                      h100_info(regs=regs))
    assert plan["warps"] == 4 and plan["blocks_per_sm"] == 5


@pytest.mark.parametrize("build,key", [
    (lambda: pt.GraphEA(8, 3, (-1, 1), seed=42, **CPU), torch.int8),
    (lambda: pt.GraphRRG(200, 3, (-1, 1), seed=7, **CPU), torch.int8),
    (lambda: pt.GraphRRGNormal(200, 3, seed=7, **CPU), torch.float32),
])
def test_key_type_from_half_bound(build, key):
    """The resident key type follows the family's bound on |half|: int8 for
    +-J graphs and EA lattices, float32 for float couplings."""
    m = build()
    assert eo.key_type(not m.J.dtype.is_floating_point, half_bound(m)) == key


@pytest.mark.parametrize("bound,key", [(3, torch.int8), (127, torch.int8),
                                       (128, torch.int16),
                                       (2047, torch.int16),
                                       (2048, torch.int32),
                                       (None, torch.int32)])
def test_key_type_bounds(bound, key):
    """int8 up to 127, int16 while 2 * bound + 1 histogram bins fit in
    HIST_MAX, else int32 (the coarse select)."""
    assert eo.key_type(True, bound) == key


@pytest.mark.parametrize("move0", [0, 45])
def test_ranks_ahead_equal_per_move(move0):
    """Ranks drawn 32 moves ahead from a launch's first move equal the
    per-move ranks of the plain version, across a split at a move0 that is
    not a multiple of 32: 45 + 70 moves equal 115."""
    B, N = 6, 300
    cdf = rank_table(N, 1.4, "cpu")
    words = prng.eo_rank_bits(11, 3, B, move0, 115, "cpu")
    per_move = torch.searchsorted(cdf, prng.to_uniform(words))
    one = ranks_ahead(11, 3, B, cdf, move0, 115)
    split = torch.cat([ranks_ahead(11, 3, B, cdf, move0, 45),
                       ranks_ahead(11, 3, B, cdf, move0 + 45, 70)])
    assert torch.equal(one, per_move) and torch.equal(split, per_move)


def _float_keys(data, B, N):
    """float32 halves with forced equal values, -0.0 and +0.0, and a share
    of sites on a few values (a crowded coarse bin)."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 32 - 1)))
    x = rng.normal(0.0, 2.0, (B, N)).astype(np.float32)
    pool = np.array([-0.0, 0.0, 1.5, -1.5, 0.25], dtype=np.float32)
    crowd = rng.random((B, N)) < data.draw(st.sampled_from([0.0, 0.3, 0.9]))
    x[crowd] = rng.choice(pool, crowd.sum())
    return torch.from_numpy(x)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_coarse_select_matches_select_rank_with_ties(data):
    """The coarse float select of the sparse EO kernel (a torch model)
    gives the winner of `select_rank_with_ties` on its sort keys: equal
    floats, -0.0 below +0.0, listed bins and crowded ones (the radix
    passes), and any monotone bin map, one that clamps most keys included."""
    B, N = 8, data.draw(st.sampled_from([37, 256, 999]))
    half = _float_keys(data, B, N)
    nb = data.draw(st.sampled_from([1, 32, 1024]))
    H = data.draw(st.sampled_from([0.5, 8.0, 100.0]))
    rank = torch.from_numpy(np.random.default_rng(N).integers(0, N, B))
    ties = torch.from_numpy(np.random.default_rng(B + N).integers(
        -2 ** 31, 2 ** 31, (B, N), dtype=np.int64).astype(np.int32))
    ties[:, ::7] = 2 ** 31 - 1          # scores equal to the cap
    want = eo.select_rank_with_ties(eo.sort_key(half), rank, ties)
    got = coarse_select(half, rank, ties, nb, -H, nb / (2 * H))
    assert torch.equal(got, want)


def test_member_groups_counted_by_the_plain_version():
    """eo_chunk_reference records the tie race's groups of four sites that
    hold a member of the selected class, summed over its chain-moves: one
    move from a ferromagnet's all-up start selects the class of every site
    (all keys equal), ceil(N / 4) groups a chain."""
    m = pt.GraphRRG(150, 3, (1, 1), seed=21, **CPU)
    B = 4
    sigma = torch.ones((B, m.N), dtype=torch.int8)
    lf = m.local_fields(sigma)
    E = m.energy(sigma).to(lf.dtype)
    st_ = [sigma, lf, E, E.clone(), sigma.clone(),
           torch.zeros(B, dtype=torch.int32)]
    eo.eo_sparse_chunk(*st_, m.neigh, m.J, rank_table(m.N, 1.4, "cpu"),
                       n_moves=1, seed=3)
    assert eo.TIE_GROUPS == {"chain_moves": B, "groups": B * 38}
    r = pt.extremal_opt(pt.GraphRRG(150, 3, (-1, 1), seed=21, **CPU), 1.4,
                        50, chains=8, seed=3, **CPU)
    assert r.itmin.max() > 0
    assert eo.TIE_GROUPS["chain_moves"] == 8 * 50
    assert 0 < eo.TIE_GROUPS["groups"] <= 8 * 50 * 38


def test_member_groups():
    """member_groups counts a group once for any number of members, and the
    ragged last group; a class of one site draws nothing."""
    key = torch.tensor([[1, 1, 1, 1, 2, 2, 1], [0, 2, 2, 2, 2, 2, 2],
                        [5, 1, 2, 3, 4, 6, 7]], dtype=torch.int32)
    assert int(eo.member_groups(key, torch.tensor([1, 2, 5]))) == 2 + 2 + 0


def test_perc_plan_pattern_memory():
    """The perceptron EO plan keeps the pattern bits in shared memory at N
    = 1023, P = 511 (64 KB beside the state), in global memory at P = 2047
    (256 KB), and refuses a state that does not fit at all."""
    def info(sx, need):
        return [2 if need <= CAP else 0, 40, 0, 0, CAP]

    plan = eo_perc_plan(1023, 511, "step", info)
    assert (plan["patterns"], plan["select"], plan["bins"]) == (
        "shared", "histogram", 1023)
    assert plan["smem"] == eo_perc_bytes(1023, 511, "step", 1023, True)
    assert eo_perc_plan(1023, 511, "xentr", info)["select"] == "radix"
    wide = eo_perc_plan(1023, 2047, "step", info)
    assert (wide["patterns"], wide["bins"]) == ("global", 4095)
    assert wide["smem"] == eo_perc_bytes(1023, 2047, "step", 4095, False)
    with pytest.raises(NotImplementedError, match="perceptron EO"):
        eo_perc_plan(60_001, 511, "xentr", info)


def test_eo_perc_checks_pattern_bits():
    """The perceptron EO wrapper reads the pattern bits xb in the place of
    xi4 on the card, so it checks their shape [ceil(P/32), N] and dtype
    int32 as the race wrapper does."""
    m = pt.GraphPercStep(15, 33, seed=5, **CPU)
    st_ = pt.init_state(m, 4, seed=3, **CPU)
    delta, E = perc_state(m, st_.sigma, st_.E)
    xi4, xiT, loss, xb = perc_tables(m)
    cdf = rank_table(m.N, 1.4, "cpu")
    for wrong in (xb[:1], xb.to(torch.int64)):
        with pytest.raises(ValueError, match="xb"):
            eo_perc_chunk(st_.sigma.clone(), delta.clone(), E.clone(),
                          E.clone(), st_.sigma.clone(),
                          torch.zeros(4, dtype=torch.int32), xi4, xiT, loss,
                          wrong, cdf, n_moves=3, seed=1)
    eo_perc_chunk(st_.sigma.clone(), delta.clone(), E.clone(), E.clone(),
                  st_.sigma.clone(), torch.zeros(4, dtype=torch.int32), xi4,
                  xiT, loss, xb, cdf, n_moves=3, seed=1)


@pytest.mark.parametrize("build", [
    lambda: pt.GraphPercStep(15, 33, seed=5, **CPU),
    lambda: pt.GraphPercLinear(31, 65, seed=6, **CPU),
    lambda: pt.GraphPercXEntr(63, 17, 1.0, seed=7, **CPU),
])
def test_perc_tables_bits_are_xi4s(build):
    """The pattern bits perc_tables gives the kernels are those of its
    int8 patterns xi4 (the wrapper does not compare them at each launch)."""
    m = build()
    xi4, _, _, xb = perc_tables(m)
    assert torch.equal(xb, pack_patterns(xi4[:, :m.N]))


def test_flip_updates_of_a_repeated_neighbour():
    """A site listed twice in the winner's row (an EA lattice of side 2,
    whose x + e and x - e coincide) takes both adds: the plain version's
    fields stay those of the model after every move."""
    m = pt.GraphEA(2, 3, (-1, 1), seed=4, **CPU)
    assert bool((m.neigh[:, 0] == m.neigh[:, 1]).all())
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(1), 8, m.N))
    lf = m.local_fields(sigma)
    E = m.energy(sigma).to(lf.dtype)
    st_ = [sigma, lf, E, E.clone(), sigma.clone(),
           torch.zeros(8, dtype=torch.int32)]
    eo.eo_sparse_chunk(*st_, m.neigh, m.J, rank_table(m.N, 1.4, "cpu"),
                       n_moves=40, seed=5, half_max=half_bound(m))
    assert torch.equal(st_[1], m.local_fields(st_[0]))
    assert torch.equal(st_[2], m.energy(st_[0]).to(lf.dtype))


def test_dataclass_replace_keeps_float_zero_keys():
    """Float couplings in {-1, 0, 1} give halves -0.0 and +0.0, which the
    select orders apart (sort_key -1 and 0); the plain version keeps the
    model's energies on them."""
    m = pt.GraphRRGNormal(120, 3, seed=7, **CPU)
    z = dataclasses.replace(m, J=torch.where(
        m.J > 0.5, 1.0, torch.where(m.J < -0.5, -1.0, 0.0)))
    sigma = torch.from_numpy(random_sigma(np.random.default_rng(2), 8, z.N))
    lf = z.local_fields(sigma)
    half = sigma.to(torch.float32) * lf
    assert bool((half == 0).any())
    keys = eo.sort_key(half)
    assert set(keys[half == 0].tolist()) <= {-1, 0}
    E = z.energy(sigma).to(lf.dtype)
    st_ = [sigma, lf, E, E.clone(), sigma.clone(),
           torch.zeros(8, dtype=torch.int32)]
    eo.eo_sparse_chunk(*st_, z.neigh, z.J, rank_table(z.N, 1.4, "cpu"),
                       n_moves=60, seed=5)
    assert float((z.energy(st_[0]) - st_[2]).abs().max()) <= 1e-4 * z.N
