"""The launch plans and the exact-by-construction steps of the dense and
K-SAT EO kernels (rrrmc_tpu_torch/csrc/eo_dense.cu and eo_sat.cu, on the
move loop of csrc/eo_chain.cuh), on the CPU: their plans (ops/eo.py::eo_plan
through ops/eo_dense.py and ops/eo_sat.py: route, warps a chain, key type,
bins, shared bytes, the refusal above shared memory) on the H100's figures,
the key types the families' bounds give on the four main cases, a model of
the K-SAT kernel's biased 8-bit dE words (an atomic change never carries
across bytes; the tie race's word compare finds the plain select's
members), a model of the dense kernel's packed key update, and a model of
the exact-bin select that GraphSK(1024) keeps against
`select_rank_with_ties`. The kernels themselves run only on the card
(chip_smoke.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import eo
from rrrmc_tpu_torch.ops.eo_dense import dense_select
from rrrmc_tpu_torch.ops.eo_sat import SAT_KEY_CODES, sat_key_type
from rrrmc_tpu_torch.samplers.families import family_of, half_bound

from torch_port_helpers import CPU

torch.set_num_threads(1)

#: an H100's SMs and the most dynamic shared bytes a block may opt in to
N_SM, CAP = 132, 232_448

#: registers a thread of the dense and K-SAT EO kernels' instantiations by
#: key type and W warps a chain (ptxas, sm_90a)
REGS = {("dense", torch.int8): {1: 80, 4: 80, 8: 80, 32: 64},
        ("dense", torch.int16): {1: 117, 4: 127, 8: 127, 32: 64},
        ("dense", torch.int32): {1: 76, 4: 72, 8: 72, 32: 64},
        ("dense", torch.float32): {1: 117, 4: 115, 8: 112, 32: 64},
        ("sat", torch.uint8): {1: 94, 4: 96, 8: 96, 32: 64},
        ("sat", torch.uint16): {1: 94, 4: 96, 8: 96, 32: 64}}


def h100_info(kind, key, regs=None):
    """info(W, need) of an EO kernel of csrc/eo_chain.cuh as the card would
    give it: the blocks an SM by threads, registers (allocated 8 at a time)
    and shared memory (1 KB reserved a block)."""
    regs = regs or REGS[(kind, key)]

    def info(w, need):
        threads = 32 * w * (eo.WARP_CHAINS if w == 1 else 1)
        blocks = min(2048 // threads,
                     65536 // (-(-regs[w] // 8) * 8 * threads),
                     233_472 // (need + 1024), 32)
        return [blocks if need <= CAP else 0, regs[w], 0, 0, CAP]

    return info


def dense_plan(N, B, key, nb, regs=None):
    return eo.eo_plan(N, B, key, nb, N_SM, h100_info("dense", key, regs),
                      what="dense EO",
                      sites_per_lane=eo.DENSE_SITES_PER_LANE)


def sat_plan(N, Mc, B, key, nb):
    return eo.eo_plan(N, B, key, nb, N_SM, h100_info("sat", key), extra=Mc,
                      what="SAT EO")


#: name -> (N, B, key type, bins, warps a chain): the dense main cases and
#: chip_smoke.py's route cases
DENSE_PLANS = {
    "GraphSK(1024) 1024 chains": (1024, 1024, torch.int16, 2047, 1),
    "densify(GraphRRG(10^4)) 1024 chains": (10_000, 1024, torch.int8, 7, 8),
    "GraphSKNormal(4096) 512 chains": (4096, 512, torch.float32,
                                       eo.COARSE_BINS, 4),
    "GraphSK(500) 256 chains": (500, 256, torch.int16, 999, 1),
    "densify(GraphRRG(16000)) 64 chains": (16_000, 64, torch.int8, 7, 32),
    "densify(GraphRRG(10^4)) 256 chains": (10_000, 256, torch.int8, 7, 8),
    "GraphSKNormal(8192) 64 chains": (8192, 64, torch.float32,
                                      eo.COARSE_BINS, 8),
    "GraphSK(1100) J*127 256 chains": (1100, 256, torch.int32,
                                       eo.COARSE_BINS, 1),
    "GraphSKNormal(600) 256 chains": (600, 256, torch.float32,
                                      eo.COARSE_BINS, 1),
    "GraphSKNormal(4096) 256 chains": (4096, 256, torch.float32,
                                       eo.COARSE_BINS, 4),
}


@pytest.mark.parametrize("name", list(DENSE_PLANS))
def test_dense_plan(name):
    """The dense plan takes the fewest warps a chain that give a lane at
    most DENSE_SITES_PER_LANE sites (measured best on the three main
    cases); the block's shared bytes are its chains' parts and fit."""
    N, B, key, nb, warps = DENSE_PLANS[name]
    plan = dense_plan(N, B, key, nb)
    assert (plan["route"], plan["warps"]) == (
        "warp" if warps == 1 else "block", warps), plan
    chains = eo.WARP_CHAINS if warps == 1 else 1
    assert plan["chains"] == chains and plan["threads"] == 32 * warps * chains
    assert plan["key"] == str(key).replace("torch.", "")
    assert plan["select"] == ("coarse" if key in (torch.int32, torch.float32)
                              else "histogram")
    assert plan["bins"] == nb
    assert plan["smem"] == chains * eo.chain_bytes(N, key, nb, warps)
    assert plan["smem"] <= CAP and plan["blocks_per_sm"] > 0


@pytest.mark.parametrize("regs4", [64, 96, 127, 168])
def test_dense_plan_keeps_one_warp_for_sk(regs4):
    """GraphSK(1024) at 1024 chains ran fastest on one warp a chain and the
    densified RRG on 8, whatever the other builds' registers: the rule
    counts sites a lane, not warps an SM."""
    regs = {**REGS[("dense", torch.int16)], 4: regs4}
    assert dense_plan(1024, 1024, torch.int16, 2047, regs)["warps"] == 1
    regs = {**REGS[("dense", torch.int8)], 4: regs4}
    assert dense_plan(10_000, 1024, torch.int8, 7, regs)["warps"] == 8


#: name -> (N, Mc, B, Cmax, warps a chain): the K-SAT main case and
#: chip_smoke.py's route cases
SAT_PLANS = {
    "GraphSAT(10^4, 3, 4.2) 128 chains": (10_000, 42_000, 128, 27, 32),
    "GraphSAT(10^4, 3, 4.2) 256 chains": (10_000, 42_000, 256, 27, 8),
    "GraphSAT(2000, 3, 4.2) 1024 chains": (2000, 8400, 1024, 25, 4),
    "GraphSAT(600, 3, 4.2) 256 chains": (600, 2520, 256, 24, 1),
    "GraphSAT(1000, 3, 45) 128 chains": (1000, 45_000, 128, 170, 4),
}


@pytest.mark.parametrize("name", list(SAT_PLANS))
def test_sat_plan(name):
    """The K-SAT plan is the sparse plan's rule (32 warps a chain at 128
    chains of GraphSAT(10^4, 3, 4.2), as PSpin3's) with the counts' Mc
    bytes beside each chain's state; uint8 keys up to Cmax = 127, uint16
    above, in 2 Cmax + 1 exact bins."""
    N, Mc, B, cmax, warps = SAT_PLANS[name]
    key = sat_key_type(cmax)
    nb = eo.key_bins(cmax, "SAT")
    plan = sat_plan(N, Mc, B, key, nb)
    assert plan["warps"] == warps, plan
    assert plan["key"] == ("uint8" if cmax <= 127 else "uint16")
    assert (plan["select"], plan["bins"]) == ("histogram", 2 * cmax + 1)
    chains = eo.WARP_CHAINS if warps == 1 else 1
    assert plan["smem"] == chains * eo.chain_bytes(N, key, nb, warps, Mc)
    assert plan["smem"] <= CAP


def test_plans_refuse_a_state_beyond_shared_memory():
    """A chain whose resident state does not fit in a block's shared memory
    is refused by name: a dense chain of 300 000 int8 keys, a K-SAT chain
    of 250 000 clause counts."""
    with pytest.raises(NotImplementedError, match="dense EO"):
        dense_plan(300_000, 64, torch.int8, 7)
    with pytest.raises(NotImplementedError, match="SAT EO"):
        sat_plan(10_000, 250_000, 128, torch.uint8, 55)


def test_sat_key_types():
    """uint8 keys up to Cmax = 127, uint16 above; their kernel codes."""
    assert [sat_key_type(c) for c in (1, 27, 127, 128, 2047)] == [
        torch.uint8] * 3 + [torch.uint16] * 2
    assert SAT_KEY_CODES == {torch.uint8: 0, torch.uint16: 1}


@pytest.mark.parametrize("build,key,nb", [
    (lambda: pt.GraphSK(1024, seed=4, **CPU), torch.int16, 2047),
    (lambda: pt.densify(pt.GraphRRG(10_000, 3, (-1, 1), seed=7, **CPU)),
     torch.int8, 7),
    (lambda: pt.GraphSKNormal(4096, seed=4, **CPU), torch.float32,
     eo.COARSE_BINS),
])
def test_dense_key_types_from_half_bound(build, key, nb):
    """The dense family's bound on |half| gives GraphSK(1024) int16 keys in
    2047 exact bins, the densified +-J RRG int8 keys in 7, and
    GraphSKNormal(4096) float32 keys in the coarse bins."""
    m = build()
    assert family_of(m).name == "dense"
    assert dense_select(not m.J.dtype.is_floating_point, half_bound(m)) == (
        key, nb)


def test_sat_key_type_of_the_main_case():
    """GraphSAT(10^4, 3, 4.2): |dE| <= Cmax = 27 (uint8 keys, 55 bins);
    GraphSAT(1000, 3, 45): Cmax above 127 (uint16 keys)."""
    m = pt.GraphSAT(10_000, 3, 4.2, seed=167, **CPU)
    assert family_of(m).key_max(m) == m.Cmax == 27
    assert sat_key_type(m.Cmax) == torch.uint8
    assert eo.key_bins(m.Cmax, "SAT") == 55
    wide = pt.GraphSAT(1000, 3, 45.0, seed=167, **CPU)
    assert wide.Cmax > 127 and sat_key_type(wide.Cmax) == torch.uint16


def _atomic_add(word: int, v: int, x: int) -> tuple:
    """sat.cuh's de_add on DeByte: a 32-bit atomicAdd of (unsigned)x << 8
    (v & 3) on the word; returns (new word, v's old dE)."""
    sh = 8 * (v & 3)
    old = word
    word = (word + (((x % 2 ** 32) << sh) % 2 ** 32)) % 2 ** 32
    return word, ((old >> sh) & 0xFF) - 128


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_biased_byte_changes_never_carry(data):
    """Four dE in [-Cmax, Cmax] (Cmax <= 127) biased by 128 in one word: any
    sequence of changes that keeps each dE within its bound moves that byte
    alone, and the atomic returns its old dE."""
    cmax = data.draw(st.integers(1, 127))
    de = data.draw(st.lists(st.integers(-cmax, cmax), min_size=4,
                            max_size=4))
    word = sum((d + 128) << (8 * j) for j, d in enumerate(de))
    for _ in range(data.draw(st.integers(1, 40))):
        v = data.draw(st.integers(0, 3))
        x = data.draw(st.integers(-cmax - de[v], cmax - de[v]))
        word, old = _atomic_add(word, v, x)
        assert old == de[v]
        de[v] += x
        assert [((word >> (8 * j)) & 0xFF) - 128 for j in range(4)] == de


def _word_mask(w: int, v: int) -> int:
    """eo_group.cuh's word_mask: __vcmpeq4 of the word with v's byte, the
    bytes' low bits gathered by one product."""
    b = v & 0xFF
    eq = sum(0xFF << (8 * j) for j in range(4) if (w >> (8 * j)) & 0xFF == b)
    return ((((eq & 0x01010101) * 0x00204081) % 2 ** 32) >> 21) & 15


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_word_mask_on_biased_keys_finds_the_members(data):
    """The K-SAT tie race compares packed biased words with the biased v
    (v + 128, eo_chain.cuh: v - key_of(0)); the groups of four it finds
    are those whose sites hold the plain select's key v, the tail's
    sentinel bytes 0 (key -128) never among them."""
    cmax = data.draw(st.integers(1, 127))
    N = data.draw(st.integers(1, 60))
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 32 - 1)))
    de = rng.integers(-cmax, cmax + 1, N)
    de[rng.random(N) < 0.3] = rng.integers(-cmax, cmax + 1)
    stored = np.zeros(-(-N // 16) * 16, dtype=np.int64)   # sentinels 0
    stored[:N] = de + 128
    v = int(de[rng.integers(N)]) if data.draw(st.booleans()) else int(
        rng.integers(-cmax, cmax + 1))
    got = set()
    for g in range(len(stored) // 4):
        w = int(sum(int(stored[4 * g + j]) << (8 * j) for j in range(4)))
        m = _word_mask(w, v + 128)
        got |= {4 * g + j for j in range(4) if (m >> j) & 1}
    assert got == set(np.flatnonzero(de == v).tolist())


def _packed_update(keys, J, sigma, d, w, byte):
    """The dense kernel's packed update of 16 sites (eo_dense.cu
    packed_sites), in 32-bit words: keys int8 (byte) or int16 in words,
    each += sigma_i d J_i with d J_i = +-2 J_i negated per byte or half
    where sigma_i d < 0, wrapping; then the winner's key 2 J_ww - half_w."""
    lanes, bits = (4, 8) if byte else (2, 16)
    mask = (1 << bits) - 1
    out = []
    for k in range(16 // lanes):
        word = 0
        for j in range(lanes):
            i = lanes * k + j
            neg = (sigma[i] < 0) != (d < 0)
            j2 = (2 * int(J[i])) & mask
            delta = ((j2 ^ mask) + 1) & mask if neg else j2
            word |= ((int(keys[i]) + delta) & mask) << (bits * j)
        out.append(word)
    new = [(out[i // lanes] >> (bits * (i % lanes))) & mask for i in range(16)]
    new = [x - (1 << bits) if x >> (bits - 1) else x for x in new]
    if w is not None:
        new[w] = 2 * int(J[w]) - int(keys[w])
    return new


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_packed_dense_update_matches_the_plain_fields(data):
    """The packed update gives every key sigma' (sigma lf + d J) of the
    plain version (lf += d J[w], then the winner flips), for int8 keys
    (|half| <= 127, |J| small) and int16 keys (SK-like +-1 rows, |half|
    up to 1023), the winner anywhere in the vector or elsewhere."""
    byte = data.draw(st.booleans())
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 32 - 1)))
    hmax = 127 if byte else 1023
    jmax = data.draw(st.sampled_from([1, 3, 40, 127] if not byte
                                     else [1, 2, 3]))
    J = rng.integers(-jmax, jmax + 1, 16)
    sigma = rng.choice([-1, 1], 16)
    lim = hmax - 2 * jmax
    half = rng.integers(-lim, lim + 1, 16)
    d = int(rng.choice([-2, 2]))
    w = data.draw(st.one_of(st.none(), st.integers(0, 15)))
    if w is not None:
        J[w] = 0 if data.draw(st.booleans()) else J[w]
        d = -2 * int(sigma[w])
    lf = sigma * half + d * J
    s_new = sigma.copy()
    if w is not None:
        s_new[w] = -s_new[w]
    assert _packed_update(half, J, sigma, d, w, byte) == (s_new * lf).tolist()


def _hist_select(key, rank, tie_bits, off, nb):
    """The exact-bin select of eo_chain.cuh (HIST), row by row: the bin of
    the rank's site by the histogram's running sum, v = bin - off, then the
    tie race of v's members (a class of one site wins without a draw)."""
    out = []
    for b in range(key.shape[0]):
        bins = (key[b].to(torch.int64) + off).clamp(0, nb - 1)
        run = torch.bincount(bins, minlength=nb).cumsum(0)
        sel = int((run <= int(rank[b])).sum())
        v = sel - off
        member = key[b] == v
        if int(member.sum()) == 1:
            out.append(int(member.nonzero()[0, 0]))
            continue
        score = torch.where(member, tie_bits[b].clamp(max=2 ** 31 - 2),
                            torch.tensor(2 ** 31 - 1, dtype=torch.int32))
        out.append(int(score.argmin()))
    return torch.tensor(out)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_exact_bins_select_matches_select_rank_with_ties(data):
    """GraphSK(1024) keeps exact bins (2 half_max + 1 of them: the measured
    winner over coarse ones, PERF.md section 6): the select by the bins'
    running sums and the tie race give `select_rank_with_ties`'s winner on
    int16 keys of SK's range, crowded ones and classes of one site
    included."""
    B, N = 6, data.draw(st.sampled_from([16, 300, 1024]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 32 - 1)))
    half_max = 1023
    spread = data.draw(st.sampled_from([3, 40, 1023]))
    key = torch.from_numpy(rng.integers(-spread, spread + 1, (B, N))
                           .astype(np.int32))
    rank = torch.from_numpy(rng.integers(0, N, B))
    ties = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (B, N),
                                         dtype=np.int64).astype(np.int32))
    ties[:, ::5] = 2 ** 31 - 1
    want = eo.select_rank_with_ties(key, rank, ties)
    got = _hist_select(key, rank, ties, half_max, 2 * half_max + 1)
    assert torch.equal(got, want)
