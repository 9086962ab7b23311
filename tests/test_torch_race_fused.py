"""The fused race pass of the sparse and replica race kernels
(rrrmc_tpu_torch/csrc/race.cuh::fused_pass) through its plain arithmetic,
and their launch rule (ops/rejfree.py, samplers/families.py), on the CPU:
the pass's speculative sum of exp(0 - bE) equals race.cuh's two-pass log_z
(`_log_z`) bit for bit wherever min bE is 0, and the all-up ferromagnets
are the states whose min bE is above 0 (there the kernel sums again, as
log_z does); the resident field type follows the family's bound on |lf|
(int8 for the +-J RRG and EA-3D and PSpin3 and a densified +-J RRG, int16
for GraphSK(1024) and the SK base of QSKT, int32 once a row's sum of |J|
passes 32767, or for the dense race 4095, float32 for float couplings);
the block size follows the chains and the blocks that fit on an SM."""

import dataclasses

import numpy as np
import pytest
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import rejfree, rejfree_dense, replica
from rrrmc_tpu_torch.ops.rejfree_dense import dense_field
from rrrmc_tpu_torch.ops.rejfree import (_log_z, block_sum, race_threads,
                                         resident_dtype)
from rrrmc_tpu_torch.core.dtypes import is_integer
from rrrmc_tpu_torch.samplers import families
from rrrmc_tpu_torch.samplers.families import family_of, half_bound

from torch_port_helpers import CPU, random_sigma

torch.set_num_threads(1)

B = 8
SEED = 5


def _up(model, chains=B):
    return torch.ones((chains, model.N), dtype=torch.int8)


def _random(model, chains=B, seed=SEED):
    return torch.from_numpy(random_sigma(np.random.default_rng(seed), chains,
                                         model.N))


def _ferro(n, seed):
    return pt.GraphRRG(n, 3, (1,), seed=seed, **CPU)


def _quant_ferro():
    return pt.GraphQuant(100, 4, 1.0, 1.0, _ferro(100, 4))


def _de(name):
    """(dE [B, N], beta): the flip costs of a batch of states."""
    if name == "rrg-int":
        m = pt.GraphRRG(300, 3, seed=1, **CPU)
        s = _random(m)
        return rejfree.pair_de(s.int(), m.local_fields(s)), 1.0
    if name == "rrg-float":
        m = pt.GraphRRGNormal(300, 3, seed=2, **CPU)
        s = _random(m)
        return rejfree.pair_de(s.float(), m.local_fields(s)), 1.0
    if name in ("ferro-up", "ferro-mixed"):
        m = _ferro(300, 3)
        s = _up(m)
        if name == "ferro-mixed":
            s[: B // 2] = _random(m, B // 2)
        return rejfree.pair_de(s.int(), m.local_fields(s)), 4.0
    m = _quant_ferro()
    s = _up(m)
    lf, _ = replica.replica_state(m, s, m.energy(s))
    return replica.replica_de(replica.replica_tables(m)[0], s, lf), 4.0


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("name", ["rrg-int", "rrg-float", "ferro-up",
                                  "ferro-mixed", "quant-ferro-up"])
def test_speculative_sum_equals_log_z(name, threads):
    """Where min bE is 0, the fused pass's sum of exp(0 - bE) (summed as a
    block of `threads` threads sums it) gives `_log_z`'s log z EXACTLY: bE
    >= 0, so log_z's shift is 0 and the two sums add the same terms. The
    all-up ferromagnets (J = +1, beta = 4) start with every flip raising
    E, min bE > 0, the rows where the kernel sums a second time (and only
    those of the mixed batch)."""
    dE, beta = _de(name)
    bE, lz = _log_z(dE, torch.tensor(beta, dtype=torch.float32), threads)
    m = bE.min(dim=1).values
    zero = m == 0
    spec = torch.log(block_sum(torch.exp(0.0 - bE), threads))
    assert torch.equal(spec[zero], lz[zero])
    if name.endswith("up"):
        assert bool((m > 0).all())
    elif name == "ferro-mixed":
        assert bool((m[B // 2:] > 0).all()) and bool(zero[: B // 2].all())
    else:
        assert bool(zero.all())


def _scaled(m, c):
    return dataclasses.replace(m, J=m.J * c)


SPARSE = {
    "RRG +-J": (lambda: pt.GraphRRG(64, 3, seed=1, **CPU), torch.int8),
    "EA-3D +-J": (lambda: pt.GraphEA(4, 3, seed=2, **CPU), torch.int8),
    "EA-3D +-J, fields": (lambda: dataclasses.replace(
        pt.GraphEA(4, 3, seed=2, **CPU), h=torch.as_tensor(
            np.random.default_rng(3).integers(-2, 3, 64), dtype=torch.int32)),
        torch.int8),
    "RRG J=+-100": (lambda: _scaled(pt.GraphRRG(64, 3, seed=1, **CPU), 100),
                    torch.int16),
    "RRG sum|J| = 32766": (lambda: _scaled(pt.GraphRRG(64, 3, seed=1, **CPU),
                                           10922), torch.int16),
    "RRG sum|J| = 32769": (lambda: _scaled(pt.GraphRRG(64, 3, seed=1, **CPU),
                                           10923), torch.int32),
    "RRGNormal": (lambda: pt.GraphRRGNormal(64, 3, seed=1, **CPU),
                  torch.float32),
}


@pytest.mark.parametrize("name", list(SPARSE))
def test_sparse_resident_type(name):
    """The sparse family's bound on |lf| (the row sum of |J| plus |h|)
    holds every field of random states, and it picks the resident type."""
    build, want = SPARSE[name]
    m = build()
    bound = family_of(m).race_kw(m)["field_bound"]
    assert bound == half_bound(m)
    if bound is not None:
        assert int(m.local_fields(_random(m, 64)).abs().max()) <= bound
    assert resident_dtype(is_integer(m.J), bound) == want


REPLICA = {
    "QSKT(1024, 16) (SK base)": (lambda: pt.GraphQSKT(
        1024, 16, 0.3, 2.0, seed=8370274, **CPU), torch.int16),
    "Quant(RRG(64, 3))": (lambda: pt.GraphQuant(
        64, 4, 1.0, 1.0, pt.GraphRRG(64, 3, seed=11, **CPU)), torch.int8),
    "RE(RRG(64, 3))": (lambda: pt.GraphRobustEnsemble(
        64, 4, 2.0, 1.0, pt.GraphRRG(64, 3, seed=12, **CPU)), torch.int8),
    "Quant(RRG(64, 3) J=+-20000)": (lambda: pt.GraphQuant(
        64, 4, 1.0, 1.0, _scaled(pt.GraphRRG(64, 3, seed=11, **CPU), 20000)),
        torch.int32),
    "QSKNormalT(64, 4)": (lambda: pt.GraphQSKNormalT(
        64, 4, 0.3, 2.0, seed=1, **CPU), torch.float32),
}


@pytest.mark.parametrize("name", list(REPLICA))
def test_replica_resident_type(name):
    """The composite family's bound on the base fields is the base's
    half_bound, holds the fields of random states, and picks their
    resident type."""
    build, want = REPLICA[name]
    m = build()
    st = pt.init_state(m, 16, seed=SEED, **CPU)
    lf, _ = replica.replica_state(m, st.sigma, st.E)
    bound = family_of(m).race_kw(m)["field_bound"]
    assert bound == half_bound(replica.replica_base(m))
    if bound is not None:
        assert int(lf.abs().max()) <= bound
    assert resident_dtype(is_integer(lf), bound) == want


def _dense_family():
    return next(f for f in families.FAMILIES if f.name == "dense")


def _fc(j, n):
    """A FullyConnected model of n spins, every coupling j."""
    return pt.make_fully_connected(j * (1 - np.eye(n)), scale=1.0, **CPU)


#: (builder, resident type, whether the dense race kernel takes the model)
DENSE = {
    "densify(RRG(64, 3) +-J)": (lambda: pt.densify(
        pt.GraphRRG(64, 3, seed=1, **CPU)), torch.int8, True),
    "GraphSK(1024)": (lambda: pt.GraphSK(1024, seed=4, **CPU), torch.int16,
                      True),
    "FullyConnected(300) J=14": (lambda: _fc(14, 300), torch.int32, True),
    "FullyConnected(300) J=127": (lambda: _fc(127, 300), torch.int32, True),
    "FullyConnected(8) J=20000": (lambda: _fc(20000, 8), torch.int32, False),
    "GraphSKNormal(64)": (lambda: pt.GraphSKNormal(64, seed=1, **CPU),
                          torch.float32, True),
}


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_resident_type(name):
    """The dense family's bound on |lf| (half_bound: the largest row sum of
    |J| plus |h|) holds every field of random states, and it picks the
    resident type: int8 on a densified +-J RRG (bound 3), int16 on
    GraphSK(1024) (1023), int32 where an int16 bound's exp table would pass
    TABLE_MAX terms (14 x 299 = 4186) and above 32767 (127 x 299 = 37 973,
    and 20 000 x 7, which the kernel refuses for |J| > 127), float32 for
    float couplings."""
    build, want, eligible = DENSE[name]
    m = build()
    dense = _dense_family()
    assert (family_of(m) is dense) == eligible
    bound = dense.race_kw(m)["field_bound"]
    assert bound == half_bound(m)
    if bound is not None:
        assert int(m.local_fields(_random(m, 64)).abs().max()) <= bound
    assert dense_field(is_integer(m.J), bound) == want
    assert rejfree_dense.TABLE_MAX == 4096


def test_pspin_resident_type():
    """A PSpin3 cavity sum adds K products of two spins: the family's bound
    is K, |c| <= K, int8."""
    m = pt.GraphPSpin3(48, 3, seed=3, **CPU)
    bound = family_of(m).race_kw(m)["field_bound"]
    assert bound == m.K
    assert int(m.local_fields(_random(m, 64)).abs().max()) <= bound
    assert resident_dtype(True, bound) == torch.int8


@pytest.mark.parametrize("integer,bound,want", [
    (True, 127, torch.int8), (True, 128, torch.int16),
    (True, 32767, torch.int16), (True, 32768, torch.int32),
    (True, None, torch.int32), (False, None, torch.float32),
    (False, 3, torch.float32)])
def test_resident_dtype(integer, bound, want):
    """The narrowest integer type that holds |value| <= bound; int32 when no
    bound is given; float32 for float couplings."""
    assert resident_dtype(integer, bound) == want


#: blocks per SM of the sparse race at 48 registers on the H100
H100 = {256: 5, 512: 2}


@pytest.mark.parametrize("chains,blocks,want", [
    (128, H100, 512), (132, H100, 512), (264, H100, 512),
    (265, H100, 256), (660, H100, 256), (1024, H100, 256),
    (528, {256: 8, 512: 4}, 512), (128, {256: 3, 512: 0}, 256),
    (2, {256: 0, 512: 1}, 512)])
def test_race_threads(chains, blocks, want):
    """The block size: 512 threads while the blocks of all the chains are
    resident at once on 132 SMs, else 256 (or the only size that fits),
    for chains of 10^4 sites (enough for 512 threads)."""
    assert race_threads(chains, 132, blocks, 10_000) == want


@pytest.mark.parametrize("chains,sites,want", [
    (256, 1023, 256), (128, 1535, 256), (128, 1536, 512),
    (128, 7500, 512), (300, 2047, 256), (256, 2047, 512)])
def test_race_threads_sites(chains, sites, want):
    """512 threads only where a chain has at least MIN_SITES_PER_THREAD
    sites a thread (the perceptrons' 1023 sites take 256 at 256 chains;
    2047 sites take 512; PSpin3's 7500 take 512 at 128), with the blocks
    of all chains resident at once."""
    assert rejfree.MIN_SITES_PER_THREAD == 3
    assert race_threads(chains, 132, {256: 3, 512: 2}, sites) == want


FAMILY_BOUNDS = {
    "RRG +-J": (lambda: pt.GraphRRG(64, 3, seed=1, **CPU), 3),
    "densify(RRG +-J)": (lambda: pt.densify(pt.GraphRRG(64, 3, seed=1,
                                                         **CPU)), 3),
    "GraphSK(64)": (lambda: pt.GraphSK(64, seed=4, **CPU), 63),
    "PSpin3(48, 3)": (lambda: pt.GraphPSpin3(48, 3, seed=3, **CPU), 3),
    "Quant(RRG(64, 3) J=+-100)": (lambda: pt.GraphQuant(
        64, 4, 1.0, 1.0, _scaled(pt.GraphRRG(64, 3, seed=11, **CPU), 100)),
        300),
}


@pytest.mark.parametrize("name", list(FAMILY_BOUNDS))
def test_samplers_pass_family_bound(monkeypatch, name):
    """bklMC hands the fused race wrapper, or the class kernel's that
    takes its place (the +-J RRG), its family's bound on |lf| at every
    chunk."""
    build, want = FAMILY_BOUNDS[name]
    m = build()
    seen = []
    spied = []

    def spy(op):
        def call(*a, **kw):
            seen.append(kw.get("field_bound", "absent"))
            return op(*a, **kw)
        return call

    for f in families.FAMILIES:
        spied.append(f._replace(
            race=spy(f.race),
            classes=f.classes if f.classes is None else spy(f.classes)))
    monkeypatch.setattr(families, "FAMILIES", tuple(spied))
    pt.bklMC(m, 1.0, 600, step=100, chains=4, chunk_moves=64, **CPU)
    assert len(seen) >= 2 and set(seen) == {want}


def _facts(blocks):
    """fused_plan's info(T, need) for `blocks` {T: blocks per SM}: 48
    registers, no local bytes, 200 000 dynamic shared bytes at most."""
    return lambda t, need: [blocks[t], 48, 0, 0, 200_000]


@pytest.mark.parametrize("threads", [256, 512])
def test_pinned_threads(threads):
    """Within pinned_threads every fused launch takes the pinned block size
    whatever the rule would pick, and the rule is back after it."""
    with rejfree.pinned_threads(threads):
        got = rejfree.fused_plan("k", _facts({256: 5, 512: 2}), 128, 10_000,
                                 1000, torch.int8, 132)
    assert got["threads"] == threads
    assert rejfree._PINNED is None


def test_pinned_threads_refused():
    """A pinned block size that is not built, or that does not fit, is
    refused."""
    with pytest.raises(ValueError, match="one of"):
        with rejfree.pinned_threads(1024):
            pass
    with pytest.raises(ValueError, match="do not fit"):
        with rejfree.pinned_threads(512):
            rejfree.fused_plan("k", _facts({256: 5, 512: 0}), 128, 10_000,
                               1000, torch.int8, 132)
    assert rejfree._PINNED is None
