"""Chain, disorder and ladder sharding of the port
(rrrmc_tpu_torch/parallel/mesh.py and tempering.py) on a mesh of CPU
devices, as tests/test_parallel.py and tests/test_disorder.py hold the JAX
package on its virtual CPU devices: a run cut into shards equals the
unsharded run bit for bit on the kernel routes (the shards key their
chains by global id, MCState.chain0, and copy the unsharded generator),
and sample_disorder equals the sequential calls."""

import dataclasses

import pytest
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.parallel.mesh import (make_mesh, sample_disorder,
                                           sample_sharded, shard_leading,
                                           stack_models)

from torch_port_helpers import CPU

torch.set_num_threads(1)

HOST4 = ["cpu"] * 4


def _lattice():
    return pt.GraphEA(4, 2, (-1, 1), seed=9, **CPU)


def _rrg():
    return pt.GraphRRG(24, 3, (-1, 1), seed=5, **CPU)


#: (sampler, model, args, keywords, route) of each kernel route
RUNS = {
    "standardMC site kernel": (pt.standardMC, _rrg, (1.5, 600),
                               dict(step=100, backend="kernel"),
                               "kernel-site"),
    "sweepMC checkerboard": (pt.sweepMC, _lattice, (1.5, 20),
                             dict(step=5), "kernel-sweep"),
    "sweepMC site-sweep": (pt.sweepMC, _rrg, (1.5, 20), dict(step=5),
                           "kernel-site-sweep"),
    "bklMC race": (pt.bklMC, _rrg, (2.0, 400), dict(step=100,
                                                    chunk_moves=64),
                   "kernel-rejfree-sparse"),
    "extremal_opt EO": (pt.extremal_opt, _rrg, (1.4, 50), {},
                        "kernel-eo-sparse"),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_sample_sharded_matches_unsharded(name):
    """Four shards on the host equal the unsharded call bit for bit:
    series, spins, energies, counters."""
    sampler, build, args, kw, route = RUNS[name]
    X = build()
    mesh = make_mesh({"chains": 4}, devices=HOST4)
    got = sample_sharded(sampler, X, mesh, *args, chains=16, seed=7, **kw)
    assert pt.LAST_ROUTE["backend"] == route
    assert pt.LAST_ROUTE["shards"] == 4
    want = sampler(X, *args, chains=16, seed=7, device="cpu", **kw)
    if isinstance(want, tuple):
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if torch.is_tensor(b):
            assert torch.equal(a, b), f.name
    if isinstance(want, pt.MCState):
        assert got.chain0 == 0


def test_shard_leading_moves_chain0():
    X = _rrg()
    st = pt.init_state(X, 12, seed=3, **CPU)
    shards = shard_leading(st, make_mesh({"chains": 3},
                                         devices=["cpu"] * 3))
    assert [s.chain0 for s in shards] == [0, 4, 8]
    assert torch.equal(torch.cat([s.sigma for s in shards]), st.sigma)
    assert all(s.generator is not st.generator for s in shards)


def test_make_mesh_rejects_a_size_mismatch():
    with pytest.raises(ValueError, match="devices"):
        make_mesh({"temp": 3}, devices=HOST4)


PT_BETAS = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0]


@pytest.mark.parametrize("layout", [
    ({"temp": 4}, None), ({"chains": 2}, "chains"),
    ({"temp": 2, "chains": 2}, "chains")])
def test_pt_sharded_matches_unsharded(layout):
    """Parallel tempering with its T axis, its chain axis or both cut into
    shards equals the unsharded run bit for bit (energies, ranks, the
    final state)."""
    sizes, chain_axis = layout
    X = _lattice()
    kw = dict(sweeps_per_round=2, chains=8, seed=1)
    want = pt.parallel_tempering(X, PT_BETAS, 12, device="cpu", **kw)
    mesh = make_mesh(sizes, devices=["cpu"] * int(
        torch.tensor(list(sizes.values())).prod()))
    got = pt.parallel_tempering(X, PT_BETAS, 12, mesh=mesh,
                                chain_axis=chain_axis, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for f in ("sigma", "aux", "E", "rank", "swap_acc"):
        assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f


def test_sample_disorder_matches_sequential():
    """One call an instance, each from init_state(seed + 104729 d): the
    stacked result equals the sequential calls."""
    models = [pt.GraphEA(4, 2, (-1, 1), seed=s, **CPU) for s in (1, 2, 3)]
    Es_d, st_d = sample_disorder(pt.standardMC, models, 1.5, 600, step=100,
                                 chains=8, seed=5, backend="kernel")
    assert Es_d.shape == (3, 8, 6)
    assert pt.LAST_ROUTE["disorder_instances"] == 3
    for d, m in enumerate(models):
        st = pt.init_state(m, 8, 5 + 104729 * d, **CPU)
        Es, st2 = pt.standardMC(m, 1.5, 600, step=100, chains=8, state=st,
                                backend="kernel")
        assert torch.equal(Es_d[d], Es)
        assert torch.equal(st_d.sigma[d], st2.sigma)
        assert torch.equal(st_d.E[d], m.energy(st_d.sigma[d]))


def test_sample_disorder_bkl_on_a_mesh():
    """bklMC over four RRG instances, one a position of a host mesh:
    equal to the sequential calls, and a stacked state continues."""
    models = [pt.GraphRRG(16, 3, (-1, 1), seed=s, **CPU) for s in range(4)]
    mesh = make_mesh({"disorder": 2}, devices=["cpu"] * 2)
    Es_d, st_d = sample_disorder(pt.bklMC, models, 1.5, 300, step=100,
                                 chains=4, seed=9, mesh=mesh, chunk_moves=32)
    for d, m in enumerate(models):
        st = pt.init_state(m, 4, 9 + 104729 * d, **CPU)
        Es, _ = pt.bklMC(m, 1.5, 300, step=100, chains=4, state=st,
                         chunk_moves=32)
        assert torch.equal(Es_d[d], Es)
    Es2, st2 = sample_disorder(pt.bklMC, models, 1.5, 300, step=100,
                               chains=4, state=st_d, chunk_moves=32)
    assert Es2.shape == (4, 4, 3) and isinstance(st2.generator, tuple)
    for d, m in enumerate(models):
        assert torch.equal(st2.E[d], m.energy(st2.sigma[d]))


def test_stack_models_stacks_tables():
    models = [pt.GraphRRG(16, 3, (-1, 1), seed=s, **CPU) for s in range(3)]
    st = stack_models(models)
    assert st.J.shape == (3, 16, 3) and st.N == 16
