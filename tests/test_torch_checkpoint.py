"""Checkpoints of the port (rrrmc_tpu_torch/utils/checkpoint.py), as
tests/test_hooks_checkpoint.py holds the JAX package: a state saved,
loaded into a template and continued equals the same continuation of the
state in memory, bit for bit, generators included; a template of another
shape or structure is refused."""

import pytest
import torch

import rrrmc_tpu_torch as pt

from torch_port_helpers import CPU

torch.set_num_threads(1)


def _lattice():
    return pt.GraphEA(4, 2, (-1, 1), seed=1, **CPU)


#: continuation calls of each route, from a state
ROUTES = {
    "site kernel": lambda X, st: pt.standardMC(X, 2.0, 500, step=100,
                                                chains=4, state=st,
                                                backend="kernel"),
    "race kernel": lambda X, st: pt.bklMC(X, 2.0, 400, step=100, chains=4,
                                          state=st, chunk_moves=32),
    "torch route": lambda X, st: pt.standardMC(X, 2.0, 300, step=100,
                                               chains=4, state=st),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_mcstate_resume_is_exact(tmp_path, route):
    X = _lattice()
    call = ROUTES[route]
    p = str(tmp_path / "ck.npz")
    _, st = call(X, pt.init_state(X, 4, seed=3, **CPU))
    pt.save_state(p, st)
    Es_a, st_a = call(X, st)
    st2 = pt.load_state(p, like=pt.init_state(X, 4, seed=999, **CPU))
    Es_b, st_b = call(X, st2)
    assert torch.equal(Es_a, Es_b)
    for f in ("sigma", "E", "accepted"):
        assert torch.equal(getattr(st_a, f), getattr(st_b, f))
    assert torch.equal(st_a.generator.get_state(),
                       st_b.generator.get_state())


def test_ptstate_resume_is_exact(tmp_path):
    X = _lattice()
    betas = [0.5, 1.0, 1.5, 2.0]
    p = str(tmp_path / "pt.npz")
    _, _, st = pt.parallel_tempering(X, betas, 5, sweeps_per_round=2,
                                     chains=6, seed=2, device="cpu")
    pt.save_state(p, st)
    a = pt.parallel_tempering(X, betas, 7, sweeps_per_round=2, chains=6,
                              state=st)
    like = pt.parallel_tempering(X, betas, 0, chains=6, seed=0,
                                 device="cpu")[2]
    b = pt.parallel_tempering(X, betas, 7, sweeps_per_round=2, chains=6,
                              state=pt.load_state(p, like=like))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for f in ("sigma", "aux", "E", "rank", "swap_acc"):
        assert torch.equal(getattr(a[2], f), getattr(b[2], f)), f
    # the saved run and its continuation are one 12-round call
    one = pt.parallel_tempering(X, betas, 12, sweeps_per_round=2, chains=6,
                                seed=2, device="cpu")
    assert torch.equal(one[0][5:], b[0]) and torch.equal(one[1][5:], b[1])
    assert torch.equal(one[2].sigma, b[2].sigma)


def test_etstate_resume_is_exact(tmp_path):
    X = _lattice()
    betas = [0.5, 1.0, 2.0]
    p = str(tmp_path / "et.npz")
    kw = dict(moves_per_round=16, chains=4, kernel=pt.sweep_kernel)
    _, _, st = pt.tempered_ensembles([X] * 3, betas, 4, seed=5,
                                     device="cpu", **kw)
    pt.save_state(p, st)
    a = pt.tempered_ensembles([X] * 3, betas, 5, state=st, **kw)
    like = pt.tempered_ensembles([X] * 3, betas, 0, seed=0, device="cpu",
                                 **kw)[2]
    b = pt.tempered_ensembles([X] * 3, betas, 5,
                              state=pt.load_state(p, like=like), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for sa, sb in zip(a[2].slots, b[2].slots):
        assert torch.equal(sa.sigma, sb.sigma) and torch.equal(sa.E, sb.E)
    one = pt.tempered_ensembles([X] * 3, betas, 9, seed=5, device="cpu",
                                **kw)
    assert torch.equal(one[0][4:], b[0]) and torch.equal(one[1][4:], b[1])


def test_eoresult_round_trip(tmp_path):
    X = pt.GraphRRG(16, 3, (-1, 1), seed=4, **CPU)
    r = pt.extremal_opt(X, 1.4, 50, chains=4, seed=1, device="cpu")
    p = str(tmp_path / "eo.npz")
    pt.save_state(p, r)
    like = pt.extremal_opt(X, 1.4, 1, chains=4, seed=2, device="cpu")
    got = pt.load_state(p, like=like)
    for f in ("sigma", "E", "Emin", "sigma_min", "itmin"):
        assert torch.equal(getattr(got, f), getattr(r, f))


def test_chain0_round_trips(tmp_path):
    import dataclasses

    X = _lattice()
    st = dataclasses.replace(pt.init_state(X, 4, seed=3, **CPU), chain0=12)
    p = str(tmp_path / "c0.npz")
    pt.save_state(p, st)
    assert pt.load_state(p, like=pt.init_state(X, 4, seed=0,
                                               **CPU)).chain0 == 12


def test_mismatch_refused(tmp_path):
    X = _lattice()
    p = str(tmp_path / "ck.npz")
    pt.save_state(p, pt.init_state(X, 4, seed=3, **CPU))
    with pytest.raises(ValueError, match="shape"):
        pt.load_state(p, like=pt.init_state(X, 8, seed=0, **CPU))
    _, _, pst = pt.parallel_tempering(X, [1.0, 2.0], 1, chains=4,
                                      device="cpu")
    with pytest.raises(ValueError, match="structure"):
        pt.load_state(p, like=pst)
