"""The port's random K-SAT against the benchmark's plain clause-counting
reference (benchmark/references/sat.py), on formulas drawn by the
benchmark's generator (benchmark/generators/sat.py): SATModel's energy,
init_aux and delta_all, and one bklMC(backend="kernel") call on the SAT
race kernel's plain version, all equal to the reference exactly."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import rrrmc_tpu_torch as pt  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402

MAN = Manifest()
GEN = MAN.generator({"generator": "sat"})
REF = MAN.reference({"reference": "sat"})
SIZES = [64, 200]


def setup(N, seed=5):
    a = GEN.make({"N": N, "K": 3, "alpha": 4.2}, np.random.default_rng(seed))
    return a, GEN.to_program(a, "cpu"), REF.Tables(a, "cpu")


def spins(B, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 2, (B, N), generator=g) * 2 - 1).to(torch.int8)


@pytest.mark.parametrize("N", SIZES)
def test_model_equals_the_reference(N):
    a, model, tab = setup(N)
    assert (model.N, model.Mc, model.K) == (N, round(4.2 * N), 3)
    s = spins(6, N, seed=N)
    aux = model.init_aux(s)
    assert torch.equal(model.energy(s).long(), REF.energy(tab, s))
    assert torch.equal(aux.long(), REF.fields(tab, s))
    assert torch.equal(model.delta_all(s, aux).long(), REF.delta(tab, s))


@pytest.mark.parametrize("N", SIZES)
def test_kernel_bkl_call_equals_the_reference(N):
    """One bklMC call on the race kernel's plain version: the running
    energies, the resident counts and the last checkpoint (the energy
    before the move that crossed it: one flip from E) are the
    reference's."""
    a, model, tab = setup(N, seed=N + 1)
    st = pt.init_state(model, 8, seed=3, C0=spins(8, N, seed=1),
                       device="cpu")
    Es, st = pt.bklMC(model, 1.0, 2000, step=500, state=st,
                      backend="kernel")
    assert pt.LAST_ROUTE["backend"] == "kernel-rejfree-sat"
    assert bool((st.accepted > 0).all())
    assert torch.equal(st.E.long(), REF.energy(tab, st.sigma))
    assert torch.equal(st.aux.long(), REF.fields(tab, st.sigma))
    d = Es[:, -1].long() - st.E.long()
    assert bool((REF.delta(tab, st.sigma) == d[:, None]).any(1).all())
