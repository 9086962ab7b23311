"""On the card: the checkerboard kernel's fields epilogue (csrc/sweep.cu,
a call's last launch) against the model's local_fields, bit for bit, in
every instantiation the lattices reach (threshold table and exp path, four
chains a lane and one, D = 2, 3 and 4 on the run-time-D one), at the
benchmark's 8192 chains and at a ragged batch; each with no spill, and
with the spins and energies of a launch without the epilogue. The tests
skip without a CUDA device (the fixture decides, never the import). This
file imports no JAX: run it on the card, without tests/conftest.py (which
configures JAX), as

    python3 -m pytest --noconftest -m card tests/test_torch_sweep_card.py
"""

import pytest
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import launch, sweep

#: D: L (N = 4096) and the coupling level of the exp path, which keeps
#: every site's sum of |J| at 120: four chains a lane, max |half| above 64
SHAPES = {2: (64, 30), 3: (16, 20), 4: (8, 15)}
#: the benchmark's chains, and a batch that leaves the last block ragged
BATCHES = (8192, 1003)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs only on the card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("lanes", ["4 chains", "1 chain"])
@pytest.mark.parametrize("path", ["table", "exp"])
@pytest.mark.parametrize("D", sorted(SHAPES))
def test_epilogue_writes_local_fields(cuda_device, D, path, lanes, B):
    L, level = SHAPES[D]
    J = (-1, 1) if path == "table" else (-level, level)
    m = pt.GraphEA(L, D, J, seed=42, device=cuda_device)
    sw = sweep.Sweeper(m, 2.0)
    assert sw.table == (path == "table") and sw.rows.swar
    rows = (sw.rows if lanes == "4 chains"
            else sweep.site_rows(sw.Jp, sw.Jm, L, D))
    st = pt.init_state(m, B, seed=7, device=cuda_device)
    kw = dict(L=L, D=D, n_sweeps=3, beta2s=sw.beta2s, seed=11)
    out = []
    for aux in (None, torch.full((B, m.N), -7, dtype=torch.int32,
                                 device=cuda_device)):
        s, E = st.sigma.clone(), st.E.clone()
        sweep.sweep_chunk(s, E, sw.Jp, sw.Jm, sw.th, rows=rows, aux=aux,
                          **kw)
        torch.cuda.synchronize()
        plan = launch.PLANS["sweep"]
        assert plan["lanes"] == lanes
        assert plan["spill_bytes"] == 0, plan
        out.append((s, E, aux))
    (s0, E0, _), (s1, E1, aux) = out
    assert torch.equal(s1, s0) and torch.equal(E1, E0)
    assert torch.equal(aux, m.local_fields(s1))
    ps, pE = st.sigma.clone(), st.E.clone()
    pa = torch.zeros_like(aux)
    sweep.sweep_chunk_reference(ps, pE, sw.Jp, sw.Jm, sw.th, aux=pa, **kw)
    assert torch.equal(ps, s1) and torch.equal(pE, E1)
    assert torch.equal(pa, aux)
    assert not torch.equal(s1, st.sigma)


@pytest.mark.card
def test_sweepmc_takes_the_fields_from_its_last_launch(cuda_device):
    """The benchmark's call on the card: sweepMC on GraphEA(16, 3), 8192
    chains, 10 launches; the fields come from the last one."""
    m = pt.GraphEA(16, 3, (-1, 1), seed=42, device=cuda_device)
    Es, st = pt.sweepMC(m, 2.0, 100, step=10, chains=8192, seed=5)
    assert pt.LAST_ROUTE["backend"] == "kernel-sweep"
    assert pt.LAST_ROUTE["impl"] == "cuda" and pt.LAST_ROUTE["aux"] == "kernel"
    assert torch.equal(st.aux, m.local_fields(st.sigma))
    assert torch.equal(m.energy(st.sigma), st.E)
