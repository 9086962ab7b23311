"""On the card: the class kernel (csrc/rejfree_classes.cu) against its plain
version, bit for bit, at the benchmark's shapes (GraphRRG(10^4, 3, +-J)
with 1024 chains at beta = 4, from random spins and from spins kernel bklMC
equilibrated; GraphEA(16, 3, +-J) with 1024 chains at beta = 2) and on the
L = 2 lattice, whose rows hold each neighbour twice, each with every chain
active and with half of them stopping mid-chunk; no spill; and bklMC on
the +-J RRG taking it. The tests skip without a CUDA device (the
fixture decides, never the import). This file imports no JAX: run it on the
card, without tests/conftest.py (which configures JAX), as

    python3 -m pytest --noconftest -m card tests/test_torch_rejfree_classes_card.py
"""

import pytest
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import launch
from rrrmc_tpu_torch.ops import rejfree_classes as rc
from rrrmc_tpu_torch.samplers.families import half_bound

CHAINS, MOVES = 1024, 1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs only on the card")
    return torch.device("cuda")


def _models(dev):
    return {"RRG": (pt.GraphRRG(10_000, 3, (-1, 1), seed=167, device=dev),
                    4.0),
            "EA-3D L=16": (pt.GraphEA(16, 3, (-1, 1), seed=42, device=dev),
                           2.0),
            # each neighbour twice in a row: lane 0 applies the slots
            "EA-3D L=2": (pt.GraphEA(2, 3, (-1, 1), seed=42, device=dev),
                          1.0)}


def _outputs(fn, m, sigma, beta, target):
    B = sigma.shape[0]
    a = dict(sigma=sigma.clone(), lf=m.init_aux(sigma), E=m.energy(sigma),
             coord=torch.zeros(B, dtype=torch.int32, device=sigma.device),
             acc=torch.zeros(B, dtype=torch.int32, device=sigma.device),
             zacc=torch.zeros(B, dtype=torch.float32, device=sigma.device))
    a["cs"], a["es"] = fn(a["sigma"], a["lf"], a["E"], a["coord"], a["acc"],
                          a["zacc"], m.neigh, m.J, mode="bkl",
                          n_moves=MOVES, beta_s=beta * m.scale,
                          target=target, seed=77, move0=5, chain0=3,
                          field_bound=half_bound(m))
    return a


@pytest.mark.card
@pytest.mark.parametrize("start", ["random", "equilibrated"])
@pytest.mark.parametrize("model", ["RRG", "EA-3D L=16", "EA-3D L=2"])
def test_class_kernel_equals_plain(cuda_device, model, start):
    m, beta = _models(cuda_device)[model]
    st = pt.init_state(m, CHAINS, seed=5, device=cuda_device)
    if start == "equilibrated":
        _, st = pt.bklMC(m, beta, 200_000, step=200_000, state=st)
        assert pt.LAST_ROUTE["pick"] == "classes"
    first = _outputs(rc.rejfree_classes_chunk, m, st.sigma, beta, 2 ** 30)
    plan = dict(launch.PLANS["rejfree_classes"])
    assert plan["spill_bytes"] == 0 and plan["blocks_per_sm"] > 0, plan
    half = max(int(first["coord"].double().median().item()), 1)
    for target in (2 ** 30, half):
        k = _outputs(rc.rejfree_classes_chunk, m, st.sigma, beta, target)
        p = _outputs(rc.rejfree_classes_chunk_reference, m, st.sigma, beta,
                     target)
        torch.cuda.synchronize()
        for key in k:
            assert torch.equal(k[key], p[key]), (model, start, target, key)
        assert torch.equal(k["E"], m.energy(k["sigma"]))
        assert torch.equal(k["lf"], m.local_fields(k["sigma"]))
    print(f"{model} {start}: {plan}")


@pytest.mark.card
def test_bklmc_takes_the_class_kernel(cuda_device):
    """bklMC on the +-J RRG runs the class kernel (its launch count rises),
    exact energies and fields."""
    m, beta = _models(cuda_device)["RRG"]
    before = launch.LAUNCHES["rejfree_classes"]
    Es, st = pt.bklMC(m, beta, 2_000_000, step=100_000, chains=CHAINS,
                      seed=9)
    assert pt.LAST_ROUTE["pick"] == "classes"
    assert (pt.LAST_ROUTE["impl"] == "cuda"
            and launch.LAUNCHES["rejfree_classes"] > before)
    assert torch.equal(m.energy(st.sigma), st.E)
    assert torch.equal(m.local_fields(st.sigma), st.aux)
    assert bool(torch.isfinite(Es).all())
