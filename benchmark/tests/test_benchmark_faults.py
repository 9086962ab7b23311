"""`correct` comes out true for the port's sound runs, and false for a
run whose timed path is broken underneath the harness (every fault the
cells can have on one chip) and for the control. The harness's look for a
card is skipped: the runs are on the CPU, on the port's plain versions of
its kernels, at small sizes."""

import json

import pytest
import torch

from benchmark.faults import FAULTS
from benchmark.harness import run_cell
from conftest import SMALL

CELLS = ["rrg3-pmj.bkl-b4", "rrg3-pmj.metropolis-b4", "ea3d-pmj.sweep-b2",
         "ea3d-pmj.eo"]


def quiet(*a):
    pass


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(small, cell):
    for seed in (1, 2 ** 33 + 1):
        res = run_cell(cell, seed, 0.05, False, device="cpu", manifest=small,
                       log=quiet)
        assert res["correct"], res["checks"]


CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_faults_are_not_correct(small, cell, fault):
    res = run_cell(cell, 3, 0.05, False, device="cpu", manifest=small,
                   block_hook=FAULTS[fault], log=quiet)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(small):
    """The control (bfloat16 running energies) at the cell's lattice size,
    EA L = 16, where the energies are in the thousands."""
    b = small.base
    for f, upd in (("configs/ea3d-pmj-l16.json", {"L": 16}),
                   ("traffic/sweep-b2.json", {"beta": 2.0, "anneal": 10,
                                              "control": {"block": 2,
                                                          "step": 1}})):
        d = json.loads((b / f).read_text())
        d.update(upd)
        (b / f).write_text(json.dumps(d))
    res = run_cell("ea3d-pmj.sweep-b2", 4, 0.01, False, device="cpu",
                   manifest=small, control=True, log=quiet)
    assert not res["correct"]
    assert res["checks"]["energy_gap"]["value"] > 0
    assert SMALL["sweep-b2"]["chains"] >= 8
