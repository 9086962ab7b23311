"""Tests of the benchmark (`python -m pytest benchmark/tests`). They run on
the CPU, on the port's plain versions of its kernels, at small sizes; the
tests marked `card` need a CUDA device and skip without one (the fixture
`cuda_device` decides, never the import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one); run on "
        "the card with `python -m pytest benchmark/tests -m card`")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs only on the card")
    return torch.device("cuda")


#: small versions of the cells: every size cut, beta lowered to 1 where
#: no chain of a few dozen spins may freeze within a block; the sweep and
#: EO mixes keep enough chains, and the sweep's warm block starts from a
#: one-sweep anneal, so that the replay's statistics separate half the work
SMALL = {
    "rrg3-pmj-n1e4": {"N": 64},
    "ea3d-pmj-l16": {"L": 6},
    "bkl-b4": {"chains": 8, "block": 4000, "step": 1000, "anneal": 4000,
               "beta": 1.0},
    "metropolis-b4": {"chains": 8, "block": 2000, "step": 500,
                      "anneal": 2000, "beta": 1.0,
                      "control": {"block": 1000, "step": 500}},
    "sweep-b2": {"chains": 256, "block": 4, "step": 2, "anneal": 1,
                 "beta": 1.0},
    "eo": {"chains": 64, "block": 61, "anneal": 100},
}
#: the small cells' limits: a few thousand flips a block (work_ratio_gap),
#: a few hundred chains (work_z)
SMALL_LIMITS = {"time": {"work_ratio_gap": 0.5},
                "jump": {"work_ratio_gap": 0.5},
                "replay": {"work_z": 6.0}}


def small_copy(tmp: Path):
    """A copy of BENCHMARK.json and benchmark/ under `tmp`, with every
    configuration and traffic file cut to SMALL's sizes (same names);
    returns its Manifest."""
    from benchmark.manifest import Manifest

    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    b = tmp / "benchmark"
    for kind in ("configs", "traffic"):
        for f in (b / kind).glob("*.json"):
            d = json.loads(f.read_text())
            d.update(SMALL.get(f.stem, {}))
            if kind == "traffic" and d.get("work_check"):
                d.setdefault("limits", {}).update(
                    SMALL_LIMITS[d["work_check"]])
            f.write_text(json.dumps(d))
    return Manifest(root=tmp, base=b)


@pytest.fixture
def small(tmp_path):
    return small_copy(tmp_path)
