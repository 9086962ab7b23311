"""The window arithmetic, the arguments and the result line: rates are all
the window's work over all its time, the p95 is over every block, a run
without a card prints nothing and fails."""

import json
import statistics
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.run import parse
from conftest import ROOT


class Clock:
    """A clock that a fake block advances by its given durations."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_measure_counts_every_block_and_the_whole_window():
    clock = Clock()
    durations = iter([0.010, 0.012, 0.500, 0.011, 0.010, 0.013] * 100)

    def step():
        clock.t += next(durations)

    times, window = harness.measure(step, 1.0, clock=clock)
    assert window == pytest.approx(sum(times))
    assert window >= 1.0 and window - times[-1] < 1.0
    # the rate of a cell is the work of every block over that window
    work = 1000 * len(times)
    assert work / window == pytest.approx(1000 * len(times) / sum(times))


def test_p95_is_over_all_blocks_not_over_medians():
    times = [0.050 if i % 10 == 9 else 0.010 for i in range(100)]
    assert harness.p95(times) == pytest.approx(
        statistics.quantiles(times, n=20, method="inclusive")[18])
    assert harness.p95(times) >= 0.048
    # the medians of chunks of ten would hide the slow blocks
    medians = [statistics.median(times[i:i + 10]) for i in range(0, 100, 10)]
    assert max(medians) < harness.p95(times)
    assert harness.p95([0.5]) == 0.5


@pytest.mark.parametrize("argv,ok", [
    (["--workload", "x", "--seed", "4294967311", "--seconds", "10",
      "--trace", "1"], True),
    (["--workload", "x", "--seed", "3", "--seconds", "2.5"], True),
    (["--workload", "x", "--seed", "-1", "--seconds", "2"], False),
    (["--workload", "x", "--seed", "1", "--seconds", "0"], False),
    (["--workload", "x", "--seed", "1", "--seconds", "2", "--trace", "2"],
     False),
    (["--seed", "1", "--seconds", "2"], False),
])
def test_arguments(argv, ok):
    if ok:
        a = parse(argv)
        assert a.workload == "x" and a.seconds > 0
    else:
        with pytest.raises(SystemExit):
            parse(argv)


def test_seeds_are_reproducible_and_take_large_values():
    a, b = harness.seeds(2 ** 33 + 5), harness.seeds(2 ** 33 + 5)
    assert a["spins"] == b["spins"] and a["program"] == b["program"]
    assert a["graph"].integers(1 << 30) == b["graph"].integers(1 << 30)
    assert 0 <= a["program"] < 2 ** 31
    assert harness.seeds(7)["program"] != harness.seeds(8)["program"]


def test_without_a_card_no_result_and_nonzero_exit():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "ea3d-pmj.eo", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_result_line_keys(small):
    """correct, attempted, failed, metrics and device are there, the
    numbers compared come last, and the metrics are the cell's end-to-end
    ones with their units."""
    res = harness.run_cell("ea3d-pmj.sweep-b2", 11, 0.05, False,
                           device="cpu", manifest=small, log=lambda *a: None)
    keys = list(res)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "checks" and {"metrics", "device"} <= set(keys)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"flips_per_s", "block_p95_ms", "setup_s"}
    assert res["metrics"]["flips_per_s"]["unit"] == "flips/s"
    assert res["metrics"]["flips_per_s"]["value"] > 0
    json.dumps(harness.finite(res))
