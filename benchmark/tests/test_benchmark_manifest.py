"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every cell, configuration, traffic mix and metric by name, also ones added
as new files only."""

import json
import re

import pytest

from benchmark.manifest import Manifest
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_check_fits_the_day_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_keys(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"]) == len(set(CELLS))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_end_to_end():
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    man = Manifest()
    e2e = {m["name"] for m in man.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = man.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
    traffic = man.traffic(man.cell(cell)["traffic"])
    assert traffic["rate_metric"] in e2e


def test_per_layer_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"API", "sampler loop", "kernel", "device"}


def test_every_named_file_exists():
    man = Manifest()
    for w in SPEC["workloads"]:
        cfg = man.config(w["config"])
        traffic = man.traffic(w["traffic"])
        assert man.generator(cfg).make and man.reference(cfg).energy
        assert man.entry(traffic).block
    for m in SPEC["per_layer"]:
        assert man.reader(m["name"]).read
    for f in (ROOT / "benchmark" / "work").glob("*.py"):
        assert man.work(f.stem).floor and man.work(f.stem).KERNELS


def test_files_added_alone_are_found(small, tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files (and entries of BENCHMARK.json) only: the harness finds
    them and the run reports the new metric, no existing file edited."""
    from benchmark.harness import run_cell

    b = small.base
    cfg = json.loads((b / "configs" / "rrg3-pmj-n1e4.json").read_text())
    cfg.update(name="rrg3-pmj-n128", N=128)
    (b / "configs" / "rrg3-pmj-n128.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "eo.json").read_text())
    tr.update(chains=4, block=20, anneal=20)
    (b / "traffic" / "eo-c4.json").write_text(json.dumps(tr))
    (b / "metrics" / "eo.blocks_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['blocks'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "rrg3-pmj-n128", "source": "https://x",
                            "file": "benchmark/configs/rrg3-pmj-n128.json",
                            "reduced": ["N"], "why": "a test"})
    spec["workloads"].append({"name": "rrg3-pmj.eo-c4",
                              "config": "rrg3-pmj-n128", "traffic": "eo-c4",
                              "chips": 1, "why": "a test"})
    moves = next(m for m in spec["end_to_end"] if m["name"] == "moves_per_s")
    moves["workloads"].append("rrg3-pmj.eo-c4")
    spec["per_layer"].append({"name": "eo.blocks_seen", "unit": "blocks",
                              "better": "higher", "source": "host_clock",
                              "layer": "API", "moves": "moves_per_s",
                              "workloads": ["rrg3-pmj.eo-c4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    man = Manifest(root=tmp_path, base=b)
    assert [m["name"] for m in man.per_layer("rrg3-pmj.eo-c4")] == \
        ["eo.blocks_seen"]
    res = run_cell("rrg3-pmj.eo-c4", 5, 0.05, True, device="cpu",
                   manifest=man, log=lambda *a: None)
    assert res["correct"]
    assert res["metrics"]["eo.blocks_seen"]["value"] == res["attempted"]
    res = run_cell("rrg3-pmj.eo-c4", 5, 0.05, False, device="cpu",
                   manifest=man, log=lambda *a: None)
    assert set(res["metrics"]) == {"moves_per_s", "block_p95_ms", "setup_s"}
