"""Find a cell, its configuration, its traffic mix and its metrics by name.

Nothing here knows a cell: `BENCHMARK.json` names them, and each piece is a
file of its own that this module finds by that name:

* a configuration `<config>` is `configs/<config>.json`; its `generator`
  names `generators/<generator>.py` (the disorder, from the seed) and its
  `reference` names `references/<reference>.py` (the plain reference);
* a traffic mix `<traffic>` is `traffic/<traffic>.json`; its `entry` names
  `entries/<entry>.py`, the adapter that drives one block of the program;
* a per-layer metric `<metric>` is read by `metrics/<metric>.py`;
* a kernel's work count is `work/<kernel>.py`, imported by the metrics that
  read it.

Modules are loaded from their files, so a name may hold dots.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in the file `path`, imported once under the name
    `name`."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


class Manifest:
    """`BENCHMARK.json` and the files it names, under `base` (the folder
    of this file unless a test gives a copy)."""

    def __init__(self, root: Path = ROOT, base: Path = HERE):
        self.root = Path(root)
        self.base = Path(base)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def module(self, kind: str, name: str):
        """The module `<kind>/<name>.py` under the base folder."""
        return load_module(self.base / kind / f"{name}.py",
                           f"_bench_{self.base.as_posix()}_{kind}_{name}")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.base / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.base / "traffic" / f"{name}.json")

    def generator(self, cfg: dict):
        return self.module("generators", cfg["generator"])

    def reference(self, cfg: dict):
        return self.module("references", cfg["reference"])

    def entry(self, traffic: dict):
        return self.module("entries", traffic["entry"])

    def work(self, kernel: str):
        return self.module("work", kernel)

    def reader(self, metric: str):
        return self.module("metrics", metric)

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics that `cell` reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics that list `cell` under `workloads` (every
        per-layer metric of BENCHMARK.json names its cells)."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]
