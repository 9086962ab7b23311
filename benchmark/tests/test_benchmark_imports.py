"""No run holds JAX or the JAX package, compared by whole top-level names,
and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark.harness import foreign_modules
from conftest import ROOT


@pytest.mark.parametrize("names,found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["rrrmc_tpu", "rrrmc_tpu.samplers.bkl"],
     ["rrrmc_tpu", "rrrmc_tpu.samplers.bkl"]),
    (["rrrmc_tpu_torch", "rrrmc_tpu_torch.ops.site", "jaxtyping",
      "rrrmc_tpux", "benchmark.jax"], []),
])
def test_foreign_modules_compare_whole_top_level_names(names, found):
    assert foreign_modules({n: None for n in names}) == found


def test_the_program_and_the_harness_load_no_jax():
    """The port and the harness, as a run imports them, in a fresh
    process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import rrrmc_tpu_torch, benchmark.harness, benchmark.checks\n"
            "from benchmark.harness import foreign_modules\n"
            "print(foreign_modules())") % str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "PYTHONNOUSERSITE": "1"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


REFERENCE_FILES = sorted((ROOT / "benchmark" / "references").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "rrrmc_tpu", "rrrmc_tpu_torch")


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in FORBIDDEN, (path.name, m)


def test_reference_runs_without_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import numpy as np, torch\n"
            "from benchmark.manifest import Manifest\n"
            "m = Manifest()\n"
            "ref = m.reference({'reference': 'pairwise'})\n"
            "ctl = m.module('references', 'pairwise_control')\n"
            "a = m.generator({'generator': 'rrg'}).make("
            "{'N': 64, 'K': 3, 'levels': [-1, 1]}, np.random.default_rng(1))\n"
            "t = ref.Tables(a, 'cpu')\n"
            "ref.energy(t, torch.ones(2, 64, dtype=torch.int8))\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in %r))"
            ) % (str(ROOT), FORBIDDEN)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_a_reader_that_loads_jax_gives_no_result(small, tmp_path):
    """A per-layer reader, run after the window, imports a module named
    jax (a stand-in package on the path): the run prints no result line
    and exits 3, as run.py does."""
    fake = tmp_path / "site"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    (small.base / "metrics" / "eo.loads_jax.py").write_text(
        "def read(ctx):\n    import jax  # noqa: F401\n    return 1.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "eo.loads_jax", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "API", "moves": "moves_per_s",
                              "workloads": ["ea3d-pmj.eo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from benchmark.harness import report, run_cell\n"
        "from benchmark.manifest import Manifest\n"
        "man = Manifest(root=%r, base=%r)\n"
        "res = run_cell('ea3d-pmj.eo', 7, 0.05, True, device='cpu', "
        "manifest=man, log=lambda *a: None)\n"
        "assert 'jax' not in res['metrics'] and res['correct']\n"
        "sys.exit(report(res))\n") % (str(ROOT), str(fake), str(tmp_path),
                                      str(small.base))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 3, r.stderr[-3000:]
    assert r.stdout.strip() == ""
    assert "loaded: jax" in r.stderr
