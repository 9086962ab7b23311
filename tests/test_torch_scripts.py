"""The port's scripts on the CPU: no file of the port imports JAX or the JAX
package; the scoreboard (scripts/torch_bench_all.py) at tiny sizes gives
rows with the JAX artifact's keys and holds its energy guard; the
paper-quant observables equal the JAX models' on the same spins;
`wall_to_target`'s sustained crossing; the tempering scaling at T = 2 and
4; the multi-process weak-scaling worker's chain workload over one and two
gloo ranks, bit for bit; and every script without CUDA and without
--device cpu exits non-zero."""

import ast
import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
CPU = torch.device("cpu")
#: seconds a spawned script or worker may take (they take a few)
PROC_TIMEOUT_S = 120


def _load(name):
    """A script of scripts/ as a module (not run)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("torch_bench_all")
quant = _load("torch_paper_quant")
temper = _load("torch_tempering_scaling")


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((ROOT / "rrrmc_tpu_torch").rglob("*.py"))
    files += sorted(SCRIPTS.glob("torch_*.py"))
    files += [SCRIPTS / "_torch_multihost_worker.py", ROOT / "chip_smoke.py"]
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    """No import of jax or rrrmc_tpu (an AST scan: strings that cite the
    JAX files are not imports)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad += [m for m in mods if m.split(".")[0] in ("jax", "rrrmc_tpu")]
    assert not bad, f"{path}: imports {bad}"


# ---------------------------------------------------------------------------
# the scoreboard at tiny sizes
# ---------------------------------------------------------------------------

_T = dict(target_s=0.01)
#: every kernels row at a tiny size, one rep
TINY_KERNELS = {
    "ea3d_checkerboard_sweep": dict(L=4, B=8, seg=2, nseg=1, reps=1),
    "sk_dense_vmem": dict(N=16, B=8, sweeps=2, nseg=1, reps=1),
    "sk_dense_hbm_streamed": dict(N=16, B=8, sweeps=2, nseg=1, reps=1),
    "rrg_densified_hbm": dict(N=16, B=8, sweeps=2, nseg=1, reps=1),
    "single_site_metropolis": dict(N=16, B=8, iters=200, warm=50, reps=1),
    "rejfree_bkl": dict(L=4, B=8, seg=2000, nseg=1, reps=1),
    "rejfree_wtm": dict(L=4, B=8, seg=2, nseg=1, reps=1),
    "rejfree_bkl_dense_sk": dict(N=16, B=8, seg=2000, step=200, nseg=1,
                                 warm=100, reps=1),
    "rejfree_bkl_rrg1e4_stream": dict(N=16, B=8, probe=200, **_T),
    "rejfree_bkl_sknormal_stream": dict(N=16, B=8, probe=200, **_T),
    "rrr_rrg1e4_stream": dict(N=16, B=8, probe=20, **_T),
    "rrr_rrgnormal1e4_stream_bt512": dict(N=16, B=8, probe=20, **_T),
    "rrr_rrg1e4_sparse": dict(N=16, B=8, probe=20, **_T),
    "bkl_rrg1e4_sparse": dict(N=16, B=8, probe=200, **_T),
    "wtm_rrg1e4_sparse": dict(N=16, B=8, probe=200, **_T),
    "rrr_rrgnormal1e4_sparse": dict(N=16, B=8, probe=20, **_T),
    "bkl_rrgnormal1e4_sparse": dict(N=16, B=8, probe=200, **_T),
    "rrr_ea3d": dict(L=4, B=8, seg=40, step=10, nseg=1, reps=1),
    "rrr_dense_sk": dict(N=16, B=8, seg=40, step=10, nseg=1, reps=1),
    "eo_ea3d": dict(L=4, B=8, iters=20, warm=10, reps=1),
    "eo_dense_sk": dict(N=16, B=8, iters=20, warm=10, reps=1),
    "eo_dense_float": dict(N=16, B=8, iters=20, warm=10, reps=1),
    "eo_sknormal4096_stream": dict(N=16, B=8, probe=10, **_T),
    "eo_rrg1e4_sparse": dict(N=16, B=8, iters=20, warm=10, reps=1),
    "sweep_site_rrg1e4": dict(N=16, B=8, seg=2, nseg=1, reps=1),
    "sweep_site_rrgnormal1e4": dict(N=16, B=8, seg=2, nseg=1, reps=1),
    "bkl_pspin7500": dict(N=12, B=8, probe=200, **_T),
    "rrr_pspin7500": dict(N=12, B=8, probe=20, **_T),
    "eo_pspin7500": dict(N=12, B=8, iters=20, warm=10, reps=1),
}
#: every other section at a tiny size
TINY = {
    "factors": dict(N=32, chains=4, betas=(2.0,), equil_sweeps=2,
                    target_s=0.02),
    "factors_sparse": dict(N=32, chains=4, betas=(2.0,), equil_sweeps=2,
                           target_s=0.02),
    "factors_chains": dict(N=32, chain_counts=(4,), equil_sweeps=2,
                           target_s=0.02),
    "factors_sparse_chains": dict(N=32, chain_counts=(4,), equil_sweeps=2,
                                  target_s=0.02),
    "sat": dict(N=30, chains=4, probe_bkl=200, probe_rrr=20, eo_warm=10,
                eo_iters=20, **_T),
    "perc_comm": dict(chains=4, eo_warm=10, eo_iters=20, families={
        "perc_step": ("GraphPercStep", (15, 7), 20, 1024),
        "perc_linear": ("GraphPercLinear", (15, 7), 20, 1024),
        "perc_xentr": ("GraphPercXEntr", (15, 7, 1.0), 20, 1024),
        "comm_step": ("GraphCommStep", (3, 3, 5), 10, 4),
        "comm_relu": ("GraphCommReLU", (4, 2, 5), 10, 4),
        "comm_qu": ("GraphCommQu", (4, 2, 5), 10, 4)}, **_T),
    "composite_sparse": dict(Nk=16, M=3, chains=4, probe_rrr=20,
                             probe_bkl=200, probe_tle=1, **_T),
    "sparse_chains": dict(N=16, N_pspin=12, chain_counts=(4, 8),
                          probe_rrr=20, probe_bkl=200, eo_warm=10,
                          eo_iters=20, **_T),
    "disorder": dict(N=16, chains=4, D=2, iters=2000),
    "sat_factors": dict(N=30, chains=4, equil_iters=600, equil_seg=300,
                        target_s=0.02, probes=(20, 200, 100, 20)),
}

JAX_ARTIFACT = json.loads((ROOT / "bench_all_results.json").read_text())
#: the committed JAX file's factors_chains_beta4 rows predate the equil_*
#: keys that its equilibrated_factors now returns (and the port's): that
#: section is held to the factors section's keys, made by the same call
KEYS_OF = {"factors_chains_beta4": "factors"}


def _row_id(row):
    return row.get("kernel", row.get("family", row.get("graph")))


def _jax_keys(section, row):
    """The key set the port's row must have: the JAX row's of the same
    name plus ADDED_KEYS (no JAX key only means something on the TPU)."""
    ref = JAX_ARTIFACT[KEYS_OF.get(section, section)]
    same = [r for r in ref if _row_id(r) == _row_id(row)] or ref[:1]
    keys = set(same[0]) | bench.ADDED_KEYS.get(section, set())
    sub = None
    if "rows" in same[0]:
        sub = {k: set(v) for k, v in same[0]["rows"].items()}
    return keys, sub


@pytest.mark.parametrize("section", list(bench.SECTIONS))
def test_scoreboard_section_keys(section, tmp_path):
    """A section at tiny sizes on the CPU: its energy guards hold (a
    failed guard raises) and every row has the JAX artifact's keys for
    that section (per sampler too, for the factor rows)."""
    key, _ = bench.SECTIONS[section]
    sizes = ({"kernels": TINY_KERNELS} if section == "kernels"
             else {section: TINY[section]})
    out = tmp_path / "scoreboard.json"
    res = bench.run(section, str(out), CPU, sizes, log=lambda s: None)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["device"] == "cpu"
    rows = res[key]
    assert rows
    if section == "kernels":
        assert [r["kernel"] for r in rows] == list(bench.KERNEL_ROWS)
        assert {r["kernel"] for r in JAX_ARTIFACT["kernels"]} == set(
            bench.KERNEL_ROWS)
    for row in rows:
        want, sub = _jax_keys(key, row)
        assert set(row) == want, (_row_id(row), set(row) ^ want)
        if sub is not None:
            assert {k: set(v) for k, v in row["rows"].items()} == sub
        for k, v in row.items():
            if isinstance(v, float):
                assert np.isfinite(v), (k, v)


def test_scoreboard_resume_keeps_sections(tmp_path):
    """A run keeps the sections already in the file, and the kernels rows
    done."""
    out = tmp_path / "scoreboard.json"
    out.write_text(json.dumps({"sat": [{"kernel": "kept"}],
                               "kernels": [{"kernel": name} for name in
                                           list(bench.KERNEL_ROWS)[1:]]}))
    res = bench.run("kernels", str(out), CPU, {"kernels": TINY_KERNELS},
                    log=lambda s: None)
    assert res["sat"] == [{"kernel": "kept"}]
    assert [r["kernel"] for r in res["kernels"]][-1] == \
        "ea3d_checkerboard_sweep"
    assert len(res["kernels"]) == len(bench.KERNEL_ROWS)


# ---------------------------------------------------------------------------
# the paper-quant observables and wall_to_target
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["qising", "reising"])
def test_paper_quant_observables_match_jax(kind):
    """Qenergy on GraphQSKT(64, 4) and the RE pair (mean replica E/N,
    composite E/N) on GraphSKRE(64, 3, gamma=2) equal the JAX models'
    Qenergy / REenergies on the same spins within 1e-5 (the JAX script's
    observables, written here: importing that script would set its
    persistent compile cache)."""
    if kind == "qising":
        build = lambda m, **kw: m.GraphQSKT(64, 4, 0.3, 2.0, seed=1, **kw)
    else:
        build = lambda m, **kw: m.GraphSKRE(64, 3, 2.0, 0.4, seed=1, **kw)
    jm, pm = build(rt), build(pt, device="cpu")
    s = np.random.default_rng(2).choice(np.array([-1, 1], np.int8),
                                        (8, pm.N))
    sj = jnp.asarray(s)
    if kind == "qising":
        want = np.asarray(jax.vmap(jm.Qenergy)(sj))
        got = quant.qenergy_batch(pm, torch.from_numpy(s))
    else:
        want = np.asarray(jax.vmap(lambda x: jnp.stack([
            jnp.mean(jm.REenergies(x)) / jm.Nk,
            jm.to_physical(jm.energy(x)) / jm.N]))(sj))
        got = quant.re_obs_batch(pm, torch.from_numpy(s))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=1e-5)


def _traj(values, scalar=True):
    return {"traj": [{"wall_s": float(i + 1),
                      "obs_mean": v if scalar else [v, 0.0]}
                     for i, v in enumerate(values)]}


@pytest.mark.parametrize("scalar", [True, False])
def test_wall_to_target_sustained_crossing(scalar):
    # crosses at t=3 and holds to the end
    assert quant.wall_to_target(_traj([5, 4, 2, 1, 1.5], scalar), 2.0) == 3
    # touches at t=2 but does not hold: only the last crossing counts
    assert quant.wall_to_target(_traj([5, 1, 3, 2, 2], scalar), 2.0) == 4
    # a crossing that does not hold to the end gives None
    assert quant.wall_to_target(_traj([5, 1, 1, 3], scalar), 2.0) is None
    assert quant.wall_to_target(_traj([5, 4], scalar), 2.0) is None


# ---------------------------------------------------------------------------
# tempering scaling, multi-process weak scaling, no silent CPU
# ---------------------------------------------------------------------------

def test_tempering_scaling_rows():
    """T = 2 and 4, 2 rounds: the JAX row's keys with first_call_s in
    place of compile_s, and swaps accepted."""
    out = temper.run(2, device=CPU, ladders=(2, 4), log=lambda s: None)
    jax_rows = json.loads((ROOT / "tempering_scaling.json").read_text())
    want = set(jax_rows["rows"][0]) - {"compile_s"} | {"first_call_s"}
    assert [r["T"] for r in out["rows"]] == [2, 4]
    for r in out["rows"]:
        assert set(r) == want
        assert r["swap_acc_mean"] > 0 and r["round_s"] > 0
        assert r["round_per_slot_s"] == pytest.approx(r["round_s"] / r["T"])


def test_multihost_chain_workload_bit_exact():
    """gloo at P = 1 and 2 with the same total chains: the chain
    workload's gathered energies are equal bit for bit, on the sweep
    kernel's route, and the efficiency rows come out."""
    eff = _load("torch_multihost_eff")
    small = ["--sweeps", "20", "--pt-rounds", "2", "--pt-sweeps", "5",
             "--pt-chains", "4", "--reps", "1", "--L", "4"]
    runs = {1: [eff.run_p(1, "cpu", small + ["--chains-per-rank", "16"],
                          timeout=PROC_TIMEOUT_S)],
            2: [eff.run_p(2, "cpu", small + ["--chains-per-rank", "8"],
                          timeout=PROC_TIMEOUT_S)]}
    assert runs[1][0]["chains_E"] == runs[2][0]["chains_E"]
    assert len(runs[2][0]["chains_E"]) == 16
    assert runs[2][0]["backend"] == "gloo"
    assert runs[2][0]["chains_route"] == "kernel-sweep"
    assert runs[2][0]["pt_route"] == "kernel-site-tempering"
    res = eff.efficiency(runs)
    assert res["efficiency"]["1"]["chains"] == 1.0
    assert set(res["rows"]) == {"1", "2"} and res["efficiency"]["2"]["pt"] > 0


@pytest.mark.parametrize("script", ["torch_bench_all", "torch_paper_quant",
                                    "torch_tempering_scaling",
                                    "torch_multihost_eff",
                                    "_torch_multihost_worker"])
def test_no_silent_cpu(script, tmp_path):
    """Without CUDA and without --device cpu a script exits non-zero with
    a message, and writes no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    args = {"torch_bench_all": ["sat", str(tmp_path / "o.json")],
            "torch_paper_quant": ["1", "8", "qising", "--out",
                                  str(tmp_path / "o.json")],
            "torch_tempering_scaling": ["2", str(tmp_path / "o.json")],
            "torch_multihost_eff": [str(tmp_path / "o.json")],
            "_torch_multihost_worker": ["0", "1", str(_free_port()),
                                        str(tmp_path / "o.json")]}[script]
    p = subprocess.run([sys.executable, str(SCRIPTS / f"{script}.py"),
                        *args], env=env, capture_output=True, text=True,
                       timeout=PROC_TIMEOUT_S, cwd=tmp_path)
    assert p.returncode != 0, p.stdout
    assert not (tmp_path / "o.json").exists()
    assert "no CUDA device" in p.stderr


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
