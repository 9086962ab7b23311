"""One run of one cell: set-up, the measured window, the reference
comparison and the result line.

A block is one call of the cell's entry point on the state that the last
block left, ended by `torch.cuda.synchronize()`; blocks run back to back in
a closed loop from one client until the window's seconds have passed. The
rate is all the work of the window's blocks over the window's time (the
first block's start to the last block's end), and `block_p95_ms` the 95th
percentile of every block's time in it. Set-up is everything from the
process's start to the first timed block: imports, the CUDA context, the
library (built only by a checkout's first run), the model from the seed,
the anneal and one warm block of the window's own shape.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from . import checks
from .manifest import Manifest, load_json, HERE
from .trace import WINDOW, summarize

#: top-level module names that no run may hold once its window has closed
FOREIGN = ("jax", "jaxlib", "flax", "rrrmc_tpu")


@dataclass
class Run:
    """What an entry adapter drives: the port's model, the benchmark's
    arrays it was made from, the traffic mix, the device and the seed
    handed to the program."""
    model: Any
    arrays: dict
    traffic: dict
    device: Any
    seed: int


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FOREIGN, compared
    whole (rrrmc_tpu_torch is not rrrmc_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FOREIGN)


def seeds(seed: int) -> dict:
    """The run's streams from --seed: the disorder's NumPy generator, the
    drawn spins' torch seed and the seed the program gets (31 bits)."""
    g, s, p = np.random.SeedSequence(int(seed)).spawn(3)
    return {"graph": np.random.default_rng(g),
            "spins": int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)),
            "program": int(p.generate_state(1)[0] >> 1)}


def draw_spins(B: int, N: int, seed: int, device):
    """[B, N] int8 random +-1 spins from a torch.Generator on `device`."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (B, N), generator=g, device=device,
                         dtype=torch.int8)
    return bits * 2 - 1


def p95(times: list) -> float:
    """The 95th percentile of `times` (statistics.quantiles, inclusive);
    the largest where there are fewer than two."""
    if len(times) < 2:
        return max(times)
    return statistics.quantiles(times, n=20, method="inclusive")[18]


def measure(step: Callable, seconds: float, clock=time.perf_counter):
    """Call step() back to back until `seconds` have passed since the
    first call began; returns (each call's seconds, the window's seconds:
    the first call's start to the last call's end)."""
    times = []
    w0 = clock()
    while True:
        b0 = clock()
        step()
        b1 = clock()
        times.append(b1 - b0)
        if b1 - w0 >= seconds:
            return times, b1 - w0


def card(device) -> dict:
    import torch

    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1}
    if device.type == "cuda":
        try:
            out["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", "-i", str(device.index or 0)],
                capture_output=True, text=True, timeout=60,
                check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out["power_limit"] = "not read"
    return out


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: Optional[float] = None,
             manifest: Optional[Manifest] = None,
             block_hook: Optional[Callable] = None,
             control: bool = False, log=None) -> dict:
    """Run cell `name` once; returns the result line's object. block_hook
    (tests) wraps the entry's block function, to plant a fault under the
    harness; control=True puts the configuration's control (the reference
    in a lower precision) in the program's place in the window."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    marks = [("imports", time.perf_counter())]
    man = manifest or Manifest()
    cell = man.cell(name)
    cfg = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    if control:
        traffic = dict(traffic, **traffic.get("control", {}))
    gen, ref, entry = man.generator(cfg), man.reference(cfg), man.entry(traffic)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    sd = seeds(seed)
    arrays = gen.make(cfg, sd["graph"])
    run = Run(model=gen.to_program(arrays, device), arrays=arrays,
              traffic=traffic, device=device, seed=sd["program"])
    marks.append(("model", time.perf_counter()))
    B, N = int(traffic["chains"]), int(arrays["N"])
    sigma0 = draw_spins(B, N, sd["spins"], device)
    state, anneal = entry.prepare(run, sigma0)
    sync(device)
    marks.append(("anneal", time.perf_counter()))
    block = entry.block
    if control:
        ctl = man.module("references", cfg["control"])
        tab_c = ref.Tables(arrays, device)
        state = ctl.from_view(run, ref, tab_c, anneal)
        block = lambda r, s: ctl.block(r, ref, tab_c, s)     # noqa: E731
    if block_hook is not None:
        block = block_hook(block)
    state, first = block(run, state)                     # the warm block
    sync(device)
    start_view = first
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    marks.append(("warm block", t0 + setup_s))
    log("setup: " + ", ".join(f"{k} {b - a:.3f} s" for (_, a), (k, b) in
                               zip([("", t0)] + marks, marks)))
    box = {"state": state, "first": first, "last": first}

    def step():
        with torch.profiler.record_function("benchmark.block"):
            box["state"], view = block(run, box["state"])
            sync(device)
        box["first"], box["last"] = box["last"], view

    with torch.profiler.record_function(WINDOW):
        times, window_s = measure(step, seconds)
    first, last = box["first"], box["last"]
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    blocks = len(times)
    flips = None
    if last.get("accepted") is not None:
        flips = int((last["accepted"].long()
                     - start_view["accepted"].long()).sum())
    work = entry.work(run, blocks, flips)
    del state, box
    tab = ref.Tables(arrays, device)
    values = checks.compare(ref, tab, traffic, sigma0=sigma0, anneal=anneal,
                            first=first, last=last)
    if traffic.get("work_check") == "replay":
        values["work_z"] = checks.replay(
            man.module("references", cfg["control"]), ref, tab, run,
            [(anneal, start_view), (first, last)])
    correct, rows = checks.judge(values, traffic.get("limits", {}))
    dev = card(device)
    dev["memory_peak_bytes"] = int(peak)
    metrics = {}
    result = {"correct": bool(correct), "attempted": blocks, "failed": 0}
    if not trace:
        for m in man.end_to_end(name):
            v = {"setup_s": setup_s,
                 "block_p95_ms": 1e3 * p95(times)}.get(m["name"])
            if v is None and m["name"] == traffic["rate_metric"]:
                v = work[traffic["rate_work"]] / window_s
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        summ = summarize(prof)
        dev["busy_s"] = summ.busy_s
        dev["window_s"] = summ.window_s
        ctx = {"trace": summ, "blocks": blocks, "window_s": window_s,
               "work": work, "run": run, "manifest": man,
               "peaks": load_json(HERE / "peaks.json"), "device": dev,
               "log": log}
        for m in man.per_layer(name):
            v = man.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = summ.breakdown()
    result.update({"metrics": metrics, "device": dev})
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        log(f"check {k}: {v} (limit {lim})")
    return result


def finite(x):
    """x for the JSON line: floats that are not finite as strings."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def report(result: dict, out=None) -> int:
    """Print the result line and return 0; or, where a module of JAX or
    of the JAX package is loaded by now (the window, the comparison and
    every per-layer reader have run), name it on standard error, print no
    result and return 3."""
    foreign = foreign_modules()
    if foreign:
        print("loaded: " + ", ".join(foreign), file=sys.stderr, flush=True)
        return 3
    print(json.dumps(finite(result)), file=out or sys.stdout, flush=True)
    return 0
