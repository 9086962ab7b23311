"""Where a move of the generic torch path goes (rrrmc_tpu_torch/samplers/
{bkl,wtm,rrr}.py), on one CUDA card: one call each of bklMC, wtmMC and
rrrMC with backend="torch" of exactly MOVES moves (bkl and wtm: one chunk
of MOVES moves, stopped by the hook; rrr: one checkpoint of MOVES moves)
on each case of CASES:

* "rrg": GraphRRG(1000, 3) +-J (seed 167), 128 chains at beta=2;
* "le": GraphLocalEntropy(1000, M=8, gamma=1, beta=1) over GraphRRG(1000,
  3) +-J (seed 13), 128 chains at beta=1 (composite N = 9000; no race
  kernel takes it);
* "comm": GraphCommStep(65, 15, 487, seed=5), 256 chains at beta=1.

Each call runs twice after a warm-up: once timed with CUDA events around
it (the wall time a move), once under torch.profiler (CPU and CUDA
activities). Per move the script reports the device kernels, the kernel
launch calls, the aten operator calls (nested ones included), the host
synchronisations (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize), the cudaMemcpy* calls (of any direction: a copy to
the host would also show as a synchronisation), the device time summed
over the kernels and its share of the wall time, the wall time a launch
call, and the aten operators that take the most host time. One JSON
object per case and sampler on stdout, with the card's name and power
limit.

    python scripts/torch_generic_profile.py [--out profile.json]

A script in scripts/ needs the repo on PYTHONPATH.
"""

from __future__ import annotations

import argparse
import collections
import json

import torch

import rrrmc_tpu_torch as rt
from rrrmc_tpu_torch.bench import card_line
from rrrmc_tpu_torch.utils import profiling

MOVES = 200
#: case -> () -> (model, chains, beta), as the module docstring lists them
CASES = {
    "rrg": lambda: (rt.GraphRRG(1000, 3, (-1, 1), seed=167), 128, 2.0),
    "le": lambda: (rt.GraphLocalEntropy(
        1000, 8, 1.0, 1.0, rt.GraphRRG(1000, 3, (-1, 1), seed=13)), 128, 1.0),
    "comm": lambda: (rt.GraphCommStep(65, 15, 487, seed=5), 256, 1.0)}


def calls(X, C0, beta):
    """Each sampler's generic call of exactly MOVES moves."""
    stop = lambda *a: False   # noqa: E731 (one chunk, then stop)
    kw = dict(chains=C0.shape[0], C0=C0, chunk_moves=MOVES,
              backend="torch")
    return {
        "bklMC": lambda seed: rt.bklMC(X, beta, 10 ** 9, step=10 ** 9,
                                       seed=seed, hook=stop, **kw),
        "wtmMC": lambda seed: rt.wtmMC(X, beta, 1, step=1e9, seed=seed,
                                       hook=stop, **kw),
        "rrrMC": lambda seed: rt.rrrMC(X, beta, MOVES, step=MOVES,
                                       seed=seed, **kw)}


def profile(call, chains: int, card: str) -> dict:
    """Time and profile call(seed) as set out in the module docstring."""
    call(1)                                    # warm-up
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    call(2)
    t1.record()
    torch.cuda.synchronize()
    wall_ms = t0.elapsed_time(t1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call(3)
        torch.cuda.synchronize()
    dev = profiling.device_summary(prof)
    kernels, device_us = dev["kernels"], dev["device_us"]
    launches = dev["launch_calls"]
    runtime = collections.Counter()
    aten = collections.Counter()
    aten_us = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("cuda", "cu")):
            runtime[e.name] += 1
        elif e.name.startswith("aten::"):
            aten[e.name] += 1
            aten_us[e.name] += e.self_cpu_time_total
    copies = sum(c for n, c in runtime.items() if n.startswith("cudaMemcpy"))
    syncs = {n: runtime[n] / MOVES for n in profiling.SYNC_CALLS
             if runtime[n]}
    top = [{"op": n, "per_move": aten[n] / MOVES,
            "host_us_per_move": aten_us[n] / MOVES}
           for n, _ in aten_us.most_common(8)]
    return {"moves": MOVES, "chains": chains, "card": card,
            "wall_ms": wall_ms, "wall_us_per_move": 1e3 * wall_ms / MOVES,
            "kernels_per_move": kernels / MOVES,
            "launch_calls_per_move": launches / MOVES,
            "aten_ops_per_move": sum(aten.values()) / MOVES,
            "syncs_per_move": syncs,
            "memcpy_calls_per_move": copies / MOVES,
            "device_us_per_move": device_us / MOVES,
            "device_busy_share": device_us / (1e3 * wall_ms),
            "wall_us_per_launch": (1e3 * wall_ms / launches
                                   if launches else None),
            "top_aten_by_host_time": top}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_generic_profile: no CUDA device is visible")
    card = card_line()
    print(card, flush=True)
    out = {}
    for name, build in CASES.items():
        X, chains, beta = build()
        C0 = rt.init_state(X, chains, 167).sigma
        for sampler, call in calls(X, C0, beta).items():
            rec = profile(call, chains, card)
            out[f"{name} {sampler}"] = rec
            print(json.dumps({"case": name, "N": X.N, "sampler": sampler,
                              **rec}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
