"""The port's benchmark line: attempted spin flips per second on EA-3D.

    python -m rrrmc_tpu_torch.bench

Workload (the JAX package's `bench.py`): Edwards-Anderson 3D +-J lattice,
L=16 (N=4096), seed 42, beta=2, 8192 chains, checkerboard Metropolis through
`sweepMC` on the CUDA sweep kernel (csrc/sweep.cu, one launch of 1000 sweeps
per run). 10 warm-up sweeps, then the best of 3 runs of 1000 sweeps, each
timed with the host clock around a call that ends in
`torch.cuda.synchronize()`. Guard: the running int32 energy equals
energy(sigma) exactly. It needs a CUDA device and refuses to run without
one.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

#: attempted flips/s of the north-star baseline (BASELINE.json)
BASELINE = 1.0e9
L, D, SEED, BETA, CHAINS = 16, 3, 42, 2.0, 8192
WARMUP, SWEEPS, REPS = 10, 1000, 3


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def script_device(device: str, script: str) -> torch.device:
    """The device a script runs on: the card unless the caller passed
    --device cpu. Without CUDA and without that flag the script exits with
    a message and a non-zero code: it never runs quietly on the host."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{script}: no CUDA device is visible (pass "
                         f"--device cpu to run on the host)")
    return torch.device(device)


def measure():
    """Run the workload on the first CUDA device. Returns (record, extra,
    model, final MCState): record is the metric line; extra holds every
    timed run's seconds, the attempted flips of one timed run and the final
    E/N."""
    import rrrmc_tpu_torch as pt

    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    X = pt.GraphEA(L, D, (-1, 1), seed=SEED, device="cuda")
    _, st = pt.sweepMC(X, BETA, WARMUP, step=WARMUP, chains=CHAINS, seed=1)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        _, st = pt.sweepMC(X, BETA, SWEEPS, step=SWEEPS, state=st)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    if not torch.equal(X.energy(st.sigma), st.E):
        raise AssertionError("running energy differs from energy(sigma)")
    flips = st.sigma.shape[0] * X.N * SWEEPS
    best = flips / min(seconds)
    record = {"metric": "ea3d_attempted_flips_per_s", "value": best,
              "unit": "flips/s/chip", "vs_baseline": best / BASELINE}
    extra = {"seconds": seconds, "flips_per_run": flips,
             "E_per_spin": float(X.to_physical(st.E).double().mean()) / X.N}
    return record, extra, X, st


def main() -> None:
    record, _, _, _ = measure()
    print(card_line())
    print(json.dumps(record))


if __name__ == "__main__":
    main()
