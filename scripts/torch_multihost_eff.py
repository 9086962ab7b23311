"""Weak-scaling efficiency over P torch.distributed ranks on the PyTorch
port (the JAX package's scripts/multihost_eff.py): P worker processes
(scripts/_torch_multihost_worker.py) each run a constant share of two
workloads through parallel/distributed.py:

  * chains: chain-sharded sweepMC, 64 chains a rank, no communication in
    the run;
  * pt: parallel tempering with the ladder sharded over the ranks (2
    rungs a rank), one all_gather a swap round: the worst case.

efficiency(P) = rate(P) / (P * rate(1)), aggregated attempted flips/s;
each P is run `repeats` times and its rates given as mean and std.

On the card (the default) the ranks join an NCCL group, one card a rank:
P runs up to the number of visible cards, and a larger P is refused with a
message (on one H100, P = 1 only). With --device cpu the ranks join a gloo
group on the host, each pinned to its own core, P in {1, 2, 4}: the JAX
script's own emulation of P hosts. The default sizes are the JAX
worker's, which the card runs in seconds; the host runs the kernels'
plain versions, where one P = 1 world at these sizes outlasts the 900 s
worker limit, so pass smaller sizes there (--sweeps, --pt-sweeps,
--pt-chains).

    python scripts/torch_multihost_eff.py [out.json] [--device cpu]
        [--P 1 2 4] [--repeats 3] [worker options ...]

The default output is chiprun_out/torch_multihost_eff.json, with the
card's name and power limit (nvidia-smi) in "device". It exits non-zero
without a card unless given --device cpu. Every worker has a time limit
and is killed past it. A script in scripts/ needs the repo on PYTHONPATH
(the workers get it).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from rrrmc_tpu_torch.bench import card_line, script_device

DEFAULT_OUT = "chiprun_out/torch_multihost_eff.json"
WORKER = Path(__file__).resolve().parent / "_torch_multihost_worker.py"
#: seconds a world of workers may take
WORKER_TIMEOUT_S = 900


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_p(nprocs: int, device: str, worker_args=(),
          timeout=WORKER_TIMEOUT_S) -> dict:
    """One world of `nprocs` workers; rank 0's record."""
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / f"p{nprocs}.json"
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(nprocs), str(port),
             str(out), "--device", device, *worker_args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(nprocs)]
        deadline = time.time() + timeout
        logs = []
        try:
            for p in procs:
                so, se = p.communicate(
                    timeout=max(1.0, deadline - time.time()))
                logs.append((p.returncode, se.decode()[-2000:]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rc != 0 for rc, _ in logs):
            raise RuntimeError(f"a worker failed (P={nprocs}): {logs}")
        return json.loads(out.read_text())


def efficiency(runs: dict) -> dict:
    """Rows (mean and std a P) and efficiencies from {P: [records]}."""
    def agg(rs, key):
        v = np.asarray([r[key] for r in rs], np.float64)
        return float(v.mean()), float(v.std())

    rows = {}
    for p, rs in runs.items():
        cm, cs = agg(rs, "chains_flips_per_s")
        pm, ps = agg(rs, "pt_flips_per_s")
        rec = {k: v for k, v in rs[0].items() if k != "chains_E"}
        rows[str(p)] = {**rec, "repeats": len(rs),
                        "chains_flips_per_s": cm,
                        "chains_flips_per_s_std": cs,
                        "pt_flips_per_s": pm, "pt_flips_per_s_std": ps}
    base = rows[str(min(runs))]
    eff = {}
    for p_str, r in rows.items():
        p = int(p_str)
        eff[p_str] = {
            "chains": r["chains_flips_per_s"]
            / (p * base["chains_flips_per_s"]),
            "chains_rel_spread": (r["chains_flips_per_s_std"]
                                  / r["chains_flips_per_s"]),
            "pt": r["pt_flips_per_s"] / (p * base["pt_flips_per_s"]),
            "pt_rel_spread": r["pt_flips_per_s_std"] / r["pt_flips_per_s"]}
    return {"rows": rows, "efficiency": eff}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--P", type=int, nargs="+")
    ap.add_argument("--repeats", type=int, default=3)
    args, worker_args = ap.parse_known_args(argv)
    device = script_device(args.device, "torch_multihost_eff")
    if device.type == "cuda":
        card = card_line()
        cards = torch.cuda.device_count()
        Ps = args.P or list(range(1, cards + 1))
        if max(Ps) > cards:
            raise SystemExit(f"torch_multihost_eff: P={max(Ps)} needs "
                             f"{max(Ps)} cards, {cards} visible (NCCL runs "
                             f"one rank a card)")
        method = (f"weak scaling over P NCCL ranks, one card a rank, P in "
                  f"{Ps}, constant work a rank")
    else:
        card = "cpu"
        Ps = args.P or [1, 2, 4]
        method = (f"weak scaling over P gloo ranks on the host, each pinned "
                  f"to its own core, P in {Ps}, constant work a rank (the "
                  f"JAX script's emulation of P hosts)")
    print(card, flush=True)
    runs = {p: [] for p in Ps}
    for rep in range(args.repeats):
        for p in Ps:
            r = run_p(p, device.type, worker_args)
            runs[p].append(r)
            print(json.dumps({"rep": rep, **{k: v for k, v in r.items()
                                             if k != "chains_E"}}),
                  flush=True)
    res = {"method": method + f"; every P repeats {args.repeats}x, rates "
                              f"are mean with std",
           "device": card, **efficiency(runs)}
    print(json.dumps(res["efficiency"]), flush=True)
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
