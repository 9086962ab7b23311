"""Run cells of the benchmark several times, each run a process of its own
as the check makes them, and keep every result line.

    python3 benchmark/tools/runs.py --cells A,B --seeds 11,12,13 \
        --seconds 10 --out FILE [--trace 0|1] [--sets 2] [--control]

For each cell, `--sets` sets of one run per seed (the same seeds in each
set); the runs of one cell follow each other. Each run's result line, its
exit code, its wall time and the end of its standard error go to --out
(JSON lines, appended). At the end it prints, for each cell and metric,
every set's median and its spread: the distance between the first and
the third quartile (statistics.quantiles, n=4) over the median. --control
runs benchmark/control.py instead of run.py, with the same arguments, and
--fault NAME benchmark/tools/faults.py with that fault planted.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    script = ["benchmark/control.py" if a.control else "benchmark/run.py"]
    if a.fault:
        script = ["benchmark/tools/faults.py", "--fault", a.fault]
    out = ROOT / a.out
    out.parent.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in a.seeds.split(",")]
    summary = {}
    for cell in a.cells.split(","):
        for k in range(a.sets):
            for seed in seeds:
                cmd = [sys.executable, *script, "--workload", cell, "--seed",
                       str(seed), "--seconds", str(a.seconds), "--trace",
                       str(a.trace)]
                t = time.perf_counter()
                r = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                   text=True)
                wall = time.perf_counter() - t
                lines = r.stdout.strip().splitlines()
                try:
                    res = json.loads(lines[-1])
                except (IndexError, json.JSONDecodeError):
                    res = None
                rec = {"cell": cell, "set": k, "seed": seed,
                       "control": a.control, "fault": a.fault,
                       "trace": a.trace, "rc": r.returncode, "wall_s": wall,
                       "result": res, "stderr": r.stderr[-3000:]}
                with open(out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                short = {}
                if res is not None:
                    short = {m: v["value"] for m, v in res["metrics"].items()}
                    for m, v in short.items():
                        summary.setdefault((cell, m, k), []).append(v)
                print(cell, k, seed, r.returncode, round(wall, 1),
                      None if res is None else res["correct"], short,
                      flush=True)
                if res is None:
                    print(r.stderr[-3000:], flush=True)
    for (cell, m, k), vs in sorted(summary.items()):
        if len(vs) >= 2:
            print(f"{cell} {m} set {k}: median {statistics.median(vs)} "
                  f"spread {spread(vs)} n {len(vs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
