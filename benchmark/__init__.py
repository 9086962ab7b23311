"""The benchmark of rrrmc_tpu_torch on one NVIDIA H100.

One command runs one cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the repository lists the cells and the
metrics; everything of one configuration, traffic mix, entry point, kernel
work count or per-layer metric sits in a file of its own under this folder,
found by the name that `BENCHMARK.json` gives it (see manifest.py).
"""
