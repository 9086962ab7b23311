"""Run a cell's control once: the configuration's reference samplers, with
the running energy in a lower precision than the configuration states
(references/<control>.py), in the program's place in the window; the rest
of the run, set-up and comparison included, as run.py makes it.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s>

Its `correct` has to come out false. The benchmark's own runs never run
it.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.run import parse  # noqa: E402


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.harness import report, run_cell

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t0=T0, control=True)
    return report(result)


if __name__ == "__main__":
    sys.exit(main())
