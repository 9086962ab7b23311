"""Run a cell once with a fault planted in its timed path (benchmark/
faults.py), on the card, and print the result line: the readings of the
numbers compared under that fault.

    python3 benchmark/tools/faults.py --fault half_work --workload <cell> \
        --seed <n> --seconds <s>
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.faults import FAULTS  # noqa: E402
from benchmark.harness import report, run_cell  # noqa: E402
from benchmark.run import parse  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    fault = argv[i + 1]
    del argv[i:i + 2]
    a = parse(argv)
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   block_hook=FAULTS[fault])
    return report(res)


if __name__ == "__main__":
    sys.exit(main())
