"""Run one cell of the benchmark once on this machine's card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints the cell's metrics as the last line of standard output (one JSON
object) and the numbers its check compared, each beside its limit, as the
last lines of standard error. Exits 2 without a result where the card is
missing, 3 where the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        p.error("--seed takes a whole number >= 0, --seconds a positive number")
    return args


if __name__ == "__main__":
    args = parse()
    from portbench import harness
    code = harness.main(args, T0)
    sys.stdout.flush()
    sys.stderr.flush()
    # the profiler's events make an interpreter's teardown take tens of
    # seconds; nothing is left to close
    os._exit(code)
