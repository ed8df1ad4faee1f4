"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA cards as
the cell asks for (harness.py says what a run does). The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device, with ``--trace 1`` breakdown, and last ``compared``, each number
of the check beside its limit. Without the cards, or when JAX or the
JAX package was loaded, the run exits with another code than 0 and
prints no result.

This module loads neither torch nor the port: the workers that generate
the buildings start from it (``spawn``) while the run loads them.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import spec
from perfbench.traffic.pool import PendingPool


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative integer")
    cell = spec.load_cell(args.workload)
    pool = PendingPool(args.seed, cell.traffic["buildings"],
                       cell.config["model"]["classes"])
    try:
        from perfbench import harness
        result = harness.run_cell(args, pool=pool)
    finally:
        pool.get()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
