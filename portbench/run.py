#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program under ``src/``.  It sets up the cell from the seed, warms
up, measures for ``--seconds``, checks the window's outputs against the
plain reference, and prints one JSON object as the last line of standard
output (with ``--trace 1``: the per-layer metrics from a profiled window).
The numbers compared, each beside its limit, are the last lines of standard
error and the ``checks`` key of that object.  Without the card the cell asks
for, or with JAX or the JAX package loaded, it prints no result and exits
with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.bench import cell

    try:
        result, lines = cell.run(ROOT, args.workload, args.seed, args.seconds,
                                 bool(args.trace), t_start=T_START)
    except cell.NoChip as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    loaded = cell.forbidden_loaded()
    if loaded:
        print(f"portbench: modules loaded that no run may load: {loaded}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
