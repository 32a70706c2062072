#!/usr/bin/env python3
"""The control of the benchmark's ``correct``, on the card, at a cell's size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--searches 8]

For each seed and each of a run's two graphs (the timed graph of the
configuration's seed, and the checked graph drawn from the run's seed): the
cell's inputs, the reference with one of the configuration's guarantees
broken put in the program's place (:mod:`portbench.bench.control`), and the
comparison the benchmark's runs use.  Prints one JSON line a seed and graph
with the compared numbers; every line has to read ``"correct": false``.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--searches", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    from portbench.bench.control import run_control
    from portbench.bench.spec import Benchmark

    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 3
    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    doc = bench.config(cell.config)
    weights = bench.weights(doc.get("weights"))
    for seed in (int(s) for s in args.seeds.split(",")):
        for graph in ("timed", "checked"):
            t0 = time.perf_counter()
            res = run_control(doc, weights, seed, "cuda", args.searches, checked=graph == "checked")
            print(json.dumps({"workload": cell.name, "seed": seed, "graph": graph, **res,
                              "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
