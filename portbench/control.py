"""The control of a cell: its reference with one stated guarantee broken, in the program's place.

    python3 portbench/control.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]

Each seed runs the cell's window with the compress entry replaced by the
reference family's `control` (lzss_lcp: ties go to the NSV;
blockwise_huff: one table for all blocks), and prints one JSON line of
its check number: the upper reading of the limit (the lower one is the
benchmark's own runs). The benchmark's runs never run this.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    import argparse

    import torch

    from portbench.bench import Bench
    from portbench.harness import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control: needs a CUDA card")
    dev = torch.device("cuda", 0)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    ref = bench.module("reference", config["reference"])
    traffic = bench.traffic(cell["traffic"])
    entries = {op: bench.entry(config["entry"][op]) for op in traffic["ops"]}
    entries["compress"] = lambda alg, data, device: ref.control(alg, data, config, device)
    for seed in args.seed:
        r = run_cell(bench, cell, seed, args.seconds, False, dev, time.monotonic(), entries=entries)
        print(json.dumps({"seed": seed, "correct": r["correct"], "attempted": r["attempted"], "checks": r["checks"]}),
              flush=True)
