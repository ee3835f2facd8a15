"""Readings that set a cell's limits: the compared numbers of the program and
of the control, seed by seed, in one process.

    python3 portbench/readings.py --workload <cell> --seeds <n> [<n> ...] \
        --seconds <s> [--control]

For each seed the program runs as in a benchmark run (set-up, a window of
``--seconds``, the comparison) and prints its numbers. With ``--control``
the driver's ``controls`` print theirs too: the float32 reference rounded
through float8 e4m3 (``fp8=True``), the nearest precision below the
configuration's bfloat16, in the program's place on the same inputs, and
for training the faults a training step can have, planted in the reference
put in the program's place. Not part of a benchmark run; its output is what
``PERF.md`` gives for each limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import ROOT, cell_files, load_driver, set_cache_dirs


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args()
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    _, _, conf, mix = cell_files(args.workload)
    driver = load_driver(mix["kind"])
    for seed in args.seeds:
        t0 = time.time()
        cell = driver.Cell(conf, mix, seed, "cuda")
        window = cell.window(args.seconds, False)
        cell.release()
        row = {"seed": seed, "side": "program", "requests": window["requests"],
               "numbers": driver.judge(cell, window["outs"])}
        print(json.dumps(row), flush=True)
        if args.control:
            for side, numbers in driver.controls(cell, window["outs"]).items():
                print(json.dumps({"seed": seed, "side": side, "numbers": numbers}), flush=True)
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
