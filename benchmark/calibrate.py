"""The readings a cell's limits are set from (``PERF.md``): for each seed,
the program's numbers against the reference and the control's (the
reference computed one precision below the configuration's, put in the
program's place), and for training cells the fault "half of the batch
left out".  One process, one JSON line a seed:

    python -m benchmark.calibrate --workload tpu_default.train \\
        --seeds 11,12,13 [--control fp8|tf32] [--faults]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=("fp8", "tf32"), default=None)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control and faults on the first N seeds "
                         "only (default: all)")
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch

    cell = harness.Cell.load(args.workload)
    driver = harness.load_module("drivers", cell.driver)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        extra = args.control_seeds is None or i < args.control_seeds
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
            run = harness.Run(cell, seed, 0.0, False, "cuda", tmp)
            state = driver.setup(run)
            out = driver.calibrate(run, state, args.control if extra
                                   else None, args.faults and extra)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0,
                          "allocated_after": torch.cuda.memory_allocated()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
