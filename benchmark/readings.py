"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 [--faults int8]

For each seed, in one process and on the card: a whole run as
``run.py`` makes it (``run.measure``: set-up, a window of one unit, the
program's state freed, the reference's comparison), one JSON line per seed
with every compared number.  ``--faults`` plants the cell kind's faults
(the control and the faults that ``PERF.md`` lists), so the same numbers
are read with the timed path broken.  Without a card it exits non-zero and
prints no reading: readings from another path would set no limit.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from benchlib.discover import Cell  # noqa: E402
from run import measure  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--faults", default="", help="comma-separated fault names of the cell's kind")
    p.add_argument("--seconds", type=float, default=0.0, help="the window (0: one unit)")
    args = p.parse_args(argv)
    import torch

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    faults = tuple(f for f in args.faults.split(",") if f)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = measure(cell, seed, args.seconds, False, torch.device("cuda:0"), faults)
        rec = {"seed": seed, "faults": list(faults), "correct": result["correct"],
               "numbers": {k: v["value"] for k, v in result["checks"].items()},
               "run_s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
