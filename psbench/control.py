#!/usr/bin/env python3
"""The readings a cell's limits are set from, and the stand-ins'
verdicts, on the card.

    python3 psbench/control.py --workload <cell> --seeds 1 2 3 \\
        --seconds <s> [--out FILE]

runs the cell once per seed in one process (the first run builds the
kernels), each as ``run.py`` would, and prints per seed the compared
numbers of the program (the lower readings) and of the control: the
plain reference one precision below the configuration's (bfloat16 for
the service's float32 state, float8 products for a bfloat16 model) put
in the program's place on the same inputs (the upper reading); for a
training cell also the readings of faults planted in the reference
(``fault_*``).  Each stand-in is judged by the harness's own comparison,
its readings in the place of the program's (``verdicts``: every one has
to read ``correct`` false).  Benchmark runs never compute these.
``--out`` also writes the lines as JSON.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from psbench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.find_cell(args.workload)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), t_start=t0,
                               control=True)
        line = {"seed": seed, "correct": res["correct"],
                "verdicts": {k: v["correct"]
                             for k, v in res["_variants"].items()},
                "readings": res["_readings"], "detail": res["_detail"],
                "metrics": {k: v["value"] for k, v in
                            res["metrics"].items()},
                "device": res["device"],
                "breakdown": res.get("breakdown"),
                "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.reset_peak_memory_stats()
    if args.out:
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
