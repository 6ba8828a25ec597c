#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 psbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Builds the cell's deployment from the seed
(the port's CUDA kernels build into ``build/repro_torch_kernels/`` on a
checkout's first run and load from there after), warms up, measures for
``--seconds``, checks the answer against the plain reference, and prints
one JSON line: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics and a device breakdown (``--trace 1``).

Exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), without the port's package beside it, or
when the JAX package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    from psbench import harness

    try:
        cell = harness.find_cell(args.workload)
    except (KeyError, OSError) as exc:
        print(f"psbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"psbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"psbench: the port's package is not in {src}",
              file=sys.stderr)
        return 4
    sys.path.insert(0, str(src))
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"psbench: the run loaded {found}", file=sys.stderr)
        return 5
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
