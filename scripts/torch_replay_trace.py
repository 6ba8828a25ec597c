#!/usr/bin/env python
"""Chaos-soak trace replay of the PyTorch/CUDA port, on the card.

The counterpart of ``scripts/replay_trace.py``, with its flags and
``--device``.  It replays the synthetic Philly-like trace
(``repro_torch.sim.trace``) through the port's sharded data plane --
``ShardedServiceRuntime`` + ``ShardedTickEngine`` + ``ElasticScaler`` +
``FaultInjector`` -- twice:

1. chaos on: seeded apply/migration/kill/drop faults plus a dead trainer
   reclaimed by its lease; every window checks that the control plane
   and the data plane agree on the layout.
2. chaos off: the same replay against a flat ``ServiceRuntime`` twin,
   bit for bit at staleness 0.

Each job carries the reference's small synthetic tree
(``repro_torch.sim.replay.default_job_tree``); ``chip_smoke.py``'s phase
t runs the same replay at the paper models' full tensor inventories.
Exits non-zero if any invariant fails (registry/runtime divergence,
parity violation, lease reclaim slower than one interval, an aborted
replan left unretried, a read path that drove zero pulls).  Writes the
benchmark rows (the shape of ``benchmarks/run.py --json``) only when
``--json PATH`` is given.  Runs on the first CUDA card; ``--device cpu``
runs the plain PyTorch versions on the CPU.

Usage:
    python scripts/torch_replay_trace.py --smoke
    python scripts/torch_replay_trace.py --windows 24 --jobs 30 --seed 3 \
        --json build/torch_chaos.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the soak (8 windows, 10 jobs)")
    ap.add_argument("--windows", type=int, default=12,
                    help="replay windows (default 12)")
    ap.add_argument("--jobs", type=int, default=14,
                    help="trace jobs generated (default 14)")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace + fault-schedule seed (default 0)")
    ap.add_argument("--json", default="-", metavar="PATH",
                    help="write benchmark rows here (default '-': none)")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-window log")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.windows, args.jobs = min(args.windows, 8), min(args.jobs, 10)

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.sim.replay import (ReplayConfig, replan_overhead_micro,
                                        report_rows, run_replay)

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"chaos soak on {name}: {args.jobs} trace jobs, {args.windows} "
          f"windows, seed {args.seed}")
    chaos = run_replay(ReplayConfig(chaos=True, max_windows=args.windows,
                                    n_jobs=args.jobs, seed=args.seed),
                       device=device)
    parity = run_replay(ReplayConfig(chaos=False, parity_twin=True,
                                     max_windows=args.windows,
                                     n_jobs=args.jobs, seed=args.seed),
                        device=device)
    micro = replan_overhead_micro(n_cycles=2 if args.smoke else 3,
                                  device=device)
    if args.verbose:
        for w in chaos["windows"]:
            print("  " + " ".join(f"{k}={v}" for k, v in w.items()))

    rows = report_rows(chaos, parity, micro)
    for row_name, value, derived in rows:
        print(f'{row_name},{value},"{derived}"')

    failures = []
    if chaos["registry_divergence_windows"] != 0:
        failures.append(
            f"registry/runtime divergence in "
            f"{chaos['registry_divergence_windows']} window(s)")
    if parity["parity_violations"] != 0:
        failures.append(
            f"{parity['parity_violations']} no-fault parity violation(s) "
            f"vs the flat twin")
    if chaos["dead_window"] is not None:
        lat = chaos["reclaim_latency_windows"]
        if lat is None or lat > int(chaos["lease_interval"]) + 1:
            failures.append(
                f"dead trainer reclaim latency {lat} windows exceeds the "
                f"lease interval ({chaos['lease_interval']})")
    if chaos["n_replan_aborts"] != chaos["n_replan_retries"]:
        failures.append(
            f"{chaos['n_replan_aborts']} replan abort(s) but only "
            f"{chaos['n_replan_retries']} retried -- some replan died "
            f"without recovery")
    if chaos["n_reads"] == 0:
        failures.append(
            "read consumer drove zero versioned pulls -- the soak no "
            "longer prices the pull wire")

    if args.json != "-":
        payload = {"smoke": bool(args.smoke), "modules": ["chaos"],
                   "device": name,
                   "rows": [{"name": n, "value": v, "derived": d}
                            for n, v, d in rows]}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print(f'json/written,{len(rows)},"{args.json}"')

    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1
    print(f"OK: {chaos['n_faults_fired']} faults absorbed, "
          f"{chaos['n_replan_aborts']} replan(s) rolled back and retried, "
          f"dead trainer reclaimed in {chaos['reclaim_latency_windows']} "
          f"window(s), zero divergence, parity bit-exact")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
