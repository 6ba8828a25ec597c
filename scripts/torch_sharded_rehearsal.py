#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s phases s (the sharded service), r (its
read side and fault tolerance), q (compressed pushes, leases and a
checkpoint), t (the chaos trace replay and its no-fault parity replay)
and d (the MLP jobs, a compressed one included) on the CPU.

Runs ``chip_smoke.sharded_phase``, ``chip_smoke.read_phase`` on its
runtime, ``chip_smoke.compressed_phase`` on a fresh fleet,
``chip_smoke.replay_phase`` and ``chip_smoke.mlp_phase``, on
``device="cpu"`` at a small scale of the paper inventories, so their
control flow, their oracles (fused fleet tick against the per-shard
appliers, every transition against the gather oracle, the faulted arena
against the fault-free per-shard replay, diff pulls against full pulls,
the restored arena against the clone taken at the save, engine.step
against ServiceRuntime.step, the replay's chaos invariants and its
fleet against the flat twin) and the scaler's decisions can be checked
without a card.  The kernel
wrappers count only CUDA launches, so each is wrapped here in a stand-in
that counts its calls; the card-only memory calls read 0 and CUDA-event
timings are host timings.  Times printed by a rehearsal are CPU times,
not the card's.

    PYTHONPATH=src python3 scripts/torch_sharded_rehearsal.py [--scale 0.001]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels.agg_adam import ops as agg_ops  # noqa: E402
from repro_torch.kernels.ef_round import ops as ef_ops  # noqa: E402
from repro_torch.kernels.relayout import ops as rl_ops  # noqa: E402


def counting(module, name):
    """Replace ``module.name`` by a stand-in that counts its calls in
    ``.launches`` of whatever the module's ``name`` is at the call, as the
    wrapper counts its launches on the card."""
    real = getattr(module, name)

    def stand_in(*args, **kwargs):
        getattr(module, name).launches += 1
        return real(*args, **kwargs)

    stand_in.launches = 0
    setattr(module, name, stand_in)
    return stand_in


def host_ms(fn, device, reps=10, warmup=3, inner=5) -> float:
    """``chip_smoke.time_ms`` on the host clock (no CUDA events here)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps * inner):
        fn()
    return (time.perf_counter() - t0) * 1e3 / (reps * inner)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.001,
                    help="fraction of every workload tensor")
    args = ap.parse_args()
    wrappers = {
        "agg_adam_multijob_fused": counting(
            agg_ops, "aggregate_adam_multijob_fused"),
        "relayout_stage": counting(rl_ops, "relayout_stage"),
        "relayout_scatter": counting(rl_ops, "relayout_scatter"),
        "agg_adam_blocks": counting(agg_ops, "aggregate_adam_blocks"),
        "ef_round": counting(ef_ops, "ef_round"),
    }
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_stats = lambda *a, **k: {}
    chip_smoke.sync = lambda device: None
    chip_smoke.time_ms = host_ms
    counts, s = chip_smoke.sharded_phase(torch.device("cpu"), wrappers,
                                         args.scale, flat_tick_ms=[0.0])
    print(f"rehearsal at scale {args.scale}: phase s calls {counts}")
    counts = chip_smoke.read_phase(s, wrappers)
    print(f"rehearsal at scale {args.scale}: phase r calls {counts}")
    s_tick_ms = s.fleet_tick_ms
    del s
    counts, s, _ = chip_smoke.compressed_phase(torch.device("cpu"),
                                               wrappers, args.scale, s_tick_ms)
    print(f"rehearsal at scale {args.scale}: phase q calls {counts}")
    del s
    counts = chip_smoke.replay_phase(torch.device("cpu"), wrappers,
                                     args.scale)
    print(f"rehearsal at scale {args.scale}: phase t calls {counts}")
    counts = chip_smoke.mlp_phase(torch.device("cpu"), wrappers)
    print(f"rehearsal: phase d calls {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
