"""Multi-pod dry-run (``repro.launch.dryrun``): run every (arch x shape)
cell once on the production meshes and extract the roofline terms.

The cells run on ``meta`` tensors over a fake process group of 256 (or
512) ranks, this process rank 0 (``launch.mesh.make_production_mesh``):
the only entry point of the port that runs on no device, as the
reference's runs on placeholder host devices.  DTensor computes every
rank-0 shard's shape and every collective its redistributions need, and
``launch.op_cost`` counts the local operators.  A process holds one
default process group, so this module runs one mesh size per process;
``--both-meshes`` runs the second mesh in a child process.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results]

Per cell, writes results/<mesh>/<arch>__<shape>.json with the reference's
fields: per-device bytes (arguments and outputs from the local shards;
``peak_estimate_bytes`` from the arguments plus the live local outputs of
allocating operators, ``launch.op_cost``; no compiler, so ``compile_s``,
``temp_bytes``, ``alias_bytes`` and ``xla_cost_analysis`` are null),
per-device flops, bytes and collective traffic, model flops, and three
roofline terms.  The terms are analytic, under the H100 SXM's published
rates below, and measure nothing.  A cell that fails (an operator with no
DTensor sharding rule, say) is recorded ``ok: false`` with the error and
the run goes on.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from . import op_cost
from .mesh import make_production_mesh

# H100 SXM roofline constants (NVIDIA's data sheet, dense, per card)
H100_BF16_FLOPS = 989e12  # flop/s
H100_HBM_BW = 3.35e12  # bytes/s
H100_NVLINK_BW = 450e9  # bytes/s per direction, a group within 8 GPUs
H100_NIC_BW = 50e9  # bytes/s, one 400 Gb/s NIC: a group beyond 8 GPUs
GPUS_PER_NODE = 8


def _local_bytes(tree) -> int:
    total = 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        total += t.numel() * t.element_size()
    return total


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _link_traffic(oc) -> dict:
    """Collective traffic by link: NVLink where the group's ranks share
    one 8-GPU node, the network otherwise."""
    out = {"nvlink": 0.0, "network": 0.0}
    nodes = {}
    for kind, nbytes, group in oc.coll_links:
        if group not in nodes:
            pg = dist.distributed_c10d._resolve_process_group(group)
            ranks = dist.get_process_group_ranks(pg)
            nodes[group] = (len({r // GPUS_PER_NODE for r in ranks}) == 1,
                            len(ranks))
        local, g = nodes[group]
        out["nvlink" if local else "network"] += op_cost.collective_traffic(
            kind, nbytes, g)
    return out


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: Path,
             mesh=None, overrides=None) -> dict:
    from .cells import build_cell

    out_path = out_dir / mesh_name / f"{arch}__{shape}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    n_chips = mesh.size()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": n_chips,
           "ok": False}
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh)
        for k, v in (overrides or {}).items():
            setattr(cell, k, v)
        placed_bytes = _local_bytes(cell.place())
        oc = op_cost.OpCost(base_bytes=placed_bytes)
        with oc:
            outs = cell.lower()
        t_lower = time.time() - t0
        cost = oc.cost
        links = _link_traffic(oc)

        flops_dev = float(cost.flops)
        bytes_dev = float(cost.bytes)
        coll_dev = float(cost.total_collective)
        t_compute = flops_dev / H100_BF16_FLOPS
        t_memory = bytes_dev / H100_HBM_BW
        t_coll = links["nvlink"] / H100_NVLINK_BW + \
            links["network"] / H100_NIC_BW
        bound = max(t_compute, t_memory, t_coll)
        dominant = max(("compute", t_compute), ("memory", t_memory),
                       ("collective", t_coll), key=lambda kv: kv[1])[0]
        model_flops = cell.model_flops_per_step
        flops_global = flops_dev * n_chips
        rec.update({
            "ok": True,
            "lower_s": round(t_lower, 2),
            "compile_s": None,
            "memory": {
                "argument_bytes": placed_bytes,
                "output_bytes": _local_bytes(outs),
                "temp_bytes": None,
                "alias_bytes": None,
                "peak_estimate_bytes": oc.live_peak_bytes,
            },
            "per_device_flops": flops_dev,
            "per_device_bytes": bytes_dev,
            "per_device_collective_bytes": coll_dev,
            "collectives": {
                "counts": cost.coll_counts,
                "raw_bytes": cost.coll_raw,
                "traffic_bytes": cost.coll_traffic,
                "traffic_by_link": links,
            },
            "xla_cost_analysis": None,
            "roofline": {
                "constants": "H100 SXM (analytic)",
                "t_compute_s": t_compute,
                "t_memory_s": t_memory,
                "t_collective_s": t_coll,
                "dominant": dominant,
                "bound_s": bound,
            },
            "model_flops_per_step": model_flops,
            "hlo_flops_global": flops_global,
            "useful_flops_ratio": (model_flops / flops_global
                                   if flops_global else 0.0),
            "roofline_fraction": (
                (model_flops / H100_BF16_FLOPS / n_chips) / bound
                if bound > 0 else 0.0),
            "top_ops": dict(sorted(cost.ops.items(),
                                   key=lambda kv: -kv[1])[:12]),
        })
    except Exception as e:  # noqa: BLE001 -- record the failure, go on
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["elapsed_s"] = round(time.time() - t0, 2)

    out_path.write_text(json.dumps(rec, indent=2))
    if rec["ok"]:
        print(f"[OK  ] {mesh_name} {arch:24s} {shape:14s} "
              f"run={rec['lower_s']:7.1f}s "
              f"dominant={rec['roofline']['dominant']:10s} "
              f"roofline={rec['roofline_fraction']:6.1%}", flush=True)
    else:
        print(f"[FAIL] {mesh_name} {arch} {shape}: "
              f"{rec['error'][:200]}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        from .cells import all_cells

        todo = list(all_cells())
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    child = None
    if args.both_meshes:  # one fake world per process: pod512 in a child
        argv2 = [a for a in (argv if argv is not None else sys.argv[1:])
                 if a != "--both-meshes"] + ["--multi-pod"]
        child = subprocess.Popen([sys.executable, "-m",
                                  "repro_torch.launch.dryrun", *argv2])
        multi_pod = False
    else:
        multi_pod = args.multi_pod
    mesh_name = "pod512" if multi_pod else "pod256"
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_fail = 0
    for arch, shape in todo:
        out_path = out_dir / mesh_name / f"{arch}__{shape}.json"
        if args.skip_existing and out_path.exists():
            if json.loads(out_path.read_text()).get("ok"):
                continue
        rec = run_cell(arch, shape, mesh_name, out_dir, mesh=mesh)
        n_fail += 0 if rec["ok"] else 1
    if child is not None:
        n_fail += 1 if child.wait() else 0
    dist.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
