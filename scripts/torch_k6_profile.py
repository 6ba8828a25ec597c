#!/usr/bin/env python3
"""The embedding bag's (K6) device time apart from its wrapper's, on
DLRM-RM2's lookup, and the scoring latency around it.

Builds DLRM-RM2 at its published widths (``dlrm_init``: 26 tables of
54,072,832 padded rows x 64 float32 and the MLPs; seed 16) and 4 id sets
of the train_batch cell's 65,536 x 26 ids (``recsys_batch``, as phase i
of ``chip_smoke.py`` draws them), then times on the card:

  field     one field: the largest table with the batch's strided ids
            ``ids[:, i:i+1]``, as the per-field lookup passed them;
  lookup    the whole 26-field lookup through
            ``models.recsys.sharded_embedding_lookup`` under
            ``torch.inference_mode()``, the path the model runs;
  batched   ``ops.embedding_bags(tables, ids)``, where the checkout has it;
  library   26 ``F.embedding_bag(mode="sum")`` calls and a ``torch.stack``
            (information: no single PyTorch call computes the lookup);

each four ways: the device time with a cold L2 (``chip_smoke.device_ms``:
a 256 MB fill before every call, the calls rotating over the 4 id sets,
every kernel the call launches summed under ``torch.profiler``, the
median call); the device time back to back on one id set (a warm L2);
the time of 5 calls back to back between CUDA events
(``chip_smoke.time_ms``, the number ``chip_smoke.py`` reported for K6
before the table-batched kernel); and the host's time per call (20 calls
before one synchronize).  Then the single-table call at
``chip_smoke.k6_single_cases``' six shapes, device time with a cold L2
and back to back; and ``dlrm_forward`` at the serve_p99 cell's batch of
512 under ``torch.inference_mode()``, host clock to a synchronize, the
median of 30.  Prints the card's name and power limit first and last.

  python3 scripts/torch_k6_profile.py [--src DIR]

``--src`` loads ``repro_torch`` from another checkout's ``src`` (default
this one's), so that two checkouts are timed by the same script in one
call.  Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
N_SETS = 4


def lookup_inputs(device, n_sets=N_SETS):
    """(config, params, id sets): DLRM-RM2's parameters on ``device``
    (seed 16; the 26 tables' values all differ) and ``n_sets`` (65,536,
    26) int32 id matrices."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys

    cfg = dlrm_rm2.config()
    gen = torch.Generator(device=device)
    gen.manual_seed(16)
    params = recsys.dlrm_init(cfg, gen, device)
    rng = np.random.default_rng(16)
    id_sets = [torch.from_numpy(recsys_batch(
        rng, dlrm_rm2.TRAIN_BATCH, cfg.n_dense, cfg.vocab_sizes)["sparse"]
                                ).to(device) for _ in range(n_sets)]
    return cfg, params, id_sets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k6_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.embed_bag import ops
    from repro_torch.models import recsys

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; repro_torch from {ops.__file__}", flush=True)
    device = torch.device("cuda:0")
    cfg, params, id_sets = lookup_inputs(device)
    tables = params["tables"]
    b = dlrm_rm2.TRAIN_BATCH
    big = int(np.argmax(cfg.vocab_sizes))
    n_fields, d = len(tables), cfg.embed_dim

    def library(ids):
        return torch.stack([torch.nn.functional.embedding_bag(
            ids[:, i:i + 1], t, mode="sum") for i, t in enumerate(tables)],
            dim=1)

    routes = {
        "field": (lambda ids: ops.embedding_bag(tables[big],
                                                ids[:, big:big + 1]), 1),
        "lookup": (lambda ids: recsys.sharded_embedding_lookup(tables, ids),
                   n_fields),
    }
    if hasattr(ops, "embedding_bags"):
        routes["batched"] = (lambda ids: ops.embedding_bags(tables, ids),
                             n_fields)
    routes["library"] = (library, n_fields)
    with torch.inference_mode():
        for name, (fn, fields) in routes.items():
            fns = [lambda ids=ids: fn(ids) for ids in id_sets]
            cold, by_name = cs.device_ms(fns, device)
            warm, _ = cs.device_ms(fns[:1], device, cold=False)
            wrapper = cs.time_ms(fns[0], device)
            cs.sync(device)
            t0 = time.perf_counter()
            for _ in range(20):
                fns[0]()
            host = (time.perf_counter() - t0) / 20 * 1e3
            cs.sync(device)
            ids = id_sets[0] if fields > 1 else id_sets[0][:, big:big + 1]
            bnd, _, every_row = cs.k6_bound(ids[:, :, None], d, 4)
            print(f"{name}: B={b} fields={fields} D={d} float32 L=1 "
                  f"device_ms_cold={cold:.4f} device_ms_warm={warm:.4f} "
                  f"wrapper_ms={wrapper:.4f} host_ms={host:.4f} "
                  f"bound_ms={bnd:.4f} (every row read anew: "
                  f"{every_row:.4f}) cold_of_bound={bnd / cold:.3f}",
                  flush=True)
            for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
                print(f"  kernel {ms:.4f} ms {kname[:100]}", flush=True)
        cases = cs.k6_single_cases(device, tables[big],
                                   id_sets[0][:, big:big + 1], True)
        for name, (t, idx) in cases.items():
            fn = lambda t=t, idx=idx: ops.embedding_bag(t, idx)  # noqa: E731
            cold, _ = cs.device_ms([fn], device)
            wrapper = cs.time_ms(fn, device)
            bnd, _, _ = cs.k6_bound(idx[:, None], t.shape[1],
                                    t.element_size())
            print(f"single table, {name}: L={idx.shape[1]} D={t.shape[1]} "
                  f"{str(t.dtype)[6:]} device_ms_cold={cold:.4f} "
                  f"wrapper_ms={wrapper:.4f} bound_ms={bnd:.4f} "
                  f"cold_of_bound={bnd / cold:.3f}", flush=True)
        del cases
        batch = {k: torch.from_numpy(v).to(device) for k, v in recsys_batch(
            np.random.default_rng(3), dlrm_rm2.SERVE_P99, cfg.n_dense,
            cfg.vocab_sizes).items()}
        times = []
        for _ in range(33):
            cs.sync(device)
            t0 = time.perf_counter()
            recsys.dlrm_forward(cfg, params, batch["dense"], batch["sparse"])
            cs.sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"scoring, dlrm_forward at {dlrm_rm2.SERVE_P99}: ms_median="
              f"{statistics.median(times[3:]):.4f} (of 30 after 3 warm-up; "
              f"min {min(times[3:]):.4f})", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
