"""Cells of the shared service (configuration kind ``service_fleet``).

Set-up builds the deployment the configuration names: a
``ParameterService`` and a ``ShardedServiceRuntime`` with its fleet-tick
engine, and registers every job with parameters drawn on the device from
the seed.  Each job then gets a ring of seeded gradients, packed once in
the job's packed layout (zero on padding), which its pushes cycle
through.

The traffic's ``loop`` names the window's loop:

- ``closed_push``: every job submits one packed push, then one engine
  tick applies them, ended by a synchronize; the next round starts when
  the tick is done (a closed loop at the service's capacity).

After the window the program's answer (each job's parameters, moments and
residuals on a sample of lanes, and its step count) is read, the program
is freed, and the reference works the same lanes out again.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from . import inputs, trace
from .reference import service as ref
from .reference.adam import INT8_BLOCK


def chunked(tensors, chunk_bytes: int):
    """A job's tensors split into aggregation tasks of at most
    ``chunk_bytes`` (float32), as the paper's kvstore splits big arrays:
    [(key, elements)]."""
    out = []
    for name, params in tensors:
        nbytes = params * 4
        n = max(1, -(-nbytes // chunk_bytes))
        per = nbytes // n
        for c in range(n):
            b = per if c < n - 1 else nbytes - per * (n - 1)
            key = f"{name}[{c}]" if n > 1 else name
            out.append((key, b // 4))
    return out


def _no_loss(params, batch):
    raise NotImplementedError("the service cells push seeded gradients")


class _Job:
    def __init__(self, spec, kind, chunk_bytes):
        self.id = spec["id"]
        self.lr = float(spec["lr"])
        self.kind = kind
        self.tasks = chunked(spec["tensors"], chunk_bytes)
        self.offsets = {}
        off = 0
        for key, n in self.tasks:
            self.offsets[key] = off
            off += n
        self.n_payload = off
        self.count = 0  # pushes submitted
        self.ring: List[torch.Tensor] = []


class Fleet:
    """The service, its jobs and their gradient rings."""

    def __init__(self, cell, seed: int, device: torch.device,
                 spans: trace.Spans, sync):
        from repro_torch.core import ParameterService
        from repro_torch.ps.service_runtime import ShardedServiceRuntime

        cfg, tr = cell.config, cell.traffic
        svc = cfg["service"]
        self.device, self.sync, self.seed = device, sync, seed
        self.cfg, self.traffic = cfg, tr
        self.service = ParameterService(
            total_budget=svc["total_budget"], n_clusters=svc["n_clusters"],
            plan_pad_to=svc["plan_pad_to"])
        self.rt = ShardedServiceRuntime(self.service, device=device)
        self.eng = self.rt.attach_engine(fleet_tick=svc["fleet_tick"],
                                         max_staleness=svc["max_staleness"])
        kinds = tr.get("push_compression", {})
        self.jobs = [_Job(spec, kinds.get(spec["id"]), cfg["chunk_bytes"])
                     for spec in cfg["jobs"]]
        adam = cfg["adam"]
        for job in self.jobs:
            payload = inputs.normal(job.n_payload, cfg["init_scale"], seed,
                                    "init", job.id, device=device)
            params = {key: payload[job.offsets[key]:job.offsets[key] + n]
                      for key, n in job.tasks}
            extra = {"push_compression": job.kind} if job.kind else {}
            with spans.span("register", sync):
                self.rt.add_job(
                    job.id, params, _no_loss,
                    iteration_duration=svc["iteration_duration"],
                    n_workers=svc["n_workers"],
                    required_servers=svc["required_servers"],
                    agg_throughput=svc["agg_throughput"],
                    lr=job.lr, b1=adam["b1"], b2=adam["b2"],
                    eps=adam["eps"], **extra)
            del params, payload
        t_ring = time.perf_counter()
        plan = self.rt.splan
        self.pieces = 0
        self.owned_lanes = self.owned_blocks = 0
        for job in self.jobs:
            layout = plan.job_layout(job.id)
            self.pieces += layout.n_shards
            for l in layout.layouts:
                self.owned_blocks += int(l.blocks.size)
                self.owned_lanes += int(l.blocks.size) * l.block
            for r in range(tr["ring"]):
                g = inputs.normal(job.n_payload, tr["grad_scale"], seed,
                                  "grad", job.id, r, device=device)
                packed = torch.zeros(layout.packed_len, dtype=torch.float32,
                                     device=device)
                for key, start, size, _, _ in layout.slots:
                    off = job.offsets[key]
                    packed[start:start + size] = g[off:off + size]
                job.ring.append(packed)
                del g
        sync()
        spans.seconds["ring"].append(time.perf_counter() - t_ring)

    def round(self, marks: bool = False):
        """One closed-loop round: every job pushes, one tick applies the
        pushes, a synchronize ends it.  Returns ([(submit time, future,
        job)], seconds in ``tick()`` before the synchronize, end
        time)."""
        subs = []
        with trace.mark("submit", marks):
            for job in self.jobs:
                ts = time.perf_counter()
                fut = self.eng.submit_packed(
                    job.id, job.ring[job.count % len(job.ring)])
                job.count += 1
                subs.append((ts, fut, job))
        with trace.mark("tick", marks):
            th = time.perf_counter()
            applied = self.eng.tick()
            host = time.perf_counter() - th
        with trace.mark("sync", marks):
            self.sync()
        te = time.perf_counter()
        if applied != self.pieces:
            raise RuntimeError(f"a tick applied {applied} of the "
                               f"{self.pieces} pushed pieces")
        return subs, host, te

    def read(self, n_blocks: int):
        """The program's answer on the sampled lanes, as plain tensors,
        and the maps of its packing, for the reference."""
        splan = self.rt.splan
        offs = dict(zip(splan.shard_ids, splan.concat_view()[0]))
        arena = self.rt.arena
        dev = self.device
        jobs, maps, counts, pull_gap = [], [], {}, 0.0
        for job in self.jobs:
            layout = splan.job_layout(job.id)
            payload = torch.full((layout.packed_len,), -1, dtype=torch.int64,
                                 device=dev)
            for key, start, size, _, _ in layout.slots:
                o = job.offsets[key]
                payload[start:start + size] = torch.arange(
                    o, o + size, device=dev)
            lanes = []
            for sid, l in zip(layout.shard_ids, layout.layouts):
                b = torch.from_numpy(l.blocks.astype(np.int64)).to(dev)
                lanes.append((offs[sid] + b[:, None] * l.block
                              + torch.arange(l.block, device=dev)).reshape(-1))
            arena_map = torch.cat(lanes)
            maps.append({"payload": payload, "arena": arena_map,
                         "n_payload": job.n_payload})
            picks = ref.sample_blocks([l.packed_len for l in layout.layouts],
                                      n_blocks, self.seed, job.id)
            ar = torch.arange(INT8_BLOCK, device=dev)
            lane = torch.stack([layout.piece_offsets[i] + first + ar
                                for i, first in picks])
            valid = torch.stack([first + ar < layout.layouts[i].packed_len
                                 for i, first in picks])
            lane = torch.where(valid, lane, 0)
            pidx = torch.where(valid, payload[lane], -1)
            alane = arena_map[lane]
            leaves = ("flat", "mu", "nu") + (("ef",) if job.kind else ())
            prog = {k: torch.where(valid, arena[k][alane], 0.0)
                    for k in leaves}
            pulled = self.eng.pull(job.id)
            flat_pull = torch.cat([pulled[key].reshape(-1)
                                   for key, _ in job.tasks])
            hit = pidx >= 0
            pull_gap = max(pull_gap, float(
                (flat_pull[pidx[hit]] - prog["flat"][hit]).abs().max()))
            del pulled, flat_pull
            counts[job.id] = (int(self.rt.counts[job.id]), job.count)
            jobs.append({"id": job.id, "lr": job.lr, "kind": job.kind,
                         "n_payload": job.n_payload, "payload_idx": pidx,
                         "valid": valid, "prog": prog})
        return jobs, maps, int(arena["flat"].numel()), counts, pull_gap


def run(cell, seed: int, seconds: float, traced: bool, device, rec, sync,
        control: bool = False) -> Dict[str, float]:
    """Set up, warm up, measure for ``seconds``, profile a stretch when
    ``traced``, then check.  Fills ``rec`` and returns the readings of
    the compared numbers; with ``control`` also the control's reading
    of ``state_gap`` (``control.state_gap``), which runs do not make."""
    tr = cell.traffic
    if tr["loop"] != "closed_push":
        raise ValueError(f"unknown loop {tr['loop']!r} for a service cell")
    t_fleet = time.perf_counter()
    fleet = Fleet(cell, seed, device, rec.spans, sync)
    t_warm = time.perf_counter()
    for _ in range(tr["warmup_rounds"]):
        fleet.round()
    sync()
    rec.owned_lanes, rec.owned_blocks = fleet.owned_lanes, fleet.owned_blocks
    t0 = time.perf_counter()
    rec.setup_s = t0 - rec.t_start
    rec.detail["setup"] = {
        "to_fleet": t_fleet - rec.t_start, "fleet": t_warm - t_fleet,
        "register": sum(rec.spans.seconds["register"]),
        "ring": sum(rec.spans.seconds["ring"]), "warmup": t0 - t_warm}
    payload_per_round = sum(j.n_payload for j in fleet.jobs)
    while True:
        subs, host, te = fleet.round()
        rec.tick_host_s.append(host)
        rec.attempted += len(subs)
        for ts, fut, job in subs:
            if fut.done():
                rec.latencies.append(te - ts)
            else:
                rec.failed += 1
        rec.applied_params += payload_per_round
        if te - t0 >= seconds:
            break
    rec.window_s = te - t0
    if traced:
        def body(_):
            with trace.mark("round"):
                fleet.round(marks=True)
        rec.profile = trace.profile(body, tr["profile_rounds"], sync, device)
        rec.profile_ticks = tr["profile_rounds"]
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    t_read = time.perf_counter()
    jobs, maps, arena_len, counts, pull_gap = fleet.read(tr["sample_blocks"])
    # A future holds the engine, and the engine the arena.
    del fleet, subs, fut, job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = check(cell, seed, jobs, maps, arena_len, counts, pull_gap,
                     device, rec, control)
    rec.detail["seconds"] = {"read": t_check - t_read,
                             "check": time.perf_counter() - t_check,
                             "rounds": len(rec.tick_host_s)}
    return readings


def check(cell, seed, jobs, maps, arena_len, counts, pull_gap, device,
          rec, control=False) -> Dict[str, float]:
    """The compared numbers: the packing's faults, the step counts' gap,
    the pull's gap from the state, the worst relative gap of any job's
    sampled Adam state from the reference's and, for compressed pushes,
    of its error-feedback residual (``rec.detail`` gets each job's
    gaps).  The control is the reference in bfloat16 put in the
    program's place."""
    cfg, tr = cell.config, cell.traffic
    readings = {"layout_faults": float(ref.layout_faults(maps, arena_len))}
    del maps
    readings["count_gap"] = float(max(abs(a - b) for a, b in counts.values()))
    readings["pull_gap"] = pull_gap
    worst = {"state_gap": 0.0, "ef_gap": 0.0}
    ctrl = dict(worst)
    compressed = any(job["kind"] for job in jobs)
    for job in jobs:
        kw = dict(seed=seed, init_scale=cfg["init_scale"],
                  grad_scale=tr["grad_scale"], ring=tr["ring"],
                  steps=counts[job["id"]][1], adam=cfg["adam"],
                  device=device)
        want = ref.replay(job, dtype=torch.float32, **kw)
        g = ref.gaps(job, want)
        rec.detail[job["id"]] = g
        _fold(worst, g)
        if control:
            c = ref.gaps(job, want, ref.replay(job, dtype=torch.bfloat16,
                                               **kw))
            rec.detail[job["id"] + ".control"] = c
            _fold(ctrl, c)
    if not compressed:
        del worst["ef_gap"], ctrl["ef_gap"]
    readings.update(worst)
    if control:
        readings.update({"control." + k: v for k, v in ctrl.items()})
    return readings


def _fold(worst, gaps):
    """The worst gap so far of the optimizer's state (flat, mu, nu) and,
    apart, of the error-feedback residual."""
    for leaf, gap in gaps.items():
        key = "ef_gap" if leaf == "ef" else "state_gap"
        worst[key] = max(worst[key], gap)
