#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

The main path is the write path of the shared aggregation service, at
the paper workloads' full tensor inventories:

  a. AlexNet, VGG19 and BERT-base resident in one ServiceRuntime; 8 ticks
     of seeded packed-gradient pushes through the ServiceTickEngine (one
     launch of the multi-job Adam kernel per tick);
  b. AWD-LM arrives: a delta replan moves the touched blocks through the
     relayout kernels; 8 ticks with four jobs;
  c. AWD-LM leaves: another delta replan; 8 ticks;
  d. two small real models (the MLP jobs of examples/multi_job_service.py)
     train through ``engine.step`` and through ``ServiceRuntime.step``
     with the block kernel.

Every kernel is built from the sources in the checkout, run at the main
path's shapes and held against its plain PyTorch version; every replan
against the full-gather oracle; the last tick of each of phases a-c
against the plain multi-job update; one block step of phase d against
the plain masked step.  Launch counters are set to 0 before each phase and read after
it.  Any failed check raises.

Output: per-phase lines, one JSON line of kernels (time, bound, plain
and library times, launches on the main path), the card's name and power
limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.  Without CUDA,
or outside a checkout of the repository, it exits non-zero and prints no
result.  ``--scale 0.001`` rehearses the phases on the card on smaller
tensors; a rehearsal prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
ADAM_FLOPS_PER_LANE = 14  # mu 3, nu 4, bias corrections 2, update 5
ULP_BUDGET = 1  # plain vs kernel: same operation order, correctly rounded


def _import_port():
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: run from a checkout of the repository "
                         f"(repro_torch not importable: {exc})")


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest float32 ulp distance (on the tensors' device)."""
    a = a.contiguous().view(torch.int32).long()
    b = b.contiguous().view(torch.int32).long()
    a = torch.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int((a - b).abs().max()) if a.numel() else 0


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def sync(device):
    torch.cuda.synchronize(device)


def time_ms(fn, device, reps=20, warmup=3) -> float:
    """Median of ``reps`` single-launch times from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def state_clone(state):
    return {k: state[k].clone() for k in ("flat", "mu", "nu")}


def check_equal(what, got, want):
    for k in ("flat", "mu", "nu"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs from the oracle "
                                 f"(max abs {max_abs(got[k], want[k])})")


# --------------------------------------------------------------- workloads
def chunked_inventory(model: str, scale: float):
    """The paper workload's tensors split at DEFAULT_CHUNK_BYTES as
    ``make_job`` splits them: [(leaf key, elements)]."""
    from repro_torch.configs import paper_workloads as pw

    out = []
    for name, params in pw.MODEL_TENSORS[model]:
        nbytes = params * pw.BYTES_PER_PARAM
        n = max(1, -(-nbytes // pw.DEFAULT_CHUNK_BYTES))
        per = nbytes // n
        for c in range(n):
            b = per if c < n - 1 else nbytes - per * (n - 1)
            key = f"{name}[{c}]" if n > 1 else name
            out.append((key, max(1, int(b // 4 * scale))))
    return out


def _no_model_loss(params, batch):
    raise NotImplementedError("the paper workloads carry tensor inventories "
                              "only; their pushes are seeded gradients")


class Service:
    """The full-size shared service and what the phases need of it."""

    LR = {"alexnet": 1e-3, "vgg19": 5e-4, "bert": 1e-4, "awd-lm": 3e-3}

    def __init__(self, device, scale):
        from repro_torch.core import ParameterService
        from repro_torch.ps.service_runtime import ServiceRuntime

        self.device, self.scale = device, scale
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(0)
        self.svc = ParameterService(total_budget=16, n_clusters=1,
                                    plan_pad_to=128)
        self.rt = ServiceRuntime(self.svc, device=device)
        self.eng = self.rt.attach_engine(max_staleness=1)
        self._masks, self._mask_key = {}, {}

    def params(self, model):
        return {k: torch.randn(n, generator=self.gen, device=self.device)
                * 0.02 for k, n in chunked_inventory(model, self.scale)}

    def add(self, model):
        self.rt.add_job(model, self.params(model), _no_model_loss,
                        required_servers=2, lr=self.LR[model])

    def payload_mask(self, job):
        """The job's packed payload lanes (zero gradient on padding keeps
        every non-payload lane of the state zero, as packing does)."""
        layout = self.rt.plan.job_layout(job)
        key = (id(self.rt.plan), job)
        if self._mask_key.get(job) != key:
            mask = torch.zeros(layout.packed_len, dtype=torch.bool)
            for _, start, size, _, _ in layout.slots:
                mask[start:start + size] = True
            self._masks[job] = mask.to(self.device)
            self._mask_key[job] = key
        return self._masks[job]

    def grad(self, job):
        """A seeded packed gradient for ``job`` (zero on padding)."""
        mask = self.payload_mask(job)
        return torch.randn(mask.numel(), generator=self.gen,
                           device=self.device) * 1e-3 * mask

    def push_all(self):
        """One seeded packed gradient per resident job; returns them."""
        gs = {j: self.grad(j) for j in self.rt.job_ids}
        for j, g in gs.items():
            self.eng.submit_packed(j, g)
        return gs

    def tick_tables(self, jobs, counts):
        """K1's hp table, block table and job-slot map for one tick over
        ``jobs`` at 1-based step ``counts``, as the engine builds them."""
        from repro_torch.kernels.agg_adam import ops as agg_ops
        from repro_torch.ps.engine import _flat_job_hp, _fused_tables

        plan = self.rt.plan
        block_idx, sizes, (lr, b1, b2, eps) = _fused_tables(
            [plan.job_layout(j) for j in jobs],
            [self.rt._jobs[j] for j in jobs], _flat_job_hp)
        hp = agg_ops.multi_job_hp(counts, lr=lr, b1=b1, b2=b2, eps=eps)
        slot = np.repeat(np.arange(len(jobs), dtype=np.int32), sizes)
        return (hp.to(self.device), torch.from_numpy(block_idx).to(self.device),
                torch.from_numpy(slot).to(self.device))


def reset_counters(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counters(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def run_ticks(s: Service, n: int, check_tick: bool):
    """``n`` ticks, each timed on the host clock to a synchronize; with
    ``check_tick`` the last one is also held against the plain update."""
    from repro_torch.kernels.agg_adam import ref as agg_ref

    times = []
    for i in range(n):
        gs = s.push_all()
        before = None
        if check_tick and i == n - 1:
            jobs = s.rt.job_ids
            before = state_clone(s.rt.state)
            tables = s.tick_tables(
                jobs, [s.rt.state["counts"][j] + 1 for j in jobs])
        sync(s.device)
        t0 = time.perf_counter()
        if s.eng.tick() != len(gs):
            raise AssertionError("a tick did not apply every pending job")
        sync(s.device)
        times.append((time.perf_counter() - t0) * 1e3)
        if before is not None:
            agg_ref.aggregate_adam_multijob_fused_plain(
                before["flat"], torch.cat([gs[j] for j in jobs]),
                before["mu"], before["nu"], *tables,
                block=s.rt.plan.block_align)
            for k in ("flat", "mu", "nu"):
                u = ulp_diff(s.rt.state[k], before[k])
                if u > ULP_BUDGET:
                    raise AssertionError(f"tick vs plain update: {k} {u} ulp")
            del before
    return times


def replan(s: Service, what: str, fn):
    """Drain, keep the state, run the replan ``fn``, and hold the migrated
    state against the full-gather oracle on the kept input."""
    from repro_torch.kernels.relayout import ops as rl_ops
    from repro_torch.ps import elastic

    s.eng.drain()
    old = s.rt.plan
    before = {**state_clone(s.rt.state), "counts": dict(s.rt.state["counts"])}
    sync(s.device)
    t0 = time.perf_counter()
    fn()
    sync(s.device)
    replan_ms = (time.perf_counter() - t0) * 1e3
    new = s.rt.plan
    # The replan's host parts, timed again one by one on the same input.
    elastic.clear_plan_cache()
    t0 = time.perf_counter()
    delta = elastic.compile_migration_delta(old, new)
    t1 = time.perf_counter()
    fresh = dataclasses.replace(new)  # same plan, empty layout caches
    for j in fresh.job_ids:
        fresh.job_layout(j)
    t2 = time.perf_counter()
    rl_ops.stage_tables(delta, s.device)
    sync(s.device)
    t3 = time.perf_counter()
    del fresh
    timings = (f" replan_ms={replan_ms:.1f} delta_compile_s={t1 - t0:.3f} "
               f"job_layouts_s={t2 - t1:.3f} stage_tables_upload_s="
               f"{t3 - t2:.3f}")
    oracle = elastic.migrate_flat_state(before, old, new)
    got = state_clone(s.rt.state)
    for j in set(new.job_ids) - set(old.job_ids):  # arrival: seeded lanes
        rows = torch.from_numpy(new.job_layout(j).blocks.astype(np.int64)
                                ).to(s.device)
        for k in ("flat", "mu", "nu"):
            got[k].view(-1, new.block_align)[rows] = 0.0
    check_equal(f"{what} replan", got, oracle)
    del oracle, got
    return before, old, new, delta, timings


def phase_line(name, times, stats0, stats1, counts, extra=""):
    return (f"phase {name}: ticks={len(times)} tick_ms_median="
            f"{statistics.median(times):.3f} tick_ms_mean="
            f"{statistics.mean(times):.3f} n_launches="
            f"{stats1.n_launches - stats0.n_launches} counters={counts}"
            f"{extra} max_memory_allocated_gb="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
            f" host_maxrss_gb={host_rss_gb():.2f}")


# ----------------------------------------------------- kernels vs plain
def k1_entry(s: Service, device):
    """K1 at the 4-job tick's shapes, on clones of the live state."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    jobs = s.rt.job_ids
    plan = s.rt.plan
    hp, bi, slot = s.tick_tables(
        jobs, [s.rt.state["counts"][j] + 1 for j in jobs])
    block = plan.block_align
    m = int(bi.numel()) * block
    g = torch.cat([s.grad(j) for j in jobs])
    kern = state_clone(s.rt.state)
    plain = state_clone(s.rt.state)
    agg_ops.aggregate_adam_multijob_fused(kern["flat"], g, kern["mu"],
                                          kern["nu"], hp, bi, slot,
                                          block=block)
    agg_ref.aggregate_adam_multijob_fused_plain(
        plain["flat"], g, plain["mu"], plain["nu"], hp, bi, slot, block=block)
    ulp = max(ulp_diff(kern[k], plain[k]) for k in kern)
    err = max(max_abs(kern[k], plain[k]) for k in kern)
    if ulp > ULP_BUDGET:
        raise AssertionError(f"K1 differs from its plain version: {ulp} ulp")
    ms = time_ms(lambda: agg_ops.aggregate_adam_multijob_fused(
        kern["flat"], g, kern["mu"], kern["nu"], hp, bi, slot, block=block),
        device)
    plain_ms = time_ms(lambda: agg_ref.aggregate_adam_multijob_fused_plain(
        plain["flat"], g, plain["mu"], plain["nu"], hp, bi, slot,
        block=block), device)
    del kern, plain
    nbytes = m * (12 + 4 + 12) + 8 * bi.numel() + hp.numel() * 4
    b, by = bound_ms(nbytes, m * ADAM_FLOPS_PER_LANE)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, max_abs_err=err, max_ulp=ulp,
                shape=f"N={plan.total_len} M={m} K={len(jobs)}")


def k3_entry(s: Service, device, job="vgg19"):
    """K3 for one job's block step (packed p), at that job's shapes."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    layout = s.rt.plan.job_layout(job)
    bi = torch.from_numpy(layout.blocks).to(device)
    hp = agg_ops.multi_job_hp([s.rt.state["counts"][job] + 1],
                              lr=s.LR[job]).to(device)
    rows = bi.long()
    st = s.rt.state
    p = st["flat"].view(-1, layout.block)[rows].reshape(-1)
    g = s.grad(job)
    args = (p, g, st["mu"], st["nu"], hp, bi)
    kern = agg_ops.aggregate_adam_blocks(*args, block=layout.block,
                                         p_packed=True)
    plain = agg_ref.aggregate_adam_blocks_plain(*args, block=layout.block,
                                                p_packed=True)
    ulp = max(ulp_diff(a, b) for a, b in zip(kern, plain))
    err = max(max_abs(a, b) for a, b in zip(kern, plain))
    if ulp > ULP_BUDGET:
        raise AssertionError(f"K3 differs from its plain version: {ulp} ulp")
    del kern, plain
    ms = time_ms(lambda: agg_ops.aggregate_adam_blocks(
        *args, block=layout.block, p_packed=True), device)
    plain_ms = time_ms(lambda: agg_ref.aggregate_adam_blocks_plain(
        *args, block=layout.block, p_packed=True), device)
    m = p.numel()
    b, by = bound_ms(m * (16 + 12) + 4 * bi.numel(), m * ADAM_FLOPS_PER_LANE)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, max_abs_err=err, max_ulp=ulp,
                shape=f"N={st['mu'].numel()} M={m} job={job}")


def k2_entries(before, delta, device):
    """K2 (staging + scatter) on the arrival delta, all three leaves.
    Also returns the two halves together against K2's own bound: every
    moved lane read once and every moved or vacated lane written once,
    per leaf."""
    from repro_torch.kernels.relayout import ops as rl_ops
    from repro_torch.kernels.relayout import ref as rl_ref

    leaves = [before[k] for k in ("flat", "mu", "nu")]
    src, dst = rl_ops.stage_tables(delta, device)
    staged = rl_ops.relayout_stage(leaves, src)
    staged_plain = rl_ref.stage_plain(leaves, src)
    err_stage = max(max_abs(a, b) for a, b in zip(staged, staged_plain))
    if not all(torch.equal(a, b) for a, b in zip(staged, staged_plain)):
        raise AssertionError("relayout_stage differs from its plain version")
    del staged_plain
    bases = [rl_ops._resize(x, delta.old_len, delta.new_len) for x in leaves]
    bases_plain = [b.clone() for b in bases]
    rl_ops.relayout_scatter(bases, staged, dst, block=delta.block)
    rl_ref.scatter_plain(bases_plain, staged, dst, delta.block)
    err_scatter = max(max_abs(a, b) for a, b in zip(bases, bases_plain))
    if not all(torch.equal(a, b) for a, b in zip(bases, bases_plain)):
        raise AssertionError("relayout_scatter differs from its plain version")
    del bases_plain
    n_lanes, n_leaves = int(src.numel()), len(leaves)
    n_kept = int((src >= 0).sum())
    stage = dict(
        ms=time_ms(lambda: rl_ops.relayout_stage(leaves, src), device),
        plain_ms=time_ms(lambda: rl_ref.stage_plain(leaves, src), device),
        library_ms=None, max_abs_err=err_stage, max_ulp=0,
        shape=f"lanes={n_lanes} kept={n_kept} leaves={n_leaves}")
    # Reads the int32 map and each leaf's kept lanes; writes every lane.
    stage["bound_ms"], stage["bound_by"] = bound_ms(
        n_lanes * 4 + n_leaves * (4 * n_kept + 4 * n_lanes), 0)
    rows = dst.long()

    def library():
        for b, t in zip(bases, staged):
            b.view(-1, delta.block).index_copy_(0, rows,
                                                t.view(-1, delta.block))

    scatter = dict(
        ms=time_ms(lambda: rl_ops.relayout_scatter(bases, staged, dst,
                                                   block=delta.block), device),
        plain_ms=time_ms(lambda: rl_ref.scatter_plain(bases, staged, dst,
                                                      delta.block), device),
        library_ms=time_ms(library, device),
        max_abs_err=err_scatter, max_ulp=0,
        shape=f"tiles={int(dst.numel())} block={delta.block} "
              f"leaves={n_leaves}")
    scatter["bound_ms"], scatter["bound_by"] = bound_ms(
        n_leaves * 8 * n_lanes + 4 * int(dst.numel()), 0)
    whole = dict(ms=stage["ms"] + scatter["ms"],
                 bound_ms=bound_ms(n_leaves * 4 * (n_kept + n_lanes), 0)[0])
    return stage, scatter, whole


# -------------------------------------------------------- the MLP phase
def block_step_vs_masked(rt, job, batch) -> int:
    """One ``ServiceRuntime.step`` of ``job`` (kernel K3) held against the
    masked full-space step (the plain ``_adam_math``) on a clone of the
    state and the same batch; returns the largest ulp difference."""
    from repro_torch.ps.runtime import make_ps_train_step

    info = rt._jobs[job]
    oracle = make_ps_train_step(info["loss_fn"], rt.plan, info["abstract"],
                                lr=info["lr"], job_id=job,
                                update_mode="masked")
    want, _ = oracle({**state_clone(rt.state),
                      "counts": dict(rt.state["counts"])}, batch)
    rt.step(job, batch)
    ulp = max(ulp_diff(rt.state[k], want[k]) for k in ("flat", "mu", "nu"))
    if ulp > ULP_BUDGET:
        raise AssertionError(f"block step (K3) vs plain masked step: {ulp} ulp")
    return ulp


def mlp_phase(device, wrappers):
    """Two MLP jobs train through engine.step and ServiceRuntime.step
    (block kernel) on the device; losses must be finite and fall."""
    from repro_torch.core import ParameterService
    from repro_torch.ps.service_runtime import ServiceRuntime

    gen = torch.Generator(device=device)
    gen.manual_seed(1)

    def init(d_in):
        r = lambda *s: torch.randn(*s, generator=gen, device=device)
        z = lambda n: torch.zeros(n, device=device)
        return {"w1": r(d_in, 64) / 4.0, "b1": z(64), "w2": r(64, 64) / 8.0,
                "b2": z(64), "w3": r(64, 1) / 8.0, "b3": z(1)}

    def loss(params, batch):
        h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
        h = torch.tanh(h @ params["w2"] + params["b2"])
        pred = (h @ params["w3"] + params["b3"])[:, 0]
        return torch.mean((pred - batch["y"]) ** 2)

    pool_x = torch.randn(256, 16, generator=gen, device=device)
    pool_y = torch.sin(pool_x.sum(1))

    def batch():
        sel = torch.randint(0, 256, (64,), generator=gen, device=device)
        return {"x": pool_x[sel], "y": pool_y[sel]}

    rt = ServiceRuntime(ParameterService(total_budget=16, n_clusters=1,
                                         plan_pad_to=128), device=device)
    eng = rt.attach_engine(max_staleness=1)
    for jid in ("mlp", "mlp2"):
        params = init(16)
        rt.add_job(jid, params, loss, required_servers=2, lr=3e-3,
                   agg_throughput=sum(4 * v.numel() for v in params.values())
                   / 0.45)
    reset_counters(wrappers)
    losses = {j: [] for j in rt.job_ids}
    for _ in range(20):
        for j in rt.job_ids:
            losses[j].append(float(eng.step(j, batch())["loss"]))
    eng.drain()
    direct = [float(rt.step(j, batch())["loss"]) for _ in range(5)
              for j in rt.job_ids]
    sync(device)
    counts = read_counters(wrappers)
    ulp = block_step_vs_masked(rt, "mlp", batch())
    for j, ls in losses.items():
        if not all(np.isfinite(ls)) or not np.mean(ls[-5:]) < np.mean(ls[:5]):
            raise AssertionError(f"MLP job {j}: losses not finite and "
                                 f"falling: {ls}")
    if not all(np.isfinite(direct)):
        raise AssertionError(f"block-kernel steps gave non-finite losses")
    print(f"phase d (MLP, engine.step x20 + ServiceRuntime.step x5 per job): "
          f"first={ {j: round(l[0], 5) for j, l in losses.items()} } "
          f"last={ {j: round(l[-1], 5) for j, l in losses.items()} } "
          f"direct_last={direct[-1]:.5f} counters={counts} "
          f"block_step_vs_plain_max_ulp={ulp}", flush=True)
    return counts


# ----------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of every workload tensor (a rehearsal "
                         "below 1 prints no result and exits 2)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card",
              file=sys.stderr)
        return 1
    _import_port()
    from repro_torch.kernels import _build
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.relayout import ops as rl_ops

    device = torch.device("cuda:0")
    scale = args.scale
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs)})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    wrappers = {
        "agg_adam_multijob_fused": agg_ops.aggregate_adam_multijob_fused,
        "agg_adam_blocks": agg_ops.aggregate_adam_blocks,
        "relayout_stage": rl_ops.relayout_stage,
        "relayout_scatter": rl_ops.relayout_scatter,
    }
    totals = dict.fromkeys(wrappers, 0)

    def add_totals(counts):
        for k, v in counts.items():
            totals[k] += v

    # ---- set-up: three paper workloads resident
    s = Service(device, scale)
    t0 = time.perf_counter()
    for model in ("alexnet", "vgg19", "bert"):
        s.add(model)
    sync(device)
    plan = s.rt.plan
    print(f"setup: jobs={list(s.rt.job_ids)} shards={plan.n_shards} "
          f"total_len={plan.total_len} payload={plan.payload_elements} "
          f"seconds={time.perf_counter() - t0:.2f} host_maxrss_gb="
          f"{host_rss_gb():.2f}", flush=True)

    # ---- phase a: 8 ticks, three jobs
    torch.cuda.reset_peak_memory_stats()
    stats0 = dataclasses.replace(s.eng.stats)
    reset_counters(wrappers)
    times = run_ticks(s, 8, check_tick=True)
    counts = read_counters(wrappers)
    _require(counts, ("agg_adam_multijob_fused",), "a")
    add_totals(counts)
    print(phase_line("a (3 jobs)", times, stats0, s.eng.stats, counts),
          flush=True)

    # ---- phase b: AWD-LM arrives, 8 ticks, four jobs
    torch.cuda.reset_peak_memory_stats()
    stats0 = dataclasses.replace(s.eng.stats)
    reset_counters(wrappers)
    before, old, new, delta, timings = replan(
        s, "arrival", lambda: s.add("awd-lm"))
    times = run_ticks(s, 8, check_tick=True)
    counts = read_counters(wrappers)
    _require(counts, ("agg_adam_multijob_fused", "relayout_stage",
                      "relayout_scatter"), "b")
    add_totals(counts)
    print(phase_line(
        "b (AWD-LM arrives)", times, stats0, s.eng.stats, counts,
        f" total_len {old.total_len}->{new.total_len} moved_elements="
        f"{delta.moved_elements} touched_jobs={list(delta.touched_jobs)} "
        f"touched_blocks={delta.touched_blocks.size}{timings}"), flush=True)
    entries = {"agg_adam_multijob_fused": k1_entry(s, device)}
    entries["relayout_stage"], entries["relayout_scatter"], k2 = k2_entries(
        before, delta, device)
    print(f"K2 as a whole (stage + scatter) on the arrival delta: "
          f"ms={k2['ms']:.4f} bound_ms={k2['bound_ms']:.4f} (moved lanes "
          f"read once, moved and vacated lanes written once, per leaf) "
          f"ratio={k2['ms'] / k2['bound_ms']:.3f}", flush=True)
    del before

    # ---- phase c: AWD-LM leaves, 8 ticks, three jobs
    torch.cuda.reset_peak_memory_stats()
    stats0 = dataclasses.replace(s.eng.stats)
    reset_counters(wrappers)
    before, old, new, delta, timings = replan(
        s, "exit", lambda: s.rt.remove_job("awd-lm"))
    del before
    times = run_ticks(s, 8, check_tick=True)
    counts = read_counters(wrappers)
    _require(counts, ("agg_adam_multijob_fused", "relayout_stage",
                      "relayout_scatter"), "c")
    add_totals(counts)
    print(phase_line(
        "c (AWD-LM leaves)", times, stats0, s.eng.stats, counts,
        f" total_len {old.total_len}->{new.total_len} moved_elements="
        f"{delta.moved_elements} zeroed_elements={delta.zeroed_elements} "
        f"touched_jobs={list(delta.touched_jobs)} touched_blocks="
        f"{delta.touched_blocks.size}{timings}"), flush=True)
    entries["agg_adam_blocks"] = k3_entry(s, device)
    print(f"engine stats: {s.rt.debug_stats()['engine']}", flush=True)
    del s

    # ---- phase d: real models on the device
    counts = mlp_phase(device, wrappers)
    _require(counts, ("agg_adam_multijob_fused", "agg_adam_blocks"), "d")
    add_totals(counts)

    # ---- report
    meta = {
        "agg_adam_multijob_fused": (
            "src/repro_torch/kernels/agg_adam/csrc/agg_adam.cu",
            "src/repro/kernels/agg_adam/kernel.py:214"),
        "agg_adam_blocks": (
            "src/repro_torch/kernels/agg_adam/csrc/agg_adam.cu",
            "src/repro/kernels/agg_adam/kernel.py:124"),
        "relayout_stage": (
            "src/repro_torch/kernels/relayout/csrc/relayout.cu",
            "src/repro/kernels/relayout/kernel.py:48"),
        "relayout_scatter": (
            "src/repro_torch/kernels/relayout/csrc/relayout.cu",
            "src/repro/kernels/relayout/kernel.py:48"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        e = entries[name]
        if totals[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        print(f"kernel {name}: {e['shape']} ms={e['ms']:.4f} plain_ms="
              f"{e['plain_ms']:.4f} bound_ms={e['bound_ms']:.4f} "
              f"({e['bound_by']}) library_ms={e['library_ms']} max_ulp="
              f"{e['max_ulp']} launches={totals[name]}", flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": totals[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    if scale != 1.0:
        print(f"rehearsal at scale {scale} finished: no result",
              file=sys.stderr)
        return 2
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _require(counts, names, phase):
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"phase {phase}: no launch of {missing}")


if __name__ == "__main__":
    sys.exit(main())
