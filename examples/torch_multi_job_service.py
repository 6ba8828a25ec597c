"""Multi-job elastic aggregation on the PyTorch port: two training jobs
sharing ONE flat aggregation space, surviving live replans.

Job A (an MLP regressor) and job B (a small LM) register with a single
ParameterService; its compiled ServicePlan lays both jobs' tensors into
one shared flat state (``ServiceRuntime``), and both train through the
service-tick engine: each step submits its push into the job's bounded
queue, and each tick applies every pending job's push in one launch of
the multi-job Adam kernel (K1) over the shared space (bounded staleness:
a job may run ``max_staleness`` steps ahead before its pull blocks on the
tick).  A third job arrives a third of the way in and exits at two
thirds: each placement change drains the touched jobs' queues, recompiles
the plan and moves everyone's flat/mu/nu through the relayout kernels
(K2) without stopping training.  Last, a checkpoint taken under one
packing restores under another.  The torch counterpart of
``examples/multi_job_service.py``; weights come from a seeded
``torch.Generator``, so the numbers differ from the reference's.

Run: PYTHONPATH=src python examples/torch_multi_job_service.py
     [--steps 60] [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import restore_ps_checkpoint, save_ps_checkpoint
from repro_torch.core import ParameterService
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.ps.service_runtime import ServiceRuntime
from repro_torch.tree import tree_leaves

LM_CFG = tf.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=256, loss_chunk=16,
                     tie_embeddings=True)


def mlp_init(gen, device, d_in=16):
    def r(*s):
        return torch.randn(*s, generator=gen, device=device)

    def z(n):
        return torch.zeros(n, device=device)

    return {"w1": r(d_in, 64) / 4.0, "b1": z(64), "w2": r(64, 64) / 8.0,
            "b2": z(64), "w3": r(64, 1) / 8.0, "b3": z(1)}


def mlp_loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    pred = (h @ params["w3"] + params["b3"])[:, 0]
    return torch.mean((pred - batch["y"]) ** 2)


def lm_loss(params, batch):
    return tf.loss_fn(LM_CFG, params, batch)


def make_mlp_batches(rng, device, d_in=16, n=256):
    """Minibatches from a fixed pool, so the loss curve is a clean
    optimization signal (fresh random data every step would dominate
    it)."""
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    y = np.sin(x.sum(1))

    def batch():
        sel = rng.integers(0, n, size=64)
        return {"x": torch.from_numpy(x[sel]).to(device),
                "y": torch.from_numpy(y[sel]).to(device)}

    return batch


def make_lm_batches(rng, device):
    corpus = rng.integers(0, LM_CFG.vocab, size=(32, 32), dtype=np.int32)

    def batch():
        toks = torch.from_numpy(corpus[rng.integers(0, 32, size=8)]).to(device)
        return {"tokens": toks, "labels": toks}

    return batch


def _throughput(params, busy=0.45):
    """Aggregation throughput making this job occupy ``busy`` CPU-seconds
    per iteration, so the control plane's packing decisions are
    non-trivial."""
    return sum(4 * t.numel() for t in tree_leaves(params)) / busy


def main(argv=None) -> dict:
    """Returns each job's losses by step, the migrated bytes of the
    arrival and the exit, and the engine's stats."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    arrive, leave = args.steps // 3, 2 * args.steps // 3

    svc = ParameterService(total_budget=16, n_clusters=1, plan_pad_to=128)
    rt = ServiceRuntime(svc, device=device)
    eng = rt.attach_engine(max_staleness=1)
    mlp_params = mlp_init(gen, device)
    rt.add_job("mlp", mlp_params, mlp_loss, required_servers=2, lr=3e-3,
               agg_throughput=_throughput(mlp_params))
    lm_params = tf.init_params(LM_CFG, gen, device)
    rt.add_job("lm", lm_params, lm_loss, required_servers=2, lr=1e-3,
               agg_throughput=_throughput(lm_params))

    batches = {"mlp": make_mlp_batches(rng, device),
               "lm": make_lm_batches(rng, device)}
    print(f"plan: {rt.plan.n_shards} shards x {rt.plan.shard_len} elements, "
          f"{len(rt.plan.segments)} segments from jobs "
          f"{list(rt.plan.job_ids)}")
    print(f"{'step':>4s} {'mlp loss':>10s} {'lm loss':>10s} "
          f"{'probe loss':>11s}")
    out = {"losses": {"mlp": [], "lm": [], "probe": []}, "migrated": {}}
    for i in range(args.steps):
        if i == arrive:
            # A third job arrives: the service replans, every resident
            # job's segments migrate onto the new layout, training never
            # stops.
            probe_params = mlp_init(gen, device, d_in=8)
            rt.add_job("probe", probe_params, mlp_loss, required_servers=1,
                       lr=3e-3,
                       agg_throughput=_throughput(probe_params, busy=0.6))
            batches["probe"] = make_mlp_batches(rng, device, d_in=8)
            out["migrated"]["arrival"] = rt.last_migration_bytes
            print(f"-- probe job arrived: replanned to {rt.plan.n_shards} "
                  f"shards ({rt.last_migration_bytes / 1e3:.1f} kB "
                  f"migrated) --")
        if i == leave:
            # ... and exits: freed Aggregators are recycled, survivors'
            # tensors consolidate (another live migration).
            rt.remove_job("probe")
            batches.pop("probe")
            out["migrated"]["exit"] = rt.last_migration_bytes
            print(f"-- probe job exited: replanned to {rt.plan.n_shards} "
                  f"shards ({rt.last_migration_bytes / 1e3:.1f} kB "
                  f"migrated) --")
        losses = {jid: float(eng.step(jid, fn())["loss"])
                  for jid, fn in batches.items()}
        for jid, loss in losses.items():
            out["losses"][jid].append((i, loss))
        if i % 10 == 0 or i == args.steps - 1:
            probe = (f"{losses['probe']:11.4f}" if "probe" in losses
                     else f"{'-':>11s}")
            print(f"{i:4d} {losses['mlp']:10.4f} {losses['lm']:10.4f} "
                  f"{probe}")

    eng.drain()  # settle every queued push before checkpointing

    # A checkpoint taken under one packing restores under another.
    with tempfile.TemporaryDirectory() as d:
        save_ps_checkpoint(d, args.steps - 1, rt.plan, rt.state)
        svc.periodic_rebalance()
        _, restored = restore_ps_checkpoint(d, args.steps - 1, plan=rt.plan,
                                            device=device)
        if not torch.equal(restored["flat"], rt.state["flat"]):
            raise AssertionError("the restored flat space differs from the "
                                 "live one")
    print(f"both jobs trained through ONE shared aggregation space across "
          f"{rt.n_replans} live replans ({rt.total_migration_bytes / 1e3:.1f}"
          f" kB migrated total); no job was interrupted.")
    st = eng.stats
    print(f"service ticks: {st.n_ticks} batched passes applied "
          f"{st.n_applied} pushes (mean batch {st.mean_batch:.1f} jobs/tick, "
          f"{st.n_forced_staleness} pulls blocked on the staleness bound)")
    out["stats"] = st
    out["n_replans"] = rt.n_replans
    return out


if __name__ == "__main__":
    main()
