"""Serving driver (``repro.launch.serve``): --arch <LM id>, batched decode
with a KV cache, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --batch 16 --prompt-len 128 --gen 128

By default the decode weights are read THROUGH the parameter service's
read tier: the model's parameters are hosted as one job of a
``ServiceRuntime``, a :class:`~repro_torch.ps.replica.ReplicaSet` of
``--replicas`` pull-only endpoints subscribes to its tick engine, and
the decode loop runs on a replica-served pull, checked bit for bit
against the hosted weights before any token is generated (the service
hosts float32; bf16 weights round-trip bf16 -> float32 -> bf16
losslessly).  ``--direct`` skips the service and decodes straight off
``init_params``: a model whose float32 hosting (the service's flat, mu
and nu, 12 bytes a parameter, beside the weights) does not fit the card
must take it (granite-8b: about 97 GB hosted), and hosting refuses it.
``--layers N`` keeps the first N layers of a model too deep for one
card, its widths unchanged.  Runs on ``cuda:0`` unless ``--device
cpu``; every lm arch (dense, MoE, MLA with its absorbed decode) and no
other family.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --direct --batch 16 --prompt-len 128 --gen 128
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import registry
from ..device import resolve_device
from ..models import transformer as tf
from ..tree import (tree_leaves, tree_leaves_by_key, tree_map,
                    tree_with_leaves)


def _no_loss(params, batch):
    raise NotImplementedError("the hosted serving job only serves its "
                              "weights: it has no training loss")


HOSTED_BYTES_PER_PARAM = 12  # the service's float32 flat, mu and nu


def _check_hosting_fits(params, device) -> None:
    """Refuse a float32 hosting that cannot fit the card beside the
    weights (pass ``--direct``)."""
    if device.type != "cuda":
        return
    n = sum(t.numel() for t in tree_leaves(params))
    need = n * HOSTED_BYTES_PER_PARAM
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise ValueError(
            f"hosting {n} parameters as a float32 service job needs "
            f"{need / 1e9:.1f} GB, the card has {free / 1e9:.1f} GB free: "
            f"pass --direct")


def _pull_params_via_replicas(params, n_replicas: int,
                              timings: Optional[Dict[str, float]] = None):
    """Host ``params`` as one parameter-service job and read them back
    through a fresh ReplicaSet; returns (the replica-served parameters in
    the original dtypes, the ReplicaSet).  Raises unless the served
    float32 payload equals the hosted float32 weights bit for bit.
    ``timings``, if given, receives the host seconds of ``add_job`` (the
    plan compile and the seeding) and of the publish and the pull."""
    from ..core import ParameterService
    from ..ps.replica import ReplicaSet
    from ..ps.service_runtime import ServiceRuntime

    device = tree_leaves(params)[0].device
    hosted = tree_map(lambda x: x.float(), params)
    rt = ServiceRuntime(ParameterService(total_budget=16, n_clusters=1),
                        device=device)
    eng = rt.attach_engine(max_staleness=0)
    nbytes = sum(4 * v.numel() for v in tree_leaves(hosted))
    t0 = time.perf_counter()
    rt.add_job("lm", hosted, _no_loss, lr=0.0, required_servers=1,
               agg_throughput=nbytes / 0.2)
    t1 = time.perf_counter()
    rs = ReplicaSet(eng, n_replicas=n_replicas, publish_interval=1)
    rs.refresh()  # no tick has run yet: force the first publish
    served = rs.pull("lm")
    if timings is not None:
        timings.update(add_job_s=t1 - t0,
                       publish_and_pull_s=time.perf_counter() - t1)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(tree_leaves(served), tree_leaves(hosted))):
        raise AssertionError(
            "replica-served parameters diverge from the hosted weights")
    dtypes = {k: t.dtype for k, t in tree_leaves_by_key(params).items()}
    return tree_with_leaves(served, {
        k: v.to(dtypes[k]) for k, v in tree_leaves_by_key(served).items()
    }), rs


def decode(cfg, params, prompt: torch.Tensor, gen: int,
           temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> Dict[str, object]:
    """Prefill ``prompt`` (B, P) by repeated decode, then generate ``gen``
    tokens (greedy, or sampled at ``temperature`` from ``generator``).
    Returns ``tokens`` (B, gen) int32, ``prompt_logits`` (the last prompt
    step's (B, V) logits), ``cache`` and ``gen_s``, the seconds of the
    ``gen - 1`` decode steps after the prompt, timed as one window with a
    single synchronize at its end (the host runs ahead of the device
    within it)."""
    batch, prompt_len = prompt.shape
    serve = tf.make_serve_step(cfg)
    cache = tf.init_kv_cache(cfg, batch, prompt_len + gen,
                             device=prompt.device)
    # Prefill via repeated decode, as the reference's driver does.
    for i in range(prompt_len):
        logits, cache = serve(params, cache, prompt[:, i:i + 1])
    prompt_logits = logits

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator
                                     ).to(torch.int32)
        return torch.argmax(logits, -1)[:, None].to(torch.int32)

    sync = (torch.cuda.synchronize if prompt.device.type == "cuda"
            else (lambda: None))
    tok = pick(logits)
    out: List[torch.Tensor] = [tok]
    sync()
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = serve(params, cache, tok)
        tok = pick(logits)
        out.append(tok)
    sync()
    gen_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prompt_logits": prompt_logits,
            "cache": cache, "gen_s": gen_s}


def main(argv=None, params=None) -> Dict[str, object]:
    """The driver; ``params`` replaces the seeded ``init_params`` weights
    (the tests pass the reference's, converted).  Returns ``decode``'s
    result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--replicas", type=int, default=2,
                    help="read-tier replica count the decode weights are "
                         "pulled through (default 2)")
    ap.add_argument("--direct", action="store_true",
                    help="skip the parameter service's read tier and "
                         "decode straight off init_params")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (the leading dense ones "
                         "included), widths unchanged")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    family = registry.family(args.arch)
    if family == "gnn":
        raise NotImplementedError(
            f"arch {args.arch!r} (gnn) is not ported yet (ROADMAP.md, "
            f"Queue 1 item 15, part 4)")
    if family != "lm":
        raise ValueError(f"{args.arch} is not an LM; serve decodes LM archs")
    device = resolve_device(args.device)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    if args.layers is not None:
        if not cfg.first_k_dense < args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers, {cfg.first_k_dense} "
                             f"of them leading dense ones")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = tf.init_params(cfg, gen, device)
    if not args.direct:
        _check_hosting_fits(params, device)
        params, rs = _pull_params_via_replicas(params, args.replicas)
        st = rs.replicas[0].stats
        print(f"[serve] weights read through {len(rs.replicas)} pull "
              f"replicas (bit-exact vs hosted): {st.n_full_serves} full "
              f"serve(s), {st.bytes_served} B served, "
              f"{rs.n_publishes} publish(es)", flush=True)
        # The hosting service (engine <-> hub <-> runtime refer to each
        # other) is done: collect it now, before the cache is allocated.
        del rs
        gc.collect()

    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)
    ).to(device)
    sampler = torch.Generator(device=device)
    sampler.manual_seed(1)
    out = decode(cfg, params, prompt, args.gen, args.temperature, sampler)
    dt = out["gen_s"]
    toks = args.batch * (args.gen - 1)
    print(f"[serve] generated {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s batch={args.batch})",
          flush=True)
    print("[serve] first sequence token ids:",
          out["tokens"][0, :16].cpu().numpy(), "...", flush=True)
    return out


if __name__ == "__main__":
    main()
