"""The paper's four testbed workloads (§5.1) as profiled aggregation jobs.

Tensor inventories follow the published architectures (AlexNet, VGG19,
AWD-LSTM on WikiText-2, BERT-base). Iteration durations and aggregation
throughput are calibrated to the paper's published observations, since the
raw profiles are not public:

  * aggregation throughput 7 GB/s per server unit (consistent with VGG19's
    1s-2w average utilization of 16%, Fig. 2, at a ~1.0 s iteration);
  * per-(servers, workers) iteration durations chosen so that the packing
    results of Fig. 8 / Table 2 are decided by the same arithmetic the paper
    reports: AlexNet's short iteration -> high aggregation frequency -> extra
    Aggregator; VGG19's long iteration -> 4 jobs on 2 Aggregators.

Like MXNet's kvstore (bigarray_bound), tensors larger than `chunk_bytes` are
split into multiple aggregation tasks; ps-lite shards large tensors the same
way, so task granularity below whole-tensor is faithful to the baseline.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.core.types import AggTask, JobProfile

AGG_THROUGHPUT = 7e9  # bytes/s of gradient summing + update per server unit
DEFAULT_CHUNK_BYTES = 16 << 20  # 16 MB, coarse kvstore-style big-array split
BYTES_PER_PARAM = 4  # fp32 gradients/parameters on the PS


def _conv(cin: int, cout: int, k: int = 3) -> int:
    return cin * cout * k * k


# (name, #params) per tensor --------------------------------------------------
ALEXNET_TENSORS: List[Tuple[str, int]] = [
    ("conv1.w", 96 * 3 * 11 * 11), ("conv1.b", 96),
    ("conv2.w", 256 * 48 * 5 * 5), ("conv2.b", 256),
    ("conv3.w", 384 * 256 * 3 * 3), ("conv3.b", 384),
    ("conv4.w", 384 * 192 * 3 * 3), ("conv4.b", 384),
    ("conv5.w", 256 * 192 * 3 * 3), ("conv5.b", 256),
    ("fc6.w", 9216 * 4096), ("fc6.b", 4096),
    ("fc7.w", 4096 * 4096), ("fc7.b", 4096),
    ("fc8.w", 4096 * 1000), ("fc8.b", 1000),
]

_VGG_CFG = [(3, 64), (64, 64), (64, 128), (128, 128),
            (128, 256), (256, 256), (256, 256), (256, 256),
            (256, 512), (512, 512), (512, 512), (512, 512),
            (512, 512), (512, 512), (512, 512), (512, 512)]
VGG19_TENSORS: List[Tuple[str, int]] = (
    [(f"conv{i}.w", _conv(cin, cout)) for i, (cin, cout) in enumerate(_VGG_CFG)]
    + [(f"conv{i}.b", cout) for i, (_, cout) in enumerate(_VGG_CFG)]
    + [("fc6.w", 25088 * 4096), ("fc6.b", 4096),
       ("fc7.w", 4096 * 4096), ("fc7.b", 4096),
       ("fc8.w", 4096 * 1000), ("fc8.b", 1000)]
)

AWDLM_TENSORS: List[Tuple[str, int]] = [
    ("embed.w", 33278 * 400),  # tied with decoder
    ("lstm0.w", 4 * 1150 * (400 + 1150)), ("lstm0.b", 4 * 1150),
    ("lstm1.w", 4 * 1150 * (1150 + 1150)), ("lstm1.b", 4 * 1150),
    ("lstm2.w", 4 * 400 * (1150 + 400)), ("lstm2.b", 4 * 400),
    ("decoder.b", 33278),
]

def _bert_tensors() -> List[Tuple[str, int]]:
    d, ff, L, vocab = 768, 3072, 12, 30522
    ts: List[Tuple[str, int]] = [
        ("embed.word", vocab * d), ("embed.pos", 512 * d), ("embed.type", 2 * d),
        ("embed.ln.g", d), ("embed.ln.b", d),
    ]
    for i in range(L):
        p = f"layer{i}."
        for w in ("q", "k", "v", "o"):
            ts += [(p + f"attn.{w}.w", d * d), (p + f"attn.{w}.b", d)]
        ts += [(p + "attn.ln.g", d), (p + "attn.ln.b", d),
               (p + "ffn.in.w", d * ff), (p + "ffn.in.b", ff),
               (p + "ffn.out.w", ff * d), (p + "ffn.out.b", d),
               (p + "ffn.ln.g", d), (p + "ffn.ln.b", d)]
    ts += [("pooler.w", d * d), ("pooler.b", d)]
    return ts

BERT_TENSORS: List[Tuple[str, int]] = _bert_tensors()

MODEL_TENSORS: Dict[str, List[Tuple[str, int]]] = {
    "alexnet": ALEXNET_TENSORS,
    "vgg19": VGG19_TENSORS,
    "awd-lm": AWDLM_TENSORS,
    "bert": BERT_TENSORS,
}

# Calibrated iteration durations: (model, n_servers, n_workers) -> seconds.
ITERATION_DURATION: Dict[Tuple[str, int, int], float] = {
    ("alexnet", 1, 2): 0.130, ("alexnet", 2, 2): 0.065, ("alexnet", 4, 4): 0.065,
    ("vgg19", 1, 2): 1.000, ("vgg19", 2, 2): 0.550, ("vgg19", 4, 4): 0.400,
    ("awd-lm", 1, 2): 0.150, ("awd-lm", 2, 2): 0.150, ("awd-lm", 4, 4): 0.150,
    ("bert", 1, 2): 0.250, ("bert", 2, 2): 0.250, ("bert", 4, 4): 0.250,
}


def model_bytes(model: str) -> int:
    return sum(p for _, p in MODEL_TENSORS[model]) * BYTES_PER_PARAM


def make_job(
    model: str,
    job_id: str,
    n_servers: int = 2,
    n_workers: int = 2,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    agg_throughput: float = AGG_THROUGHPUT,
) -> JobProfile:
    """Build the profiled JobProfile for one paper workload configuration."""
    if model not in MODEL_TENSORS:
        raise KeyError(f"unknown paper workload {model!r}")
    duration = ITERATION_DURATION.get((model, n_servers, n_workers))
    if duration is None:
        # Interpolate: scale the closest profiled config's duration.
        base = ITERATION_DURATION[(model, 2, 2)]
        duration = base
    tasks: List[AggTask] = []
    tid = 0
    for name, params in MODEL_TENSORS[model]:
        nbytes = params * BYTES_PER_PARAM
        n_chunks = max(1, -(-nbytes // chunk_bytes))  # ceil div
        per_chunk = nbytes // n_chunks
        for c in range(n_chunks):
            b = per_chunk if c < n_chunks - 1 else nbytes - per_chunk * (n_chunks - 1)
            tasks.append(
                AggTask(
                    job_id=job_id,
                    tensor_id=tid,
                    name=f"{name}[{c}]" if n_chunks > 1 else name,
                    nbytes=b,
                    exec_time=n_workers * b / agg_throughput,
                )
            )
            tid += 1
    return JobProfile(
        job_id=job_id,
        model=model,
        iteration_duration=duration,
        tasks=tasks,
        n_workers=n_workers,
        required_servers=n_servers,
    )


def standalone_utilization(model: str, n_servers: int, n_workers: int) -> float:
    """The Fig. 2 quantity for one configuration."""
    job = make_job(model, "probe", n_servers, n_workers)
    return job.standalone_utilization
