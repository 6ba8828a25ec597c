"""The shared service's answer worked out again: each job's parameters,
Adam moments and error-feedback residual after the pushes it made.

Adam and the compression round are elementwise, or blockwise over one
int8 block, so every lane of the answer can be worked out on its own.
The reference follows a sample of the lanes, drawn from the seed in
whole int8 blocks, through every push the run made, from the inputs it
draws again from the seed.

Which lanes share an int8 block is the program's packing: each job's
push is split into one packed piece per hosting shard, and every 2048
lanes of a piece share a scale.  The reference takes that packing from
the program (the packed-lane to tensor-element map and the packed-lane
to state-lane map) and first checks it is a packing at all: every
tensor element in exactly one packed lane of its job, every packed lane
of every job on a state lane of its own.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

from .. import inputs
from .adam import INT8_BLOCK, adam_step, ef_round


def layout_faults(maps: Iterable[Dict], arena_len: int) -> int:
    """How many ways the packing fails to be one: a tensor element in no
    packed lane or in two, a packed lane off the state or sharing a state
    lane with another.  ``maps`` gives per job ``payload`` (packed lane ->
    tensor element, -1 on padding), ``arena`` (packed lane -> state lane)
    and ``n_payload``."""
    faults = 0
    lanes = []
    for m in maps:
        pay = m["payload"]
        hit = pay[pay >= 0]
        if hit.numel() != m["n_payload"]:
            faults += 1
        elif not torch.equal(torch.sort(hit).values,
                             torch.arange(m["n_payload"], device=hit.device)):
            faults += 1
        lanes.append(m["arena"])
    lanes = torch.cat(lanes)
    if lanes.numel() and (int(lanes.min()) < 0
                          or int(lanes.max()) >= arena_len):
        faults += 1
    srt = torch.sort(lanes).values
    if srt.numel() > 1 and bool((srt[1:] == srt[:-1]).any()):
        faults += 1
    return faults


def replay(job: Dict, *, seed: int, init_scale: float, grad_scale: float,
           ring: int, steps: int, adam: Dict, dtype: torch.dtype,
           device: torch.device) -> Dict[str, torch.Tensor]:
    """The sampled lanes of one job after ``steps`` pushes, push t being
    ring gradient (t - 1) % ring.  Lanes are (blocks, INT8_BLOCK); a
    lane holding no tensor element (padding, or past a piece's end) is 0
    in the parameters and every gradient.  Returns flat/mu/nu (and ef
    for a compressed job) and ``init``, in ``dtype``."""
    idx = job["payload_idx"].to(device)
    hit = idx >= 0
    safe = idx.clamp(min=0)

    def draw(*parts, scale):
        full = inputs.normal(job["n_payload"], scale, seed, *parts,
                             device=device)
        return torch.where(hit, full[safe], 0.0).to(dtype)

    p = draw("init", job["id"], scale=init_scale)
    init = p.clone()
    grads = [draw("grad", job["id"], r, scale=grad_scale)
             for r in range(ring)]
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    ef = torch.zeros_like(p)
    kind = job["kind"]
    for t in range(1, steps + 1):
        g, ef = ef_round(grads[(t - 1) % ring], ef, kind)
        p, m, v = adam_step(p, m, v, g, t, lr=job["lr"], **adam)
    out = {"flat": p, "mu": m, "nu": v, "init": init}
    if kind:
        out["ef"] = ef
    return out


def gaps(job: Dict, want: Dict[str, torch.Tensor],
         got: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """Per leaf, the distance of ``got`` (the program's lanes, or a
    control's) from ``want`` (the reference's) over the sampled lanes,
    relative to how far the reference moved the leaf from its start:
    ||got - want|| / ||want - start||, in float64."""
    got = job["prog"] if got is None else got
    valid = job["valid"].to(want["flat"].device)
    out = {}
    for leaf in ("flat", "mu", "nu", "ef"):
        if leaf not in want:
            continue
        w = want[leaf].double()[valid]
        start = want["init"].double()[valid] if leaf == "flat" else 0.0
        moved = torch.linalg.vector_norm(w - start)
        g = got[leaf].to(w.device).double()[valid]
        out[leaf] = float(torch.linalg.vector_norm(g - w) / moved) \
            if float(moved) > 0 else float("inf")
    return out


def sample_blocks(piece_lens: List[int], n_blocks: int, seed: int,
                  job_id: str):
    """Up to ``n_blocks`` whole int8 blocks of a job's pieces, drawn from
    the seed: [(piece index, first lane in the piece)], in order."""
    per = [-(-n // INT8_BLOCK) for n in piece_lens]
    total = sum(per)
    pick = inputs.rng(seed, "sample", job_id).choice(
        total, size=min(n_blocks, total), replace=False)
    out, base = [], 0
    bounds = []
    for i, n in enumerate(per):
        bounds.append((base, base + n, i))
        base += n
    for b in sorted(int(x) for x in pick):
        for lo, hi, i in bounds:
            if lo <= b < hi:
                out.append((i, (b - lo) * INT8_BLOCK))
                break
    return out
