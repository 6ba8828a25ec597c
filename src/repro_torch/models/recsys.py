"""RecSys models (``repro.models.recsys``): the system EmbeddingBag, DLRM
(dot interaction), SASRec and DIEN (GRU + AUGRU), plain PyTorch around
the embedding-bag kernel K6.

**Why K6 sits on DLRM's lookup.**  The reference builds every lookup
from ``jnp.take`` and leaves its Pallas embedding bag to the tests; its
one-device lookup stacks a take per field, which XLA fuses into one
program under ``jit``.  Here the one-device ``sharded_embedding_lookup``
is one table-batched K6 launch, ``embedding_bags(tables, ids)``: one bag
of one row per field, straight into (B, 26, D) at DLRM's 26 fields.
That is how the upstream DLRM (facebookresearch/dlrm) feeds Criteo's
one-hot fields, through ``nn.EmbeddingBag``; and a float32 sum of one
row is the row, so the values equal the reference's takes bit for bit
(but for a -0.0, which 0 + -0.0 makes +0.0).  The gradient is the
dense (V, D) one that ``jax.grad`` of a take gives, summed per row in a
fixed order (:func:`_dense_grad`): an atomic scatter-add would make two
identical steps differ, and so does ``F.embedding``'s CUDA backward
(``embedding_dense_backward``) where ids repeat many times, as a batch
of 65,536 does in DLRM-RM2's tables of a few hundred rows.  SASRec and
DIEN gather with ``jnp.take`` in the reference and with ``F.embedding``
here; no TPU kernel runs in either.

``lookup="plain"`` routes DLRM's lookups through K6's plain version
instead of the kernel (on any device): the check that the kernel's
training step equals the plain one bit for bit.  Under an
activation-sharding context (``ps.act_sharding``) the lookup is the
reference's mesh branch: K6 over each rank's row shards, then a
reduce-scatter (``sharded_embedding_lookup``).  ``lax.scan`` becomes a
Python loop over the sequence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..device import resolve_device
from ..kernels.embed_bag import ops as eb_ops
from ..kernels.embed_bag import ref as eb_ref
from ..ps import act_sharding as act
from ..tree import value_and_grad
from .layers import mlp, normal_init

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOOKUPS = ("kernel", "plain")


def _generator(generator: Optional[torch.Generator], device
               ) -> Optional[torch.Generator]:
    """``generator``, or one seeded 0 on ``device``; None on ``meta``,
    which draws shapes only."""
    if device.type == "meta":
        return None
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


# ------------------------------------------------------------- EmbeddingBag
def _dense_grad(grad_rows: torch.Tensor, indices: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """The (n_rows, D) gradient of a gather ``table[indices]`` whose rows
    got ``grad_rows`` (indices.shape + (D,)): each row's gradients summed
    in the order of their positions, from zero, by one sequential
    segment sum per row; rows never looked up get zero.  A stable sort of
    the ids and a segment sum, no atomics and no host sync, so two
    identical passes agree bit for bit; on the CPU it equals
    ``F.embedding``'s backward bit for bit."""
    ids = indices.reshape(-1).long()
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(n_rows + 1, device=ids.device))
    rows = grad_rows.reshape(ids.numel(), -1)[order]
    return torch.segment_reduce(rows, "sum", offsets=bounds, axis=0,
                                unsafe=True)


class _BagSums(torch.autograd.Function):
    """Fixed-size sum bags over T tables, ids (B, T, L): one table-batched
    K6 launch (or its plain version) forward, (B, T, D) float32; backward,
    each table's dense gradient of the reference's take."""

    @staticmethod
    def forward(ctx, ids, plain: bool, *tables):
        ctx.save_for_backward(ids)
        ctx.tables = [(t.shape[0], t.dtype) for t in tables]
        # meta tensors (the mesh dry-run) carry shapes only: the plain
        # version's ops give the output's, and no kernel has a meta route
        fn = (eb_ref.embedding_bags_plain
              if plain or ids.device.type == "meta" else eb_ops.embedding_bags)
        return fn(tables, ids)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        b, _, n_len = ids.shape
        grads = [
            _dense_grad(grad[:, t].to(dtype)[:, None, :].expand(
                b, n_len, grad.shape[-1]), ids[:, t], n_rows)
            if ctx.needs_input_grad[2 + t] else None
            for t, (n_rows, dtype) in enumerate(ctx.tables)]
        return (None, None, *grads)


def embedding_bag(table, indices, offsets=None, weights=None, mode="sum", *,
                  lookup: str = "kernel"):
    """``torch.nn.EmbeddingBag`` semantics, as the reference's.

    table: (V, D).  With ``offsets=None``, indices is (B, L) (fixed-size
    bags); otherwise indices is flat (N,) and offsets (B,) marks bag
    starts.  ``mode`` is "sum" or "mean".  Fixed bags without weights run
    K6 (``lookup="plain"``: its plain version) and come back in the
    table's dtype; weighted and offset bags are plain PyTorch, as the
    reference's take + ``segment_sum`` are, with a fixed-order segment sum.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if lookup not in LOOKUPS:
        raise ValueError(f"lookup must be one of {LOOKUPS}, got {lookup!r}")
    if offsets is None:
        if weights is None:
            idx = indices if indices.dtype == torch.int32 else indices.int()
            out = _BagSums.apply(idx[:, None, :], lookup == "plain",
                                 table)[:, 0].to(table.dtype)
        else:
            rows = F.embedding(indices, table) * weights[..., None]
            out = torch.sum(rows, dim=1)
        if mode == "mean":
            out = out / indices.shape[1]
        return out
    n, b = indices.shape[0], offsets.shape[0]
    # Bag id of every element; ids before the first offset are -1 and
    # dropped, as segment_sum drops them; an offset of N starts no element.
    starts = torch.bincount(offsets.long(), minlength=n)[:n]
    seg = torch.cumsum(starts, 0) - 1
    rows = F.embedding(indices, table)
    if weights is not None:
        rows = rows * weights[:, None]
    keep = seg >= 0
    lengths = torch.bincount(seg[keep], minlength=b)
    out = torch.segment_reduce(rows[keep], "sum", lengths=lengths, axis=0)
    if mode == "mean":
        out = out / torch.clamp(lengths.float(), min=1.0)[:, None]
    return out


# ------------------------------------------------- sharded embedding lookup
def sharded_embedding_lookup(tables, ids, *, lookup: str = "kernel",
                             chunk: int = 65536):
    """tables: list of (V_i_padded, D) of one dtype; ids: (B, n_fields)
    int -> (B, n_fields, D) in the tables' dtype.

    With no activation-sharding context: one K6 launch, a bag of one row
    per field (see the module docstring).  Under ``act.activate(mesh)``:
    the reference's PS-style model-parallel lookup.  The tables are
    row-sharded over the full mesh (DTensors, or full tensors taken as
    replicated and sliced locally) and the ids replicated; each rank
    offsets the ids by ``flat_rank * V_loc``, clamps them into its shard
    (K6 reads its ids unchecked and must never see one outside the
    shard), runs one table-batched K6 launch over its shards, zeroes the
    rows it does not own, and a reduce-scatter over the group of every
    axis sums the partials and leaves the result row-sharded, constrained
    to the data axes at the end.  Batches over ``chunk`` rows pad to a
    whole number of chunks and run chunk by chunk (the reference's
    ``lax.map``); the batch is permuted first so that each rank's rows of
    the chunks line up as one contiguous block of the result.
    """
    if lookup not in LOOKUPS:
        raise ValueError(f"lookup must be one of {LOOKUPS}, got {lookup!r}")
    ctx = act._current()
    if ctx is None:
        ids = ids if ids.dtype == torch.int32 else ids.int()
        return _BagSums.apply(ids[:, :, None], lookup == "plain",
                              *tables).to(tables[0].dtype)
    mesh = ctx["mesh"]
    n_dev = mesh.size()
    group = act.world_group(mesh)
    flat = act.flat_rank(mesh)
    rows = [Shard(0)] * mesh.ndim
    rep = [Replicate()] * mesh.ndim
    tables_loc = [act.local_in(t, mesh, rows) for t in tables]
    ids_rep = act.local_in(ids, mesh, rep)
    ids_rep = ids_rep if ids_rep.dtype == torch.int32 else ids_rep.int()
    b, n_fields = ids_rep.shape
    d = tables_loc[0].shape[1]

    # reduce-scatter needs the batch (or the chunk) divisible by the
    # device count; large batches pad to a whole number of chunks.
    pad_unit = chunk if b > chunk else n_dev
    pad = (-b) % pad_unit
    if pad:
        ids_rep = torch.cat([ids_rep, ids_rep.new_zeros((pad, n_fields))])
    bp = b + pad
    n_chunks = bp // chunk if (bp > chunk and bp % chunk == 0) else 1
    rows_c = bp // n_chunks
    # chunk c holds, for rank r, the rows r * bp/n + c * rows_c/n onwards
    ids_c = ids_rep.reshape(n_dev, n_chunks, rows_c // n_dev,
                            n_fields).transpose(0, 1).reshape(
                                n_chunks, rows_c, n_fields)
    vloc = torch.tensor([t.shape[0] for t in tables_loc], dtype=torch.int32,
                        device=ids_rep.device)
    outs = []
    for c in range(n_chunks):
        local = ids_c[c] - flat * vloc
        ok = (local >= 0) & (local < vloc)
        local = torch.minimum(torch.clamp(local, min=0), vloc - 1)
        part = _BagSums.apply(local[:, :, None], lookup == "plain",
                              *tables_loc).to(tables_loc[0].dtype)
        part = part * ok[:, :, None].to(part.dtype)
        outs.append(funcol.wait_tensor(funcol.reduce_scatter_tensor_autograd(
            part, "sum", 0, group)))
    out = outs[0] if n_chunks == 1 else torch.cat(outs)
    out = act.local_out(out, mesh, rows, (bp, n_fields, d))
    if pad:
        out = out[:b]
    return act.constrain(out, "dp", None, None)


def pad_vocab(v: int, multiple: int = 512) -> int:
    """Row-shardable table size (rows padded up; ids never reach padding)."""
    return -(-v // multiple) * multiple


def _bce_with_logits(logits, labels):
    y = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _init_mlp(gen, dims: Sequence[int], dtype, device):
    ws = [((dims[i] ** -0.5) * torch.randn((dims[i], dims[i + 1]),
                                           generator=gen, device=device))
          for i in range(len(dims) - 1)]
    return {
        "w": [w.to(dtype) for w in ws],
        "b": [torch.zeros((dims[i + 1],), dtype=dtype, device=device)
              for i in range(len(dims) - 1)],
    }


# ======================================================================= DLRM
@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    vocab_sizes: Tuple[int, ...] = ()
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def n_features(self) -> int:
        return self.n_sparse + 1  # embeddings + bottom-MLP output

    @property
    def n_pairs(self) -> int:
        f = self.n_features
        return f * (f - 1) // 2

    @property
    def table_rows(self) -> int:
        return sum(pad_vocab(v) for v in self.vocab_sizes)


def dlrm_init(cfg: DLRMConfig, generator: Optional[torch.Generator] = None,
              device=None) -> Dict:
    """The reference's tree (``tables`` list, ``bot``/``top`` MLPs with
    ``w``/``b`` lists), drawn from ``generator`` (seed 0 if None) on
    ``device`` (the card unless ``"cpu"``)."""
    if len(cfg.vocab_sizes) != cfg.n_sparse:
        raise ValueError(f"{len(cfg.vocab_sizes)} vocab sizes for "
                         f"{cfg.n_sparse} sparse fields")
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    dt = cfg.torch_dtype
    # Rows padded to a shardable multiple; ids never reach the padding.
    tables = [normal_init(gen, (pad_vocab(v), cfg.embed_dim),
                          1.0 / math.sqrt(float(v)), dt, dev)
              for v in cfg.vocab_sizes]
    top_in = cfg.bot_mlp[-1] + cfg.n_pairs
    return {
        "tables": tables,
        "bot": _init_mlp(gen, (cfg.n_dense,) + cfg.bot_mlp, dt, dev),
        "top": _init_mlp(gen, (top_in,) + cfg.top_mlp, dt, dev),
    }


def dlrm_forward(cfg: DLRMConfig, params, dense, sparse_ids, *,
                 lookup: str = "kernel"):
    """dense: (B, n_dense) float; sparse_ids: (B, n_sparse) int -> logits
    (B,).  ``lookup="plain"``: the lookups through K6's plain version."""
    dt = cfg.torch_dtype
    bot = mlp(dense.to(dt), params["bot"]["w"], params["bot"]["b"])
    embs = sharded_embedding_lookup(params["tables"], sparse_ids,
                                    lookup=lookup)  # (B, n_sparse, D)
    z = torch.cat([bot[:, None, :], embs], dim=1)  # (B, F, D)
    # the dot interaction, row by row (under a mesh on each device's rows)
    pairs = act.per_device(_interact, ("dp",), z)  # (B, F*(F-1)/2)
    top_in = torch.cat([bot, pairs.to(dt)], dim=1)
    logit = mlp(top_in, params["top"]["w"], params["top"]["b"])
    return logit[:, 0]


def _interact(z):
    """(B, F, D) -> (B, F*(F-1)/2): the row-major upper triangle of each
    row's Gram matrix."""
    inter = torch.bmm(z, z.transpose(1, 2))  # (B, F, F)
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=z.device)  # row-major
    return inter[:, iu, ju]


def dlrm_loss(cfg: DLRMConfig, params, batch, *, lookup: str = "kernel"):
    logits = dlrm_forward(cfg, params, batch["dense"], batch["sparse"],
                          lookup=lookup).float()
    return _bce_with_logits(logits, batch["labels"])


def dlrm_retrieval(cfg: DLRMConfig, params, dense_1, user_sparse,
                   candidate_ids):
    """Score one user against N candidate items (retrieval_cand shape).

    dense_1: (1, n_dense); user_sparse: (1, n_sparse - 1) fixed user
    fields; candidate_ids: (N,) ids into the LAST table (the item table).
    """
    n = candidate_ids.shape[0]
    dense = dense_1.expand(n, cfg.n_dense)
    user = user_sparse.expand(n, cfg.n_sparse - 1)
    sparse = torch.cat([user, candidate_ids[:, None].to(user.dtype)], dim=1)
    return dlrm_forward(cfg, params, dense, sparse)


# ===================================================================== SASRec
@dataclass(frozen=True)
class SASRecConfig:
    name: str
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def sasrec_init(cfg: SASRecConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    dt, d = cfg.torch_dtype, cfg.embed_dim
    s = d ** -0.5

    def w():
        return (s * torch.randn((d, d), generator=gen, device=dev)).to(dt)

    def vec(value, dtype=torch.float32):
        return torch.full((d,), value, dtype=dtype, device=dev)

    blocks = [{
        "ln1_g": vec(1.0), "ln1_b": vec(0.0),
        "w_q": w(), "w_k": w(), "w_v": w(), "w_o": w(),
        "ln2_g": vec(1.0), "ln2_b": vec(0.0),
        "w_ff1": w(), "b_ff1": vec(0.0, dt),
        "w_ff2": w(), "b_ff2": vec(0.0, dt),
    } for _ in range(cfg.n_blocks)]
    return {
        "item_emb": normal_init(gen, (cfg.n_items, d), 0.02, dt, dev),
        "pos_emb": normal_init(gen, (cfg.seq_len, d), 0.02, dt, dev),
        "blocks": blocks,
        "final_ln_g": vec(1.0),
        "final_ln_b": vec(0.0),
    }


def _ln(x, g, b, eps=1e-6):
    m = torch.mean(x, -1, keepdim=True)
    v = torch.mean(torch.square(x - m), -1, keepdim=True)
    return ((x - m) * torch.rsqrt(v + eps)) * g + b


def sasrec_states(cfg: SASRecConfig, params, item_seq):
    """item_seq: (B, S) int (0 = padding) -> hidden states (B, S, D)."""
    b, s = item_seq.shape
    h = F.embedding(item_seq, params["item_emb"]) + params["pos_emb"][None, :s]
    h = h * (item_seq != 0)[..., None].to(h.dtype)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=h.device))
    scale = math.sqrt(float(cfg.embed_dim))
    for blk in params["blocks"]:
        q = _ln(h, blk["ln1_g"], blk["ln1_b"]).to(h.dtype)
        scores = torch.einsum("bqd,bkd->bqk", q @ blk["w_q"], h @ blk["w_k"])
        scores = scores / scale
        scores = torch.where(causal[None], scores.float(), -1e30)
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        att = torch.einsum("bqk,bkd->bqd", probs, h @ blk["w_v"]) @ blk["w_o"]
        h = h + att
        f = _ln(h, blk["ln2_g"], blk["ln2_b"]).to(h.dtype)
        h = (h + torch.relu(f @ blk["w_ff1"] + blk["b_ff1"]) @ blk["w_ff2"]
             + blk["b_ff2"])
    return _ln(h, params["final_ln_g"], params["final_ln_b"]).to(h.dtype)


def sasrec_loss(cfg: SASRecConfig, params, batch):
    """batch: seq (B,S), pos (B,S) next items, neg (B,S) sampled
    negatives.  BCE over positive/negative next-item scores."""
    h = sasrec_states(cfg, params, batch["seq"])
    pos_e = F.embedding(batch["pos"], params["item_emb"])
    neg_e = F.embedding(batch["neg"], params["item_emb"])
    pos_s = torch.sum(h * pos_e, -1).float()
    neg_s = torch.sum(h * neg_e, -1).float()
    mask = (batch["pos"] != 0).float()
    loss = (-torch.log(torch.sigmoid(pos_s) + 1e-12)
            - torch.log(1 - torch.sigmoid(neg_s) + 1e-12))
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)


def sasrec_retrieval(cfg: SASRecConfig, params, item_seq, candidate_ids):
    """(B, S) history x (N,) candidates -> (B, N) scores."""
    h = sasrec_states(cfg, params, item_seq)[:, -1]  # (B, D)
    cand = F.embedding(candidate_ids, params["item_emb"])  # (N, D)
    return h @ cand.T


# ======================================================================= DIEN
@dataclass(frozen=True)
class DIENConfig:
    name: str
    n_items: int = 1_000_000
    n_cats: int = 10_000
    embed_dim: int = 18  # per field; item + category -> 36
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: Tuple[int, ...] = (200, 80)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def d_in(self) -> int:
        return 2 * self.embed_dim  # item emb + category emb


def _gru_params(gen, d_in, d_h, dtype, device):
    s = (d_in + d_h) ** -0.5

    def w():
        return (s * torch.randn((d_in + d_h, d_h), generator=gen,
                                device=device)).to(dtype)

    def zeros():
        return torch.zeros((d_h,), dtype=dtype, device=device)

    return {"wz": w(), "wr": w(), "wh": w(), "bz": zeros(), "br": zeros(),
            "bh": zeros()}


def _gru_cell(p, h, x, att=None):
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"])
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xh2 = torch.cat([x, r * h], dim=-1)
    h_tilde = torch.tanh(xh2 @ p["wh"] + p["bh"])
    if att is not None:  # AUGRU: attention scales the update gate
        z = z * att[:, None]
    return (1 - z) * h + z * h_tilde


def dien_init(cfg: DIENConfig, generator: Optional[torch.Generator] = None,
              device=None) -> Dict:
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    dt = cfg.torch_dtype
    att_in = cfg.gru_dim + cfg.d_in
    return {
        "item_emb": normal_init(gen, (cfg.n_items, cfg.embed_dim), 0.02, dt,
                                dev),
        "cat_emb": normal_init(gen, (cfg.n_cats, cfg.embed_dim), 0.02, dt,
                               dev),
        "gru1": _gru_params(gen, cfg.d_in, cfg.gru_dim, dt, dev),
        "augru": _gru_params(gen, cfg.gru_dim, cfg.gru_dim, dt, dev),
        "att": _init_mlp(gen, (att_in, 80, 1), dt, dev),
        "head": _init_mlp(gen, (cfg.gru_dim + 2 * cfg.d_in,) + cfg.mlp_dims
                          + (1,), dt, dev),
    }


def _embed_pair(params, items, cats):
    # under a mesh each row-sharded lookup is reduced before the concat
    # (DTensor cannot join the pending sums of two tables)
    return torch.cat([act.constrain(F.embedding(items, params["item_emb"]),
                                    "dp"),
                      act.constrain(F.embedding(cats, params["cat_emb"]),
                                    "dp")], dim=-1)


def dien_forward(cfg: DIENConfig, params, batch):
    """batch: hist_items/hist_cats (B,S), target_item/target_cat (B,) ->
    logits (B,).  Interest extraction GRU -> target attention -> AUGRU."""
    hist = _embed_pair(params, batch["hist_items"], batch["hist_cats"])
    target = _embed_pair(params, batch["target_item"], batch["target_cat"])
    b, s, _ = hist.shape
    h0 = torch.zeros((b, cfg.gru_dim), dtype=hist.dtype, device=hist.device)
    h, states = h0, []
    for t in range(s):
        h = _gru_cell(params["gru1"], h, hist[:, t])
        states.append(h)
    states = torch.stack(states, dim=0)  # (S, B, H)
    # Attention of each interest state vs the target ad.
    tgt = target[None].expand(s, b, cfg.d_in)
    att_in = torch.cat([states, tgt], dim=-1)
    scores = mlp(att_in, params["att"]["w"], params["att"]["b"])[..., 0]
    att = torch.softmax(scores.float(), dim=0).to(hist.dtype)  # (S, B)
    h = h0
    for t in range(s):
        h = _gru_cell(params["augru"], h, states[t], att=att[t])
    hist_mean = torch.mean(hist, dim=1)
    head_in = torch.cat([h, target, hist_mean], dim=-1)
    return mlp(head_in, params["head"]["w"], params["head"]["b"])[:, 0]


def dien_loss(cfg: DIENConfig, params, batch):
    logits = dien_forward(cfg, params, batch).float()
    return _bce_with_logits(logits, batch["labels"])


def dien_retrieval(cfg: DIENConfig, params, hist_items, hist_cats, cand_items,
                   cand_cats):
    """1 user x N candidates: shared interest GRU, per-candidate AUGRU."""
    n = cand_items.shape[0]
    batch = {
        "hist_items": hist_items.expand(n, hist_items.shape[-1]),
        "hist_cats": hist_cats.expand(n, hist_cats.shape[-1]),
        "target_item": cand_items,
        "target_cat": cand_cats,
    }
    return dien_forward(cfg, params, batch)


def make_train_step(loss, optimizer):
    """Generic recsys train step from a ``loss(params, batch)`` closure:
    train_step(state, batch) -> (state, {"loss"})."""
    grad_fn = value_and_grad(loss)

    def train_step(state, batch):
        loss_value, grads = grad_fn(state["params"], batch)
        new_params, new_opt = optimizer.step(state["params"], grads,
                                             state["opt"])
        return {"params": new_params, "opt": new_opt}, {"loss": loss_value}

    return train_step
