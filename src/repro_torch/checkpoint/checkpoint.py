"""Fault-tolerant checkpoints in the reference's on-disk format (PyTorch).

The counterpart of ``repro.checkpoint``.  A step directory
``step_{step:08d}`` holds one ``leaf_{i:05d}.npy`` per leaf, a
``manifest.json`` (leaf key -> file, shape, dtype, SHA-256) and an
optional ``aux.json``; it is written as ``step_XXXXXXXX.tmp``, fsynced
and renamed, so a crashed save never shadows a good checkpoint, and
``keep_last`` prunes older steps after a commit.  Leaf keys and file
order are the reference's for the same tree (dict keys sorted, list
indices, NamedTuple fields as ``.name``), so either package restores the
other's checkpoints:

  * float32 / int32 / ... leaves are ``np.save`` files;
  * a bfloat16 leaf is written as the reference writes it, a ``<V2``
    ``.npy`` with ``"dtype": "bfloat16"`` in the manifest, and read back
    through its 16-bit pattern (no ``ml_dtypes`` needed);
  * a Python int leaf (a step counter) is an int32 scalar, as the
    reference's counters are, and restores as an int.

``save_ps_checkpoint`` / ``restore_ps_checkpoint`` commit a shared flat
state with its FlatPlan and restore it onto another plan through the
delta path (K2); ``save_sharded_checkpoint`` /
``restore_sharded_checkpoint`` do the same for a sharded fleet, a saved
fleet of N shards restoring onto M through ``migrate_sharded_state``.
:class:`CheckpointManager` saves in a background thread from host copies
that are finished before ``maybe_save`` returns (the port's applies write
in place, so the thread must never read live state).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

MANIFEST = "manifest.json"
AUX = "aux.json"  # side-channel metadata committed atomically with the step

_TORCH_OF_NAME = {"float32": torch.float32, "float64": torch.float64,
                  "float16": torch.float16, "bfloat16": torch.bfloat16,
                  "int8": torch.int8, "int16": torch.int16,
                  "int32": torch.int32, "int64": torch.int64,
                  "uint8": torch.uint8, "bool": torch.bool}


# ------------------------------------------------------------------ trees
def _items(tree, path=()) -> Iterator[Tuple[str, Any]]:
    """(leaf key, leaf) in ``jax.tree_util``'s flatten order, keys as the
    reference's ``_leaf_key`` writes them.  ``None`` holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _rebuild(tree, leaves: Dict[str, Any], path=()):
    """``tree``'s structure with the leaves of ``leaves`` (by key)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves,
                                     path + (f".{n}",))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return leaves["/".join(path)]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to write, manifest dtype name) of one leaf.  A
    bfloat16 tensor becomes its 16-bit pattern (written as ``<V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
    elif isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, (int, np.integer)) and not isinstance(
            leaf, np.ndarray):
        if not -2**31 <= int(leaf) < 2**31:
            raise ValueError(f"int leaf {leaf} does not fit int32")
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npy(path: Path, arr: np.ndarray, dtype_name: str) -> None:
    if dtype_name != "bfloat16":
        np.save(path, arr, allow_pickle=False)
        return
    with open(path, "wb") as f:  # the reference's bytes: a '<V2' array
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _read_leaf(path: Path, entry: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(path, allow_pickle=False)
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


# ------------------------------------------------------------- save/restore
def save_checkpoint(directory, step: int, tree, keep_last: Optional[int] = None,
                    verify: bool = True, aux: Optional[Dict[str, Any]] = None
                    ) -> Path:
    """Atomically save ``tree`` under ``directory/step_{step:08d}``.

    ``aux`` is JSON metadata committed in the same rename as the leaves.
    ``verify=False`` writes no hashes (a restore then checks none)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: Dict[str, Any] = {"step": step, "created": time.time(),
                                "leaves": {}}
    for i, (key, leaf) in enumerate(_items(tree)):
        arr, dtype_name = _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        _write_npy(tmp / fname, arr, dtype_name)
        digest = (hashlib.sha256((tmp / fname).read_bytes()).hexdigest()
                  if verify else "")
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype_name, "sha256": digest}
        del arr
    if aux is not None:
        (tmp / AUX).write_text(json.dumps(aux))
        with open(tmp / AUX, "rb") as f:
            os.fsync(f.fileno())
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    with open(tmp / MANIFEST, "rb") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep_last is not None:
        for old in all_steps(directory)[:-keep_last]:
            shutil.rmtree(directory / f"step_{old:08d}", ignore_errors=True)
    return final


def all_steps(directory) -> List[int]:
    """The committed steps under ``directory`` (those with a manifest)."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(int(p.name[5:]) for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp")
                  and (p / MANIFEST).exists())


def latest_step(directory) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _manifest(directory, step: int) -> Dict[str, Any]:
    return json.loads((Path(directory) / f"step_{step:08d}" / MANIFEST)
                      .read_text())


def restore_checkpoint(directory, step: int, abstract_tree, device=None,
                       verify: bool = True):
    """Restore into the structure of ``abstract_tree``, whose leaves give
    the shapes (tensors, ``device="meta"`` ones included, or anything
    with ``.shape``; an int leaf restores as an int).  Tensors land on
    ``device`` (``cuda:0`` unless given) in the saved dtype.  Raises on a
    missing leaf, a shape mismatch or, with ``verify``, a hash
    mismatch."""
    device = resolve_device(device)
    step_dir = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((step_dir / MANIFEST).read_text())
    out = {}
    for key, leaf in _items(abstract_tree):
        entry = manifest["leaves"].get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        fpath = step_dir / entry["file"]
        if verify and entry["sha256"]:
            if hashlib.sha256(fpath.read_bytes()).hexdigest() != \
                    entry["sha256"]:
                raise IOError(f"checksum mismatch for {key} in {step_dir}")
        t = _read_leaf(fpath, entry)
        want = () if isinstance(leaf, int) else tuple(leaf.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(t.shape)} vs model {want}")
        out[key] = int(t) if isinstance(leaf, int) else t.to(device)
    return _rebuild(abstract_tree, out)


def load_aux(directory, step: int) -> Optional[Dict[str, Any]]:
    """The aux metadata committed with a step (None if absent)."""
    path = Path(directory) / f"step_{step:08d}" / AUX
    if not path.exists():
        return None
    return json.loads(path.read_text())


def _abstract_from_manifest(manifest) -> Dict[str, Any]:
    """The nested-dict structure of a manifest's leaf keys, with ``meta``
    tensors of the saved shapes and dtypes as leaves."""
    root: Dict[str, Any] = {}
    for key, entry in manifest["leaves"].items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.empty(tuple(entry["shape"]),
                                   dtype=_TORCH_OF_NAME[entry["dtype"]],
                                   device="meta")
    return root


def _counts_out(counts: Dict[str, Any]) -> Dict[str, int]:
    return {j: int(c) for j, c in counts.items()}


# ------------------------------------------------------------- PS states
def save_ps_checkpoint(directory, step: int, plan, state,
                       keep_last: Optional[int] = None,
                       verify: bool = True) -> Path:
    """Save a (FlatPlan, flat state) pair atomically: the state's leaves
    (flat, mu, nu, ef, the counters as int32) and the plan in aux."""
    from ..ps.plan import plan_to_json

    return save_checkpoint(directory, step, state, keep_last, verify,
                           aux={"plan": plan_to_json(plan)})


def restore_ps_checkpoint(directory, step: int, plan=None,
                          verify: bool = True, device=None):
    """Restore a PS checkpoint; returns ``(plan, state)``, the counters as
    ints.  With ``plan`` given and different from the saved one, the
    state migrates onto it through the delta path (K2 on the card), so a
    checkpoint taken under one packing restores under another."""
    from ..ps.elastic import migrate_flat_state_delta
    from ..ps.plan import plan_from_json

    aux = load_aux(directory, step)
    if aux is None or "plan" not in aux:
        raise IOError(f"step {step} in {directory} is not a PS checkpoint")
    saved_plan = plan_from_json(aux["plan"])
    abstract = _abstract_from_manifest(_manifest(directory, step))
    state = restore_checkpoint(directory, step, abstract, device=device,
                               verify=verify)
    if "count" in state:
        state["count"] = int(state["count"])
    else:
        state["counts"] = _counts_out(state.get("counts", {}))
    if plan is not None and plan != saved_plan:
        return plan, migrate_flat_state_delta(state, saved_plan, plan)
    return saved_plan, state


# -------------------------------------------------------- sharded fleets
def save_sharded_checkpoint(directory, step: int, splan, states, counts,
                            keep_last: Optional[int] = None,
                            verify: bool = True,
                            extra_aux: Optional[Dict[str, Any]] = None
                            ) -> Path:
    """Save a sharded fleet in one atomic commit: the ShardedPlan, every
    shard space's leaves (``agg_id`` -> flat/mu/nu[/ef]) and the per-job
    step counts (int32).  ``extra_aux`` merges JSON metadata into the aux
    record (the runtime stamps ``shard_health``); reserved keys are
    refused."""
    from ..ps.plan import sharded_plan_to_json

    tree = {"shards": dict(states),
            "counts": {j: int(c) for j, c in counts.items()}}
    aux = {"sharded_plan": sharded_plan_to_json(splan),
           "shard_leaves": {sid: sorted(st) for sid, st in states.items()},
           "jobs": sorted(counts)}
    if extra_aux:
        clash = sorted(set(extra_aux) & set(aux))
        if clash:
            raise ValueError(f"extra_aux may not override reserved aux "
                             f"keys {clash}")
        aux.update(extra_aux)
    return save_checkpoint(directory, step, tree, keep_last, verify, aux=aux)


def restore_sharded_checkpoint(directory, step: int, splan=None,
                               verify: bool = True, device=None, out=None):
    """Restore a sharded checkpoint; returns ``(splan, states, counts)``,
    the counts as ints.

    With ``splan`` given and different from the saved shard map, the
    states migrate onto it through ``migrate_sharded_state`` (each
    surviving shard's delta through K2), the elastic restart.  With
    ``out`` (``agg_id`` -> the destination leaves of ``splan``'s shards,
    e.g. views of a runtime's fleet arena) the restored values are
    written INTO those tensors, a saved leaf that a destination lacks
    skipped and a destination leaf the checkpoint lacks zeroed, and
    ``out`` is returned as the states.  The restore tree is built from
    the saved plan, so ``agg_id``s with ``/`` in them round-trip."""
    from ..ps.elastic import migrate_sharded_state
    from ..ps.plan import sharded_plan_from_json

    aux = load_aux(directory, step)
    if aux is None or "sharded_plan" not in aux:
        raise IOError(f"step {step} in {directory} is not a sharded "
                      f"PS checkpoint")
    saved_plan = sharded_plan_from_json(aux["sharded_plan"])
    abstract = {
        "shards": {sid: {k: torch.empty(sp.total_len, device="meta")
                         for k in aux["shard_leaves"][sid]}
                   for sid, sp in zip(saved_plan.shard_ids,
                                      saved_plan.shards)},
        "counts": {j: 0 for j in aux["jobs"]},
    }
    migrate = splan is not None and splan != saved_plan
    # Into ``out`` on the same plan the leaves are staged on the host and
    # copied in, so the device never holds a second copy of the fleet.
    tree = restore_checkpoint(
        directory, step, abstract, verify=verify,
        device="cpu" if out is not None and not migrate else device)
    states, counts = tree["shards"], tree["counts"]
    plan = saved_plan
    if migrate:
        if out is not None:
            for st in out.values():
                for v in st.values():
                    v.zero_()
        states, _, _ = migrate_sharded_state(states, saved_plan, splan,
                                             out=out)
        plan = splan
    elif out is not None:
        for sid, st in out.items():
            for k, v in st.items():
                if k in states[sid]:
                    v.copy_(states[sid][k])
                else:
                    v.zero_()
        states = out
    return plan, states, counts


# ------------------------------------------------------------ train loops
def _host_copy(leaf):
    """A finished host copy of one leaf (never a view of live state)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.to("cpu", copy=True) if t.device.type == "cpu" else t.cpu()
    return leaf


class CheckpointManager:
    """Background saves and restart bookkeeping for a training loop
    (`launch/train.py`)."""

    def __init__(self, directory, keep_last: int = 3, save_every: int = 100):
        self.directory = Path(directory)
        self.keep_last = keep_last
        self.save_every = save_every
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree, blocking: bool = False) -> bool:
        """Save ``tree`` as ``step`` every ``save_every`` steps.  The host
        copies are finished before this returns; only the serialisation
        runs in the background thread (one save in flight at a time)."""
        if step % self.save_every != 0:
            return False
        self.wait()
        host_tree = _rebuild(tree, {k: _host_copy(v)
                                    for k, v in _items(tree)})
        if blocking:
            save_checkpoint(self.directory, step, host_tree, self.keep_last)
            return True
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.directory, step, host_tree, self.keep_last),
            daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, abstract_tree, device=None):
        """``(step, tree)`` of the latest committed step, or ``(None,
        None)``."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, abstract_tree,
                                        device=device)
