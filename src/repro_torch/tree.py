"""Parameter trees: nested dicts / lists / tuples of tensors.

Leaf keys are the reference's (``repro.ps.runtime._leaf_key``): dict keys,
sorted as JAX flattens them, and list indices, joined by ``/``.  So one
plan lays out both packages lane for lane, and weights carry across by
key.  :func:`value_and_grad` is the port's ``jax.value_and_grad`` over a
tree's first argument.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


def _leaf_key(path) -> str:
    """Dict keys and list indices joined by ``/`` (``runtime.py:72``)."""
    return "/".join(str(p) for p in path)


def _tree_items(tree, path=()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_leaves_by_key(tree) -> Dict[str, Any]:
    return {_leaf_key(p): leaf for p, leaf in _tree_items(tree)}


def tree_leaves(tree) -> List[Any]:
    """Leaves in flatten order."""
    return [leaf for _, leaf in _tree_items(tree)]


def tree_map(fn: Callable[[Any], Any], tree):
    """Same structure, ``fn(leaf)`` at every leaf."""
    return _tree_rebuild(tree, lambda key, leaf: fn(leaf))


def _tree_rebuild(tree, fn: Callable[[str, Any], Any], path=()):
    """Same structure, ``fn(leaf_key, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _tree_rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_tree_rebuild(v, fn, path + (i,)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(_leaf_key(path), tree)


def tree_with_leaves(tree, by_key: Dict[str, Any]):
    """``tree``'s structure with the leaves of ``by_key`` (by leaf key)."""
    return _tree_rebuild(tree, lambda key, _: by_key[key])


def abstract_tree(tree):
    """Shape/dtype skeleton of a parameter tree (``meta`` tensors)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def array_to_tensor(x) -> torch.Tensor:
    """A reference array (numpy or jax) as a CPU tensor, bit for bit.
    bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    rejects) cross as their 16-bit pattern."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def cache_from_numpy(cache, device):
    """A reference KV-cache tree (numpy or jax arrays, bfloat16 included)
    as the port's: every array a tensor on ``device``, bit for bit, and
    ``"length"`` (the reference's int32 scalar) a host int."""
    return {k: (int(np.asarray(v)) if k == "length"
                else tree_map(lambda x: array_to_tensor(x).to(device), v))
            for k, v in cache.items()}


def value_and_grad(fn: Callable[..., torch.Tensor]):
    """``jax.value_and_grad(fn)`` for a tree first argument: returns
    ``(loss, grads)`` with grads in the tree's structure.  Built on
    ``torch.autograd.grad``, which composes with
    ``torch.utils.checkpoint`` (the transformer's remat).  The leaves are
    detached aliases of the caller's tensors: no copy, and the caller's
    tensors stay free of autograd state."""

    def wrapped(params, *args):
        keys, leaves = [], []
        for path, leaf in _tree_items(params):
            keys.append(_leaf_key(path))
            leaves.append(leaf.detach().requires_grad_(True))
        with torch.enable_grad():
            loss = fn(tree_with_leaves(params, dict(zip(keys, leaves))),
                      *args)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), tree_with_leaves(params, {
            k: torch.zeros_like(l) if g is None else g
            for k, l, g in zip(keys, leaves, grads)})

    return wrapped
