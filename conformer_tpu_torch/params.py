"""Weights bridge: the JAX package's parameter pytree and its ``.npz`` file
as nested dicts of torch tensors.

The port keeps the JAX layouts unchanged (dense kernels [in, out], encoder
layers stacked on a leading [L] axis, ``pos_table`` [2*max_len-1, D],
depthwise kernels [L, K, 1, D], the predictor's ``rnn`` as a list of
per-layer dicts, the attention decoder's layers stacked on [L]), so a JAX
tree carries over leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def from_jax_params(tree: Any, device=None) -> Any:
    """JAX params (nested dicts and lists of numpy or array-like leaves)
    -> the same nesting of torch tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def _parse_key(key: str) -> list:
    """'predictor/rnn#0/w_ih' -> ['predictor', 'rnn', 0, 'w_ih']."""
    parts: list = []
    for seg in key.split("/"):
        name, *idx = seg.split("#")
        parts.append(name)
        parts.extend(int(i) for i in idx)
    return parts


def _lists(node: Any) -> Any:
    """Turn every dict whose keys are all ints into a list in index order."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"list indices {sorted(out)} are not 0..n-1")
        return [out[i] for i in range(len(out))]
    return out


def load_jax_npz(path: str, device=None) -> dict:
    """Read the JAX ``save_params_npz`` format (``/`` nesting, ``name#i``
    list segments) into nested dicts and lists of tensors. The nesting is
    built from the keys alone, whatever their order in the file."""
    root: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *path_parts, leaf = _parse_key(key)
            node = root
            for part in path_parts:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise ValueError(f"key {key!r} nests under a leaf")
            if leaf in node:
                raise ValueError(f"duplicate key {key!r}")
            node[leaf] = z[key]
    return from_jax_params(_lists(root), device)
