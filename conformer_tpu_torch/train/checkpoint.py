"""Checkpoints of the port's trainer (the JAX package's
``train/checkpoint.py``), with ``torch.save`` in place of Orbax.

Under the JAX naming: a checkpoint ``step_{n}`` or, after a validation,
``step_{n}-wer_{x:.6f}`` holds the train state {params, opt_state, step};
``params_last`` holds the params alone, for serving; the file ``last``
names the newest checkpoint; all but the newest ``keep`` are removed. Each
is one file, written to a temporary name and renamed, so a crash never
leaves half a checkpoint under a real name. Tensors are saved on the CPU
and loaded with ``weights_only=True``.

``save_params_npz`` and ``load_params_npz`` write and read the JAX
package's ``.npz`` layout, so the two packages exchange weights both ways.
Orbax restore and the WeNet state-dict import are not ported yet
(ROADMAP.md queue A, item 7).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from ..params import load_jax_npz, tree_map


def _save(obj: Any, path: str) -> None:
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: dict, *, step: int, wer: float | None = None,
                    keep: int = 5) -> str:
    """Save the train state {params, opt_state, step}; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step}" + (f"-wer_{wer:.6f}" if wer is not None else "")
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    state = tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t, state)
    _save(state, path)
    _save(state["params"], os.path.join(ckpt_dir, "params_last"))
    tmp = os.path.join(ckpt_dir, ".last.tmp")
    with open(tmp, "w") as f:
        f.write(name)
    os.replace(tmp, os.path.join(ckpt_dir, "last"))
    _gc_checkpoints(ckpt_dir, keep)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The checkpoint ``last`` names, else the one of the highest step."""
    last = os.path.join(ckpt_dir, "last")
    if os.path.exists(last):
        with open(last) as f:
            path = os.path.join(ckpt_dir, f.read().strip())
        if os.path.exists(path):
            return os.path.abspath(path)
    cands = _list_checkpoints(ckpt_dir)
    return cands[-1][1] if cands else None


def restore_checkpoint(path: str, device=None) -> dict:
    """The train state saved at ``path``, its tensors on ``device``."""
    return torch.load(path, map_location=device, weights_only=True)


def restore_params(path_or_dir: str, device=None) -> Any:
    """Params for serving: a directory resolves to its ``params_last``."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "params_last")
    return torch.load(path, map_location=device, weights_only=True)


def _list_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def _gc_checkpoints(ckpt_dir: str, keep: int) -> None:
    for _, path in _list_checkpoints(ckpt_dir)[:-keep] if keep > 0 else []:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            os.remove(path)


def save_params_npz(path: str, params: Any) -> None:
    """Params tree -> one compressed ``.npz`` in the JAX layout: ``/``
    between dict keys, ``name#i`` for list items."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}#{i}", v)
        else:
            flat[prefix] = (node.detach().cpu().numpy() if torch.is_tensor(node)
                            else np.asarray(node))

    walk("", params)
    np.savez_compressed(path, **flat)


def load_params_npz(path: str, device=None) -> dict:
    """Inverse of ``save_params_npz`` (and reader of the JAX package's)."""
    return load_jax_npz(path, device)
