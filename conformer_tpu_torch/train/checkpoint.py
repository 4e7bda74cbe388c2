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
``import_torch_checkpoint`` maps a reference / WeNet ``state_dict`` onto a
params tree as JAX's does. Orbax restore is not ported (Orbax imports
JAX).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from ..params import from_jax_params, load_jax_npz, tree_map


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


# --------------------------------------------------- torch / WeNet import


def _torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """The tensors of a saved ``state_dict`` as numpy arrays; a Lightning
    ``.ckpt`` gives its ``state_dict`` with the ``model.`` prefix stripped.
    Loaded with ``weights_only=False``, as JAX loads it: a Lightning file
    holds more than tensors (its hyperparameters, the loops' state), so
    only a file from a trusted source may be given."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = {k.removeprefix("model."): v for k, v in ckpt["state_dict"].items()}
    else:
        sd = ckpt
    return {k: v.detach().numpy() for k, v in sd.items() if hasattr(v, "detach")}


def import_torch_checkpoint(path: str, params: Any, cfg, device=None) -> Any:
    """A copy of ``params`` (tensors, the JAX layout) with the leaves that
    a reference / WeNet state dict at ``path`` names replaced, as JAX's
    ``import_torch_checkpoint``: keys such as
    ``encoder.encoders.{i}.self_attn.linear_q.weight``,
    ``predictor.rnn.weight_ih_l{k}``, ``joint.enc_ffn.weight``,
    ``ctc.ctc_lo.weight``. Linear weights are transposed ([out, in] -> [in,
    out]), Conv2d kernels [O, I, kh, kw] -> [kh, kw, I, O], Conv1d kernels
    [O, I, K] -> [K, I, O], per-layer tensors stacked on [L], BatchNorm's
    running statistics taken where the tree has them. No key maps CMVN.
    Missing keys are listed once and left at their values in ``params``.
    The result lies on ``device``."""
    sd = _torch_state_dict(path)
    p = tree_map(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t),
                 params)
    n_layers = cfg.encoder_num_layers
    missing: list[str] = []

    def take(key, transform=None):
        if key not in sd:
            missing.append(key)
            return None
        return transform(sd[key]) if transform else sd[key]

    def linear(dst, prefix):
        w = take(prefix + ".weight", lambda v: v.T)
        if w is not None:
            dst["kernel"] = w
        if prefix + ".bias" in sd:
            dst["bias"] = sd[prefix + ".bias"]

    def norm(dst, prefix):
        if prefix + ".weight" in sd:
            dst["scale"] = sd[prefix + ".weight"]
        if prefix + ".bias" in sd:
            dst["bias"] = sd[prefix + ".bias"]
        if prefix + ".running_mean" in sd:
            dst["mean"] = sd[prefix + ".running_mean"]
            dst["var"] = sd[prefix + ".running_var"]

    def stack(fmt, transform=lambda v: v):
        return np.stack([transform(sd[fmt.format(i)]) for i in range(n_layers)])

    enc = p["encoder"]
    for i, name in ((0, "conv1"), (2, "conv2")):
        w = take(f"encoder.embed.conv.{i}.weight", lambda v: v.transpose(2, 3, 1, 0))
        if w is not None:
            enc["embed"][name]["kernel"] = w
        b = take(f"encoder.embed.conv.{i}.bias")
        if b is not None:
            enc["embed"][name]["bias"] = b
    linear(enc["embed"]["out"], "encoder.embed.out.0")
    norm(enc["after_norm"], "encoder.after_norm")

    lay = enc["layers"]
    layer = "encoder.encoders.{}."

    def layer_linear(module, name, has_bias=True):
        src = f"{layer}{module}.{name}"
        if (src + ".weight").format(0) not in sd:
            missing.append((src + ".weight").format(0))
            return
        lay[module][name]["kernel"] = stack(src + ".weight", lambda v: v.T)
        if has_bias and (src + ".bias").format(0) in sd:
            lay[module][name]["bias"] = stack(src + ".bias")

    for ffn in ("feed_forward", "feed_forward_macaron"):
        for w in ("w_1", "w_2"):
            layer_linear(ffn, w)
    for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
        layer_linear("self_attn", lin)
    if "encoder.encoders.0.self_attn.linear_pos.weight" in sd:
        layer_linear("self_attn", "linear_pos", has_bias=False)
        for bias in ("pos_bias_u", "pos_bias_v"):
            lay["self_attn"][bias] = stack(f"{layer}self_attn.{bias}")
    conv = lay["conv_module"]
    for name in ("pointwise_conv1", "pointwise_conv2", "depthwise_conv"):
        src = f"{layer}conv_module.{name}"
        if (src + ".weight").format(0) in sd:
            conv[name]["kernel"] = stack(src + ".weight", lambda v: v.transpose(2, 1, 0))
            if (src + ".bias").format(0) in sd:
                conv[name]["bias"] = stack(src + ".bias")
    src = f"{layer}conv_module.norm"
    if (src + ".weight").format(0) in sd:
        conv["norm"]["scale"] = stack(src + ".weight")
        conv["norm"]["bias"] = stack(src + ".bias")
        if "mean" in conv["norm"] and (src + ".running_mean").format(0) in sd:
            conv["norm"]["mean"] = stack(src + ".running_mean")
            conv["norm"]["var"] = stack(src + ".running_var")
    for ln in ("norm_ff", "norm_ff_macaron", "norm_mha", "norm_conv", "norm_final"):
        if f"encoder.encoders.0.{ln}.weight" in sd:
            lay[ln]["scale"] = stack(f"{layer}{ln}.weight")
            lay[ln]["bias"] = stack(f"{layer}{ln}.bias")

    pred = p["predictor"]
    if "predictor.embed.weight" in sd:
        pred["embed"]["embedding"] = sd["predictor.embed.weight"]
    for k in range(cfg.predictor_num_layers):
        if f"predictor.rnn.weight_ih_l{k}" not in sd:
            continue
        lp = pred["rnn"][k]
        lp["w_ih"] = sd[f"predictor.rnn.weight_ih_l{k}"].T
        lp["w_hh"] = sd[f"predictor.rnn.weight_hh_l{k}"].T
        lp["b_ih"] = sd[f"predictor.rnn.bias_ih_l{k}"]
        lp["b_hh"] = sd[f"predictor.rnn.bias_hh_l{k}"]
    linear(pred["projection"], "predictor.projection")

    for name in ("enc_ffn", "pred_ffn", "ffn_out"):
        linear(p["joint"][name], f"joint.{name}")
    linear(p["ctc"]["ctc_lo"], "ctc.ctc_lo")

    if missing:
        print(f"[checkpoint import] {len(missing)} keys missing, e.g. {missing[:5]}")
    return from_jax_params(p, device)
