"""Position-wise feed-forward module (JAX ``models/feedforward.py``)."""

from __future__ import annotations

import torch

from . import layers
from .layers import Params


def init_ffn(gen, dim: int, hidden_dim: int) -> Params:
    return {
        "w_1": layers.init_dense(gen, dim, hidden_dim),
        "w_2": layers.init_dense(gen, hidden_dim, dim),
    }


def ffn(
    p: Params,
    x: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
    model_shard=None,
) -> torch.Tensor:
    """dense -> swish -> dropout -> dense. ``model_shard``
    (``parallel/tensor.py``): w_1 holds this rank's hidden columns and w_2
    their rows; the dropout mask is drawn for the whole hidden width and
    sliced, and w_2's bias is added once, after the sum over "model"."""
    if model_shard is None:
        y = layers.swish(layers.dense(p["w_1"], x))
        y = layers.dropout(gen, y, dropout_rate, deterministic)
        return layers.dense(p["w_2"], y)
    y = layers.swish(layers.dense(p["w_1"], model_shard.copy_in(x)))
    y = model_shard.dropout(gen, y, dropout_rate, deterministic, dim=-1)
    return model_shard.dense_rows(p["w_2"], y)
