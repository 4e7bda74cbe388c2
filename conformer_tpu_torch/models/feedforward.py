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
) -> torch.Tensor:
    """dense -> swish -> dropout -> dense."""
    y = layers.swish(layers.dense(p["w_1"], x))
    y = layers.dropout(gen, y, dropout_rate, deterministic)
    return layers.dense(p["w_2"], y)
