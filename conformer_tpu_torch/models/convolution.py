"""Conformer convolution module (full-utterance) and x4 conv subsampling.

Counterpart of the JAX package's ``models/convolution.py``. The streaming
variant of ``conv_module`` (a carried left-context cache) and the
BatchNorm and causal options come with the streaming slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .layers import Params


def init_conv_module(gen, dim: int, kernel_size: int) -> Params:
    return {
        "pointwise_conv1": layers.init_conv1d(gen, dim, dim * 2, 1),
        "depthwise_conv": layers.init_conv1d(gen, dim, dim, kernel_size, groups=dim),
        "pointwise_conv2": layers.init_conv1d(gen, dim, dim, 1),
        "norm": layers.init_layer_norm(dim),
    }


def conv_module(
    p: Params, x: torch.Tensor, pad_mask: torch.Tensor | None, *, kernel_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """pw-expand -> GLU -> depthwise (SAME) -> LayerNorm -> swish -> pw.

    x [B, T, D]; pad_mask bool [B, T] (True = valid) or None. Returns
    (y [B, T, D], cache [B, kernel_size-1, D]): the trailing K-1 GLU frames,
    zero-left-padded when T < K-1. Padding frames are zeroed on the way in
    and on the way out.
    """
    if pad_mask is not None:
        x = torch.where(pad_mask[..., None], x, torch.zeros_like(x))
    y = layers.glu(layers.conv1d(p["pointwise_conv1"], x))
    context = kernel_size - 1
    cache = F.pad(y, (0, 0, context, 0))[:, y.shape[1]:, :]
    y = layers.conv1d(
        p["depthwise_conv"], y, padding=(context // 2, context - context // 2),
        groups=y.shape[-1],
    )
    y = layers.swish(layers.layer_norm(p["norm"], y))
    y = layers.conv1d(p["pointwise_conv2"], y)
    if pad_mask is not None:
        y = torch.where(pad_mask[..., None], y, torch.zeros_like(y))
    return y, cache


def init_subsampling(gen, input_dim: int, output_dim: int) -> Params:
    freq_out = ((input_dim - 1) // 2 - 1) // 2
    return {
        "conv1": layers.init_conv2d(gen, 1, output_dim, (3, 3)),
        "conv2": layers.init_conv2d(gen, output_dim, output_dim, (3, 3)),
        "out": layers.init_dense(gen, output_dim * freq_out, output_dim),
    }


def subsampling(p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, T, F] features -> [B, T', D], T' = ((T-1)//2 - 1)//2.

    Two VALID k=3 s=2 convs with ReLU, then the channel-major flatten of a
    [B, T', C, F'] view (the JAX layout) and a linear projection.
    """
    y = torch.relu(layers.conv2d(p["conv1"], x[:, None], stride=(2, 2)))
    y = torch.relu(layers.conv2d(p["conv2"], y, stride=(2, 2)))   # [B, C, T', F']
    b, c, t, f = y.shape
    y = y.permute(0, 2, 1, 3).reshape(b, t, c * f)
    return layers.dense(p["out"], y)
