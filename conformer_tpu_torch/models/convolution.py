"""Conformer convolution module and x4 conv subsampling.

Counterpart of the JAX package's ``models/convolution.py``: the
full-utterance conv module, its causal option, its streaming form with a
carried left-context cache, and its norm: LayerNorm, or the reference's
BatchNorm (``norm_type="batch_norm"``), which applies its running
statistics in training too, as in JAX: they never update, and the
optimizer freezes them (``train/optimizer.is_trainable``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .layers import Params


def init_conv_module(gen, dim: int, kernel_size: int, norm_type: str = "layer_norm") -> Params:
    return {
        "pointwise_conv1": layers.init_conv1d(gen, dim, dim * 2, 1),
        "depthwise_conv": layers.init_conv1d(gen, dim, dim, kernel_size, groups=dim),
        "pointwise_conv2": layers.init_conv1d(gen, dim, dim, 1),
        "norm": (layers.init_batch_norm(dim) if norm_type == "batch_norm"
                 else layers.init_layer_norm(dim)),
    }


def conv_module(
    p: Params, x: torch.Tensor, pad_mask: torch.Tensor | None, *, kernel_size: int,
    norm_type: str = "layer_norm", causal: bool = False, cache: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """pw-expand -> GLU -> depthwise -> norm -> swish -> pw; the norm is
    LayerNorm, or BatchNorm with its running statistics when ``norm_type``
    is "batch_norm".

    x [B, T, D]; pad_mask bool [B, T] (True = valid) or None. Returns
    (y [B, T, D], cache [B, K-1, D]). Padding frames are zeroed on the way
    in and on the way out.

    Without ``cache`` (a full utterance) the depthwise conv is SAME, or
    left-padded by K-1 when ``causal``; the returned cache is the trailing
    K-1 GLU frames, zero-left-padded when T < K-1. With ``cache`` [B, K-1,
    D] (the previous chunk's, zeros at the start) the left context comes
    from it: a causal conv reads ``cache ++ y`` unpadded; otherwise the
    first (K-1)//2 frames of ``cache ++ y`` are dropped and the right edge
    is zero-padded by (K-1)//2, since future frames are not there yet. The
    next cache is the trailing K-1 frames of the whole history, even when
    the chunk is shorter than K-1.
    """
    if pad_mask is not None:
        x = torch.where(pad_mask[..., None], x, torch.zeros_like(x))
    y = layers.glu(layers.conv1d(p["pointwise_conv1"], x))
    context = kernel_size - 1
    if cache is not None:
        y_ext = torch.cat([cache.to(y.dtype), y], dim=1)
        new_cache = y_ext[:, y_ext.shape[1] - context:, :]
        if causal:
            pad = (0, 0)
        else:
            pad = (0, context // 2)
            y_ext = y_ext[:, context // 2:, :]
    else:
        new_cache = F.pad(y, (0, 0, context, 0))[:, y.shape[1]:, :]
        y_ext = y
        pad = (context, 0) if causal else (context // 2, context - context // 2)
    y = layers.conv1d(p["depthwise_conv"], y_ext, padding=pad, groups=y.shape[-1])
    norm = layers.batch_norm_inference if norm_type == "batch_norm" else layers.layer_norm
    y = layers.swish(norm(p["norm"], y))
    y = layers.conv1d(p["pointwise_conv2"], y)
    if pad_mask is not None:
        y = torch.where(pad_mask[..., None], y, torch.zeros_like(y))
    return y, new_cache


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
