"""Primitive layers over plain parameter dicts, in the JAX package's layouts.

Parameters are nested dicts of tensors with the same keys and shapes as the
JAX pytree (``models/layers.py`` there): dense kernels ``[in, out]``, 1-D
conv kernels ``[K, in/groups, out]`` over ``[B, T, C]`` activations, 2-D
conv kernels ``[Kh, Kw, in, out]`` (over torch's ``[B, C, H, W]``). Keeping the JAX
layouts at every public function lets the parity tests compare like with
like and lets JAX checkpoints load without reshuffling.

Initializers follow torch defaults: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
dense and conv weights and biases, N(0, 1) for embeddings.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------- initializers


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_dense(gen, in_dim: int, out_dim: int, use_bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(in_dim)
    p: Params = {"kernel": uniform(gen, (in_dim, out_dim), bound)}
    if use_bias:
        p["bias"] = uniform(gen, (out_dim,), bound)
    return p


def init_embedding(gen, vocab: int, dim: int) -> Params:
    return {"embedding": torch.randn((vocab, dim), generator=gen)}


def init_layer_norm(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def init_batch_norm(dim: int) -> Params:
    """BatchNorm's affine parameters and its running statistics."""
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim),
            "mean": torch.zeros(dim), "var": torch.ones(dim)}


def init_conv1d(gen, in_ch: int, out_ch: int, kernel: int, groups: int = 1) -> Params:
    bound = 1.0 / math.sqrt((in_ch // groups) * kernel)
    return {
        "kernel": uniform(gen, (kernel, in_ch // groups, out_ch), bound),
        "bias": uniform(gen, (out_ch,), bound),
    }


def init_conv2d(gen, in_ch: int, out_ch: int, kernel: tuple[int, int]) -> Params:
    bound = 1.0 / math.sqrt(in_ch * kernel[0] * kernel[1])
    return {
        "kernel": uniform(gen, (*kernel, in_ch, out_ch), bound),
        "bias": uniform(gen, (out_ch,), bound),
    }


# ---------------------------------------------------------------------- apply


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel (+ bias), product and bias add in the activation dtype;
    int8 serving params ("kernel_q", ``ops/quant.py``) take ``int8_dense``."""
    if "kernel_q" in p:
        from ..ops.quant import int8_dense

        return int8_dense(p, x)
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def embedding(p: Params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows ``ids`` of the table, cast to ``dtype`` first when given."""
    table = p["embedding"]
    if dtype is not None:
        table = table.to(dtype)
    return F.embedding(ids, table)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics whatever the activation dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def batch_norm_inference(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the last (channel) axis with the running statistics,
    in float32 whatever the activation dtype."""
    y = (x.float() - p["mean"]) * torch.rsqrt(p["var"] + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def conv1d(
    p: Params,
    x: torch.Tensor,
    *,
    padding: int | tuple[int, int] = 0,
    groups: int = 1,
) -> torch.Tensor:
    """1-D conv (stride 1) over [B, T, C] with kernel [K, C//groups, O]."""
    if isinstance(padding, int):
        padding = (padding, padding)
    w = p["kernel"].to(x.dtype).permute(2, 1, 0)          # [O, C//g, K]
    xt = F.pad(x.transpose(1, 2), padding)
    y = F.conv1d(xt, w, groups=groups).transpose(1, 2)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def conv2d(
    p: Params, x: torch.Tensor, *, stride: tuple[int, int] = (1, 1)
) -> torch.Tensor:
    """VALID 2-D conv over torch's [B, C, H, W] with the JAX kernel layout
    [Kh, Kw, I, O] (the JAX function takes [B, H, W, C]; the subsampler's
    channel-major flatten is then a plain permute, see convolution.py)."""
    w = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)       # [O, I, Kh, Kw]
    y = F.conv2d(x, w, stride=stride)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)[:, None, None]
    return y


def dropout(
    gen: torch.Generator | None, x: torch.Tensor, rate: float, deterministic: bool
) -> torch.Tensor:
    """x / keep where a Bernoulli(keep) draw from ``gen`` is true, else 0;
    the identity when ``deterministic`` or ``rate <= 0`` (JAX
    ``layers.dropout``). ``gen`` lies on x's device. The draws differ from
    ``jax.random``'s; the keep rate and the scaling are the same."""
    if deterministic or rate <= 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
