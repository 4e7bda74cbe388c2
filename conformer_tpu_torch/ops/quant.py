"""Int8 weights with dynamic per-row activation quantization, for serving
(JAX ``ops/quant.py``).

  - weights: per-output-channel symmetric int8 (scale = absmax / 127),
    quantized once at load time (``quantize_tree``);
  - activations: per-row dynamic symmetric int8, quantized on the fly
    inside the kernels (``ops/int8_matmul.py``, ``ops/int8_ffn.py``).

``models/layers.dense`` dispatches on the presence of "kernel_q", and the
encoder's FFN halves on both of their matmuls carrying it, so a quantized
parameter tree drops into every entry point unchanged.
"""

from __future__ import annotations

from typing import Any

import torch

from .int8_matmul import int8_matmul_dynamic

Params = dict[str, Any]


def quantize_dense_params(p: Params) -> Params:
    """{"kernel" [I,O] or stacked [L,I,O], "bias"?} -> {"kernel_q" int8,
    "kernel_scale" float32 [O] / [L,O], "bias"?}, per-output-channel
    symmetric scales, rounding half to even. Stacked layers slice through
    ``models/encoder.layer_params`` leaf by leaf."""
    w = p["kernel"].float()
    scale = (w.abs().amax(dim=-2) / 127.0).clamp_min(1e-12)
    w_q = torch.round(w / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    out: Params = {"kernel_q": w_q, "kernel_scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def int8_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W + b with W int8 per channel and x quantized per row.

    The product is ``int8_matmul_dynamic`` for every shape: its kernel on
    CUDA tensors, its plain version on CPU tensors. The JAX package takes
    its kernel only when K % 128 == 0 and N >= K, a rule measured on the
    TPU v5e (retiling the activation tile to int8 in VMEM costs O(K) per
    row); the CUDA kernel takes any K >= 1 and needs no such rule. The bias
    is added outside the kernel in the activation dtype, as JAX's kernel
    route does; in float32 that equals JAX's XLA route."""
    k = x.shape[-1]
    y = int8_matmul_dynamic(x.reshape(-1, k), p["kernel_q"], p["kernel_scale"])
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _is_dense(p: Any) -> bool:
    return isinstance(p, dict) and "kernel" in p and getattr(p["kernel"], "ndim", 0) in (2, 3)


def quantize_tree(
    params: Params,
    min_dim: int = 64,
    skip_keys: tuple[str, ...] = (),
    expand_only: bool = True,
    fuse_ffn: bool = False,
) -> Params:
    """Replace every dense (rank 2, or rank 3 stacked) whose smaller
    dimension is >= ``min_dim`` with int8 params. Subtrees named in
    ``skip_keys`` stay as they are; so do names containing "conv" (a rank-3
    conv kernel is not a stacked dense) and ``linear_pos`` (the relative
    attention reads its raw kernel). With ``expand_only``, only denses with
    out >= 2 * in are quantized; with ``fuse_ffn``, both matmuls of every
    encoder ``feed_forward*`` are, whatever ``expand_only`` says, for the
    fused int8 FFN (``ops/int8_ffn.py``)."""

    def walk(node: Any, name: str, in_ffn: bool = False, in_encoder: bool = False) -> Any:
        if name in skip_keys:
            return node
        if (
            _is_dense(node)
            and "conv" not in name
            and name != "linear_pos"
            and min(node["kernel"].shape[-2:]) >= min_dim
            and ((fuse_ffn and in_ffn)
                 or not expand_only
                 or node["kernel"].shape[-1] >= 2 * node["kernel"].shape[-2])
        ):
            return quantize_dense_params(node)
        if isinstance(node, dict):
            return {
                k: walk(v, k, in_ffn or (in_encoder and "feed_forward" in k),
                        in_encoder or k == "encoder")
                for k, v in node.items()
            }
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name, in_ffn, in_encoder) for v in node)
        return node

    return walk(params, "")
