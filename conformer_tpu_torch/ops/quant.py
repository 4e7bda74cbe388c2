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

from .int8_matmul import int8_matmul_dynamic, int_matmul, quant_rows, width_error

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


def int8_dense_route(k: int) -> str:
    """Which route ``int8_dense`` takes for a contraction of width ``k``:
    "kernel" (``int8_matmul_dynamic``) where its CUDA kernel takes K
    (``int8_matmul.width_error``: K <= 1024, every shipped K = D), "xla"
    above it, as JAX's ``int8_dense`` takes XLA outside its kernel's rule.
    A function of the shape alone, on every device."""
    return "kernel" if width_error(k) is None else "xla"


def int8_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W + b with W int8 per channel and x quantized per row.

    Route "kernel" (``int8_dense_route``): ``int8_matmul_dynamic``, its
    kernel on CUDA tensors and its plain version on CPU tensors; the bias is
    added outside in the activation dtype, as JAX's kernel route does (in
    float32 that equals JAX's XLA route). Route "xla", for K above the
    kernel's limit (``quantize_tree(expand_only=False)`` quantizes the
    subsampling's output dense, K = 2736 / 4864 / 9728 at Conformer-S / M /
    L): JAX's XLA route, the rows quantized as ``quant_rows`` does over all
    of K, the int8 product summed exactly (``int_matmul``: float64 products
    of integers, as JAX's int32 ``dot_general``), rescaled and the bias
    added in float32, then cast to x's dtype; ``int8_dense.xla_routes``
    counts the calls that took it. The JAX package takes its kernel only
    when K % 128 == 0 and N >= K, a rule measured on the TPU v5e; the port's
    route follows the CUDA kernel's limit alone."""
    k = x.shape[-1]
    if int8_dense_route(k) == "xla":
        int8_dense.xla_routes += 1
        x_q, x_scale = quant_rows(x.float())
        y = int_matmul(x_q, p["kernel_q"]) * x_scale * p["kernel_scale"].float()
        if "bias" in p:
            y = y + p["bias"].float()
        return y.to(x.dtype)
    y = int8_matmul_dynamic(x.reshape(-1, k), p["kernel_q"], p["kernel_scale"])
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


int8_dense.xla_routes = 0


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
