"""Fused Conformer convolution block, inference forward: CUDA kernel and
plain version.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/conv_kernel.py``
(``conv_block_fused``, ``_conv_kernel``):

    out = x + mask(pw2(swish(LN(depthwise_K(GLU(pw1(mask(LN_pre(x)))))))))

plus the trailing K-1 GLU frames as the conv cache for a later streaming
switch. The kernel is ``csrc/conv_block.cu``; its source note gives the
bound and the design (bf16 on the tensor cores, float32 on FMAs).
``conv_block`` launches it for CUDA tensors and takes ``conv_block_plain``
only for CPU tensors; ``width_error`` says which widths it takes.
LayerNorm, non-causal only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cuda_build

NARROW_D = 512          # the narrow kernels' channels (Conformer-S 144, M 256, L 512)
NARROW_K_BF16 = 32      # the narrow bf16 depthwise's register window
MAX_D = 2048            # channels of the wide path, a multiple of 16; its pw2 tiles' shared memory
MAX_K = 64              # the wide path's depthwise: at most four windows of 16 taps


def route(dtype, d: int, kernel_size: int) -> str:
    """Which kernels run width ``d`` and kernel size ``kernel_size`` in
    ``dtype`` (``narrow_shape`` of ``csrc/conv_block.cu``): "narrow", the
    designs every shipped width takes (D <= 512; bf16 K <= 32; float32 the
    second launch's shared memory, 4 D (79 + 2 K) bytes, within a
    block's), else "wide" (bf16: four launches, both products on wgmma
    with 192-row tiles, their operands through a bf16 scratch; float32:
    16 frames a block, taps and pw2 columns streamed)."""
    if d > NARROW_D:
        return "wide"
    if dtype == torch.bfloat16:
        return "narrow" if kernel_size <= NARROW_K_BF16 else "wide"
    return "narrow" if 4 * d * (79 + 2 * kernel_size) <= cuda_build.SMEM_LIMIT else "wide"


def scratch_shapes(dtype, b: int, t: int, d: int, kernel_size: int) -> list:
    """(shape, dtype) of the kernel's scratch tensors: g float32 [B, T, D]
    on every route, and on the wide bf16 route the products' operand
    (LN_pre(x), then swish(LN(z))) in bf16 [B, T, D]."""
    out = [((b, t, d), torch.float32)]
    if dtype == torch.bfloat16 and route(dtype, d, kernel_size) == "wide":
        out.append(((b, t, d), torch.bfloat16))
    return out


def width_error(dtype, d: int, kernel_size: int) -> str | None:
    """Why the kernel refuses width ``d`` and kernel size ``kernel_size``
    in ``dtype``, or None where it takes them: D a multiple of 16 up to
    2048 and 1 <= K <= 64, in float32 and bfloat16."""
    if d < 16 or d % 16 or d > MAX_D:
        return f"D={d}: the kernel takes D a multiple of 16 up to {MAX_D}"
    if not 1 <= kernel_size <= MAX_K:
        return f"K={kernel_size}: the kernel takes 1 <= K <= {MAX_K}"
    if dtype not in (torch.float32, torch.bfloat16):
        return f"x must be float32 or bfloat16, got {dtype}"
    return None


def _ln(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def kernel_weights(p_norm: dict, p_conv: dict, dtype: torch.dtype) -> dict:
    """The kernel's operands: products' weights in the activation dtype,
    everything else float32, all contiguous."""
    f32 = torch.float32
    return {
        "pre_s": p_norm["scale"].to(f32).contiguous(),
        "pre_b": p_norm["bias"].to(f32).contiguous(),
        "w1": p_conv["pointwise_conv1"]["kernel"][0].to(dtype).contiguous(),   # [D, 2D]
        "b1": p_conv["pointwise_conv1"]["bias"].to(f32).contiguous(),
        "wd": p_conv["depthwise_conv"]["kernel"][:, 0, :].to(f32).contiguous(),  # [K, D]
        "bd": p_conv["depthwise_conv"]["bias"].to(f32).contiguous(),
        "ln_s": p_conv["norm"]["scale"].to(f32).contiguous(),
        "ln_b": p_conv["norm"]["bias"].to(f32).contiguous(),
        "w2": p_conv["pointwise_conv2"]["kernel"][0].to(dtype).contiguous(),   # [D, D]
        "b2": p_conv["pointwise_conv2"]["bias"].to(f32).contiguous(),
    }


def conv_block_plain(x, lengths, p_norm, p_conv, *, kernel_size: int):
    """x [B,T,D], lengths [B] -> (out [B,T,D], cache [B,K-1,D]), both in
    x's dtype, with float32 math and the TPU kernel's rounding points."""
    b, t, d = x.shape
    ctx = kernel_size - 1
    w = kernel_weights(p_norm, p_conv, x.dtype)
    valid = (torch.arange(t, device=x.device)[None, :] < lengths[:, None])[..., None]
    y = torch.where(valid, _ln(x, w["pre_s"], w["pre_b"]), 0.0).to(x.dtype)
    h = torch.matmul(y.float(), w["w1"].float()) + w["b1"]
    glu = h[..., :d] * torch.sigmoid(h[..., d:])             # frames >= length keep bias-GLU
    gpad = F.pad(glu, (0, 0, ctx // 2, ctx - ctx // 2))      # zeros only outside [0, T)
    acc = torch.zeros_like(glu)
    for tap in range(kernel_size):
        acc = acc + gpad[:, tap:tap + t, :] * w["wd"][tap]
    acc = acc + w["bd"]
    z = _ln(acc, w["ln_s"], w["ln_b"])
    z = (z * torch.sigmoid(z)).to(x.dtype)
    z = torch.matmul(z.float(), w["w2"].float()) + w["b2"]
    z = torch.where(valid, z, 0.0)
    out = (x.float() + z).to(x.dtype)
    cache = F.pad(glu, (0, 0, ctx, 0))[:, t:t + ctx, :].to(x.dtype)
    return out, cache


def conv_block(x, lengths, p_norm, p_conv, *, kernel_size: int):
    """Kernel wrapper with the contract of ``conv_block_plain``.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: float32 or bfloat16 x [B,T,D] with D and K that ``width_error``
    passes. ``conv_block.launches`` counts calls that launched the kernel
    (one per call, though the kernel runs as two launches, or four on the wide
    bf16 route).
    """
    if x.device.type == "cpu":
        return conv_block_plain(x, lengths, p_norm, p_conv, kernel_size=kernel_size)
    if x.device.type != "cuda" or lengths.device != x.device:
        raise ValueError("conv_block: inputs must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("conv_block: x must be float32 or bfloat16")
    b, t, d = x.shape
    k = kernel_size
    why = width_error(x.dtype, d, k)
    if why is not None or b == 0 or t == 0:
        raise ValueError(f"conv_block: shape {tuple(x.shape)}, K={k} outside the kernel"
                         + (f": {why}" if why else ""))
    w = kernel_weights(p_norm, p_conv, x.dtype)
    if any(v.device != x.device for v in w.values()):
        raise ValueError("conv_block: parameters must be on x's device")
    if w["w1"].shape != (d, 2 * d) or w["w2"].shape != (d, d) or w["wd"].shape != (k, d):
        raise ValueError("conv_block: parameter shapes do not match x")
    x = x.contiguous()
    if any(a.data_ptr() % 16 for a in (x, w["w1"], w["w2"])):
        raise ValueError("conv_block: x, W1 and W2 must be 16-byte aligned")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    cache = torch.empty((b, k - 1, d), dtype=x.dtype, device=x.device)
    # one allocation: each part 16-byte aligned (its bytes are a multiple of 64)
    sizes = [math.prod(shape) * dt.itemsize for shape, dt in scratch_shapes(x.dtype, b, t, d, k)]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=x.device)
    glu = buf.data_ptr()
    opnd = glu + sizes[0] if len(sizes) > 1 else None

    fn = cuda_build.load_function("conv_block", "conv_block_fwd", n_ptrs=17, n_ints=5)
    P = cuda_build.ptr
    err = fn(
        P(x), P(lens), P(w["pre_s"]), P(w["pre_b"]), P(w["w1"]), P(w["b1"]),
        P(w["wd"]), P(w["bd"]), P(w["ln_s"]), P(w["ln_b"]), P(w["w2"]), P(w["b2"]),
        P(out), P(cache), glu, opnd,
        cuda_build.stream_ptr(x), b, t, d, k, int(x.dtype == torch.bfloat16),
    )
    cuda_build.check(err, "conv_block")
    conv_block.launches += 1
    return out, cache


conv_block.launches = 0
