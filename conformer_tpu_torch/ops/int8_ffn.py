"""Fused int8 feed-forward half of a macaron layer, inference: CUDA kernel
and plain version.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/ffn_kernel.py``
(``int8_ffn_fused``, ``_kernel``; its oracle ``int8_ffn_reference``):

    out = x + half * (dequant(q(swish(dequant(q(LN(x)) @ W1) + b1)) @ W2) + b2)

with per-row dynamic int8 ``q`` (``int8_matmul.quant_rows``) and int8
weights with per-column scales, as ``ops/quant.quantize_tree(...,
fuse_ffn=True)`` makes them. The kernel is ``csrc/int8_ffn.cu``; its source
note gives the bound and the design. ``int8_ffn_fused`` launches it for
CUDA tensors and takes ``int8_ffn_plain`` only for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from ..models.layers import layer_norm
from . import cuda_build
from .int8_matmul import int_matmul, kernel_layout, quant_rows


def int8_ffn_plain(x, ln, w1q, s1, b1, w2q, s2, b2, *, half: float = 0.5,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [..., D] float -> same shape and dtype; float32 math with the
    rounding points of the JAX ``int8_ffn_reference``."""
    xn = layer_norm(ln, x.float(), eps=eps)
    xq, xs = quant_rows(xn)
    h = int_matmul(xq, w1q) * xs * s1 + b1
    h = h * torch.sigmoid(h)
    hq, hs = quant_rows(h)
    y = int_matmul(hq, w2q) * hs * s2 + b2
    return (x.float() + half * y).to(x.dtype)


DMAX, HMAX = 512, 2048     # the cluster kernel's widths (csrc/int8_ffn.cu)


def route(d: int, h: int) -> str:
    """Which kernels run the widths D and H: "narrow", the cluster kernel
    (4 blocks hold each row's H hidden values in registers, at most 512
    columns a block, and a block's A tile holds D <= 512: every shipped
    width, S 144 / 576, M 256 / 2048, L 512 / 2048), else "wide" (four
    launches, both products on int8 wgmma with 192 x 128 tiles on a
    persistent grid, the hidden in float32 through device memory with each
    128-column tile's row maxima beside it: Conformer XL's 1024 / 4096 and
    any wider)."""
    return "narrow" if d <= DMAX and h <= HMAX else "wide"


def wide_scratch_layout(m: int, d: int, h: int) -> list:
    """(name, shape, dtype, byte offset) of the wide route's scratch tensors
    in one buffer, each at a 256-byte boundary: LN(x)'s int8 xq [M, D_pad]
    and scales sx [M]; the float32 hidden h [M, H_pad] (zero past H), its
    rows' maxima of |h| over each 128-column tile pmax [M, ceil(H / 128)],
    its int8 hq [M, H_pad] and scales sh [M] (``csrc/int8_ffn.cu``
    ``int8_ffn_wide_fwd``; D_pad, H_pad: multiples of 32)."""
    dp, hp = -(-d // 32) * 32, -(-h // 32) * 32
    parts = [("xq", (m, dp), torch.int8), ("sx", (m,), torch.float32),
             ("h", (m, hp), torch.float32), ("pmax", (m, -(-h // 128)), torch.float32),
             ("hq", (m, hp), torch.int8), ("sh", (m,), torch.float32)]
    out, at = [], 0
    for name, shape, dt in parts:
        out.append((name, shape, dt, at))
        at += -(-dt.itemsize * math.prod(shape) // 256) * 256
    return out


def wide_scratch(m: int, d: int, h: int, device) -> tuple:
    """The wide route's scratch (``wide_scratch_layout``) as one allocation:
    (the buffer, the address of each part)."""
    layout = wide_scratch_layout(m, d, h)
    _, shape, dt, at = layout[-1]
    buf = torch.empty(at + dt.itemsize * math.prod(shape), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, [base + at for *_, at in layout]


def width_error(d: int, h: int) -> str | None:
    """Why the CUDA kernels do not take the widths D and H, or None where
    they do: any D, H >= 1 (``route``), as JAX's kernel."""
    if d < 1 or h < 1:
        return f"int8_ffn_fused needs D >= 1 and H >= 1 (got D = {d}, H = {h})"
    return None


def int8_ffn_fused(x, ln, w1q, s1, b1, w2q, s2, b2, *, half: float = 0.5,
                   eps: float = 1e-5) -> torch.Tensor:
    """Kernel wrapper with the contract of ``int8_ffn_plain``.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: float32 or bfloat16 x [..., D], int8 W1 [D, H] and W2 [H, D]
    within ``width_error``'s limits, everything on x's device. The kernel
    reads both weights as their ``kernel_layout``, made at the first call
    with each weight; the six vectors are float32 on the served path, where
    ``to`` and ``contiguous`` return them as they are.
    ``int8_ffn_fused.launches`` counts calls that launched the kernel."""
    if x.device.type == "cpu":
        return int8_ffn_plain(x, ln, w1q, s1, b1, w2q, s2, b2, half=half, eps=eps)
    f32 = torch.float32
    vecs = [t.to(f32).contiguous() for t in (ln["scale"], ln["bias"], s1, b1, s2, b2)]
    if x.device.type != "cuda" or any(t.device != x.device for t in (w1q, w2q, *vecs)):
        raise ValueError("int8_ffn_fused: inputs must be on one CUDA device")
    if x.dtype not in (f32, torch.bfloat16):
        raise TypeError("int8_ffn_fused: x must be float32 or bfloat16")
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8:
        raise TypeError("int8_ffn_fused: W1 and W2 must be int8")
    d = x.shape[-1]
    h = w1q.shape[-1]
    shapes = [t.shape for t in vecs]
    if (w1q.shape != (d, h) or w2q.shape != (h, d)
            or shapes != [(d,), (d,), (h,), (h,), (d,), (d,)]):
        raise ValueError(f"int8_ffn_fused: x [..., {d}], W1 {tuple(w1q.shape)}, W2 "
                         f"{tuple(w2q.shape)} and the vectors {shapes} do not match")
    why = width_error(d, h)
    if why is not None:
        raise ValueError(why)
    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    P = cuda_build.ptr
    ln_s, ln_b, s1, b1, s2, b2 = vecs
    w1t, w2t = kernel_layout(w1q), kernel_layout(w2q)
    m, dev = x2.shape[0], x.device
    ints = (m, d, h, int(x.dtype == torch.bfloat16))
    if route(d, h) == "narrow":
        fn = cuda_build.load_function("int8_ffn", "int8_ffn_fwd", n_ptrs=11, n_ints=4,
                                      n_floats=2)
        scratch = []
    else:
        fn = cuda_build.load_function("int8_ffn", "int8_ffn_wide_fwd", n_ptrs=17, n_ints=4,
                                      n_floats=2)
        buf, scratch = wide_scratch(m, d, h, dev)
    err = fn(P(x2), P(ln_s), P(ln_b), P(w1t), P(s1), P(b1), P(w2t), P(s2), P(b2), P(out),
             *scratch, cuda_build.stream_ptr(x2), *ints, half, eps)
    cuda_build.check(err, "int8_ffn")
    int8_ffn_fused.launches += 1
    return out.reshape(x.shape)


int8_ffn_fused.launches = 0
