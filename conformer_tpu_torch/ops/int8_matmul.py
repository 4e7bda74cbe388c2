"""Dynamic int8 matmul: per-row int8 quantization of the activations, an
int8 x int8 -> int32 product with per-output-channel int8 weights, and the
rescale. CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/quant_kernel.py``
(``int8_matmul_dynamic``, ``_kernel``):

    s_x = max(max|x_row| * f32(1/127), 1e-12)
    y   = (quant(x) @ w_q) * s_x * w_scale        in x's dtype

with ``quant(x) = clip(round_half_even(x / s_x), -127, 127)``. The bias is
the caller's (``ops/quant.int8_dense``). The kernel is
``csrc/int8_matmul.cu``; its source note gives the bound and the design.
``int8_matmul_dynamic`` launches it for CUDA tensors and takes
``int8_matmul_dynamic_plain`` only for CPU tensors.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch
import torch.nn.functional as F

from . import cuda_build


# The JAX code writes the row scale as absmax / 127.0; under jit (every JAX
# caller of the activation quantization runs under it) XLA folds the
# division by the constant into a multiply by its float32 reciprocal, and
# that is the scale JAX computes. The port takes the same product, so that
# its int8 values and scales equal JAX's bit for bit. The division of x by
# the scale stays an IEEE division, as in JAX.
INV_127 = 1.0 / 127.0


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of float32 ``x``: (int8 values, float32
    [..., 1] scale), rounding half to even as ``jnp.round`` does."""
    scale = (x.abs().amax(dim=-1, keepdim=True) * INV_127).clamp_min(1e-12)
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def int_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 a_q [..., K] @ int8 w_q [K, N] as float32, exactly as an int32
    sum converted with round-to-nearest: the float64 product of integers is
    exact while |sum| < 2^53 (K * 127^2 is far below it)."""
    return torch.matmul(a_q.double(), w_q.double()).float()


def pad_transpose(w_q: torch.Tensor) -> torch.Tensor:
    """int8 w_q [K, N] -> int8 [N, K_pad], the kernels' layout of a weight:
    K-major, as integer ``wgmma`` takes its operands, with K zero-padded to
    a multiple of 32 (one product step; zeros add nothing to the int32
    sums, and K_pad bytes are the 16-byte row stride TMA needs)."""
    k = w_q.shape[0]
    return F.pad(w_q.t(), (0, -(-k // 32) * 32 - k)).contiguous()


def unpad_transpose(w_t: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of ``pad_transpose``: int8 [N, K_pad] -> [K, N]."""
    return w_t[:, :k].t()


LAYOUT_CACHE_SIZE = 256
_layouts: OrderedDict = OrderedDict()
_layouts_lock = threading.Lock()


def kernel_layout(w_q: torch.Tensor) -> torch.Tensor:
    """``pad_transpose(w_q)``, made once per weight: cached by the int8
    weight's device, address, shape, strides and version counter (an
    in-place change of the weight makes a new layout). Each entry holds
    the weight itself, so that its memory is not reused by another tensor
    while the entry lives; the cache keeps the ``LAYOUT_CACHE_SIZE`` last
    used. An inference tensor has no version counter: its layout is taken
    as unchanged. ``kernel_layout.builds`` counts the layouts made."""
    version = -1 if w_q.is_inference() else w_q._version
    key = (w_q.device, w_q.data_ptr(), tuple(w_q.shape), w_q.stride(), version)
    with _layouts_lock:
        hit = _layouts.get(key)
        if hit is not None:
            _layouts.move_to_end(key)
            return hit[1]
    w_t = pad_transpose(w_q)
    with _layouts_lock:
        kernel_layout.builds += 1
        _layouts[key] = (w_q, w_t)
        while len(_layouts) > LAYOUT_CACHE_SIZE:
            _layouts.popitem(last=False)
    return w_t


kernel_layout.builds = 0


def int8_matmul_dynamic_plain(x: torch.Tensor, w_q: torch.Tensor,
                              w_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] float, w_q [K, N] int8, w_scale [N] float32 -> [M, N] in
    x's dtype, float32 math with the TPU kernel's rounding points."""
    x_q, x_scale = quant_rows(x.float())
    return (int_matmul(x_q, w_q) * x_scale * w_scale.float()).to(x.dtype)


KMAX = 1024      # K the kernel's shared-memory A tiles hold (csrc/int8_matmul.cu)


def width_error(k: int) -> str | None:
    """Why the CUDA kernel does not take K, or None where it does: it
    holds each 128-row tile's int8 activations, K_pad bytes a row, in
    shared memory (every shipped width, K = D <= 512, fits)."""
    if k > KMAX:
        return f"int8_matmul_dynamic takes K <= {KMAX} (got K = {k})"
    return None


def int8_matmul_dynamic(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper with the contract of ``int8_matmul_dynamic_plain``.

    CPU tensors take the plain version. CUDA tensors launch the kernel (one
    launch) or raise: float32 or bfloat16 x [M, K], any M, 1 <= K <= KMAX
    (``width_error``), int8 w_q [K, N] and float32 w_scale [N] on x's
    device. The kernel reads w_q as its ``kernel_layout``, made at the
    first call with each weight. ``int8_matmul_dynamic.launches`` counts
    calls that launched the kernel."""
    if x.device.type == "cpu":
        return int8_matmul_dynamic_plain(x, w_q, w_scale)
    if x.device.type != "cuda" or w_q.device != x.device or w_scale.device != x.device:
        raise ValueError("int8_matmul_dynamic: inputs must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("int8_matmul_dynamic: x must be float32 or bfloat16")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError("int8_matmul_dynamic: w_q must be int8 and w_scale float32")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] or x.shape[1] < 1 \
            or w_scale.shape != (w_q.shape[1],):
        raise ValueError(f"int8_matmul_dynamic: shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, w_scale {tuple(w_scale.shape)} do not match")
    m, k = x.shape
    why = width_error(k)
    if why is not None:
        raise ValueError(why)
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    x, w_scale = x.contiguous(), w_scale.contiguous()
    w_t = kernel_layout(w_q)
    fn = cuda_build.load_function("int8_matmul", "int8_matmul_fwd", n_ptrs=5, n_ints=4)
    P = cuda_build.ptr
    err = fn(P(x), P(w_t), P(w_scale), P(out), cuda_build.stream_ptr(x), m, k, n,
             int(x.dtype == torch.bfloat16))
    cuda_build.check(err, "int8_matmul")
    int8_matmul_dynamic.launches += 1
    return out


int8_matmul_dynamic.launches = 0
