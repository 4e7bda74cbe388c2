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


def pack_k4(w_q: torch.Tensor) -> torch.Tensor:
    """int8 w_q [K, N] -> int32 [KW, N], the layout the kernels' ``__dp4a``
    reads: word (kw, n) holds w_q[4 kw + j, n] in byte j (zero past K), KW
    = ceil(K / 16) * 4 (whole 16-byte groups of words). One coalesced
    32-bit load then brings four rows of a column."""
    k, n = w_q.shape
    kw = -(-k // 16) * 4
    w = F.pad(w_q, (0, 0, 0, 4 * kw - k))
    return w.view(kw, 4, n).transpose(1, 2).contiguous().view(torch.int32).view(kw, n)


def int8_matmul_dynamic_plain(x: torch.Tensor, w_q: torch.Tensor,
                              w_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] float, w_q [K, N] int8, w_scale [N] float32 -> [M, N] in
    x's dtype, float32 math with the TPU kernel's rounding points."""
    x_q, x_scale = quant_rows(x.float())
    return (int_matmul(x_q, w_q) * x_scale * w_scale.float()).to(x.dtype)


def int8_matmul_dynamic(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper with the contract of ``int8_matmul_dynamic_plain``.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: float32 or bfloat16 x [M, K], any M and K >= 1, int8 w_q [K, N]
    and float32 w_scale [N] on x's device. ``int8_matmul_dynamic.launches``
    counts calls that launched the kernel (one per call, though the kernel
    runs as two launches: the row quantization, then the product)."""
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
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    x, w_scale = x.contiguous(), w_scale.contiguous()
    w_p = pack_k4(w_q)
    kw = (k + 3) // 4
    x_q = torch.empty((m, kw), dtype=torch.int32, device=x.device)        # scratch
    x_scale = torch.empty((m,), dtype=torch.float32, device=x.device)     # scratch
    fn = cuda_build.load_function("int8_matmul", "int8_matmul_fwd", n_ptrs=7, n_ints=4)
    P = cuda_build.ptr
    err = fn(P(x), P(w_p), P(w_scale), P(out), P(x_q), P(x_scale), cuda_build.stream_ptr(x),
             m, k, n, int(x.dtype == torch.bfloat16))
    cuda_build.check(err, "int8_matmul")
    int8_matmul_dynamic.launches += 1
    return out


int8_matmul_dynamic.launches = 0
