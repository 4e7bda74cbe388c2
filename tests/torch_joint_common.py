"""Helpers of the joint kernels' CPU emulations (``tests/test_torch_joint_wide_fwd.py``
and ``tests/test_torch_joint_wide_bwd.py``): the tf32 rounding of the
tensor cores' 3xTF32 products, emulated on the int32 bits, and the seeded
inputs both files draw."""

import numpy as np
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, ties away from
    zero, on the int32 bits (sign and magnitude: adding half of the dropped
    unit to the magnitude, then truncating)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo): x's tf32 part and the tf32 part of the rest."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, f32: bool) -> torch.Tensor:
    """a @ b as the kernels run it: 3xTF32 in float32, else the operands as
    given (bf16 values) with float32 sums."""
    if not f32:
        return a @ b
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + ah @ bl + al @ bh


def joint_inputs(j: int, seed: int, v: int = 130):
    """enc [2, 8, J], pred [2, 5, J], W [J, V], bias [V], the padded labels
    [2, 5] (labels in [1, V), blank at U) and the cotangents [2, 8, 5], all
    float32 numpy arrays (int32 labels) from one seeded generator."""
    b, t, u = 2, 8, 4
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, j)).astype(np.float32)
    pred = rng.standard_normal((b, u + 1, j)).astype(np.float32)
    w = (0.3 * rng.standard_normal((j, v)) / np.sqrt(j / 64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    lab = np.pad(rng.integers(1, v, (b, u)).astype(np.int32), ((0, 0), (0, 1)))
    g_b, g_e = (rng.standard_normal((b, t, u + 1)).astype(np.float32) for _ in range(2))
    return enc, pred, w, bias, lab, g_b, g_e
