"""The fused int8 FFN's wide route (``csrc/int8_ffn.cu``, "wide": D > 512 or
H > 2048) emulated on the CPU against JAX's ``ffn_kernel._kernel`` (its
Pallas kernel in interpret mode) and ``int8_ffn_reference``, and the
route's scratch.

The emulation follows the kernels where their arithmetic leaves the plain
version's order: the hidden h written zero-padded to a multiple of 32
columns; its row absmax taken as the max of each 128-column tile's partial
maxima (the hidden GEMM's epilogue), then folded into s_h by the
quantization pass; hq over the padded row; the output product over the
padded depth. A max is exact in any order, so s_h and hq must equal JAX's
``_quant_rows`` of the same h bit for bit. Inputs from seeded numpy
generators at M = 37 with an all-zero row: Conformer XL's D 1024 / H 4096,
and D 520 / H 600 (the last hidden tile 88 columns wide).

Tolerance for the outputs: JAX's own int8 FFN tolerance (rtol 1e-2, atol
2e-3; tests/test_int8_ffn.py): the two sides' LayerNorm statistics and
sigmoid differ by ulps, which may flip one int8 value at a rounding
boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conformer_tpu.ops import quant as jq
from conformer_tpu.ops.pallas.ffn_kernel import _quant_rows as j_quant_rows
from conformer_tpu.ops.pallas.ffn_kernel import int8_ffn_fused as j_ffn_kernel
from conformer_tpu.ops.pallas.ffn_kernel import int8_ffn_reference as j_ffn_ref
from conformer_tpu_torch.models.layers import layer_norm
from conformer_tpu_torch.ops import int8_ffn as pif
from conformer_tpu_torch.ops.int8_matmul import INV_127, int_matmul, quant_rows
from conformer_tpu_torch.params import from_jax_params

INT8_TOL = dict(rtol=1e-2, atol=2e-3)
CASES = [(1024, 4096), (520, 600)]


def emulated_wide_ffn(x, ln, w1q, s1, b1, w2q, s2, b2, half=0.5, eps=1e-5):
    """(out, h, hq, s_h) of the wide route's four launches; h and hq [M,
    H_pad] as the scratch holds them."""
    m, h = x.shape[0], w1q.shape[1]
    hp, tiles = -(-h // 32) * 32, -(-h // 128)
    xq, xs = quant_rows(layer_norm(ln, x.float(), eps=eps))
    hid = int_matmul(xq, w1q) * xs * s1 + b1
    hid = F.pad(hid * torch.sigmoid(hid), (0, hp - h))            # zero past H
    pmax = torch.stack([hid[:, 128 * j:128 * j + 128].abs().amax(dim=1) for j in range(tiles)],
                       dim=1)                                      # [M, tiles]
    s_h = (pmax.amax(dim=1, keepdim=True) * INV_127).clamp_min(1e-12)
    hq = torch.round(hid / s_h).clamp(-127, 127).to(torch.int8)
    y = int_matmul(hq, F.pad(w2q, (0, 0, 0, hp - h))) * s_h * s2 + b2
    return (x.float() + half * y).to(x.dtype), hid, hq, s_h


def _weights(d, h, seed):
    rng = np.random.default_rng(seed)
    w1 = {"kernel": (rng.standard_normal((d, h)) / np.sqrt(d)).astype(np.float32),
          "bias": (rng.standard_normal(h) * 0.1).astype(np.float32)}
    w2 = {"kernel": (rng.standard_normal((h, d)) / np.sqrt(h)).astype(np.float32),
          "bias": (rng.standard_normal(d) * 0.1).astype(np.float32)}
    ln = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          "bias": (0.05 * rng.standard_normal(d)).astype(np.float32)}
    x = rng.standard_normal((37, d)).astype(np.float32)
    x[3] = 0.0                      # a bucket-padding row: LN gives its bias
    q1, q2 = (jq.quantize_dense_params(jax.tree.map(jnp.asarray, w_)) for w_ in (w1, w2))
    j_args = (jnp.asarray(x), jax.tree.map(jnp.asarray, ln), q1["kernel_q"], q1["kernel_scale"],
              q1["bias"], q2["kernel_q"], q2["kernel_scale"], q2["bias"])
    p_args = (torch.from_numpy(x), *from_jax_params([ln, *(np.asarray(a) for a in j_args[2:])]))
    return j_args, p_args


@pytest.mark.parametrize("d,h", CASES, ids=[f"D{d}-H{h}" for d, h in CASES])
def test_wide_ffn_arithmetic_matches_pallas(d, h):
    """s_h and hq from the tiles' partial maxima equal JAX's _quant_rows of
    the same h bit for bit (padding columns zero); out against JAX's
    kernel and reference at JAX's tolerance."""
    assert pif.width_error(d, h) is None and pif.route(d, h) == "wide"
    j_args, p_args = _weights(d, h, d + h)
    out, hid, hq, s_h = emulated_wide_ffn(*p_args)
    want_q, want_s = jax.jit(j_quant_rows)(jnp.asarray(hid[:, :h].numpy()))
    np.testing.assert_array_equal(hq[:, :h].numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s_h.numpy(), np.asarray(want_s))
    assert (hq[:, h:] == 0).all() and (hid[:, h:] == 0).all()
    for want in (j_ffn_ref(*j_args, half=0.5),
                 j_ffn_kernel(*j_args, half=0.5, tile_m=32, interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **INT8_TOL)


@pytest.mark.parametrize("m,d,h", [(2992, 1024, 4096), (37, 70, 130), (1, 2048, 8192),
                                   (5, 1000, 2049)])
def test_wide_scratch_layout(m, d, h):
    """One buffer: each scratch tensor at a 256-byte boundary (TMA and the
    16-byte vectors take 16), none overlapping, of the shapes the C entry
    reads; ``wide_scratch`` allocates the buffer and gives each part's
    address."""
    layout = pif.wide_scratch_layout(m, d, h)
    dp, hp = -(-d // 32) * 32, -(-h // 32) * 32
    assert [(n, s, t) for n, s, t, _ in layout] == [
        ("xq", (m, dp), torch.int8), ("sx", (m,), torch.float32),
        ("h", (m, hp), torch.float32), ("pmax", (m, -(-h // 128)), torch.float32),
        ("hq", (m, hp), torch.int8), ("sh", (m,), torch.float32)]
    end = 0
    for _, shape, dt, at in layout:
        assert at % 256 == 0 and at >= end
        end = at + dt.itemsize * int(np.prod(shape))
    buf, ptrs = pif.wide_scratch(m, d, h, "cpu")
    assert buf.dtype == torch.uint8 and buf.numel() == end
    assert ptrs == [buf.data_ptr() + at for *_, at in layout]
