"""The conv block's wide bf16 route (``csrc/conv_block.cu``, "wide path":
D > 512 or K > 32) emulated on the CPU launch by launch against JAX's
``conv_kernel._conv_kernel`` (its Pallas kernel in interpret mode), and the
route's host-side plan.

The emulation follows the kernels where their arithmetic is arranged
otherwise than the plain version's: the products' operands staged in a
bf16 scratch [B T', D] (y = mask(LN_pre(x)), then swish(LN(z))); pw1 on
tiles of 64 channels whose B is W1's a columns c0.. and b columns D + c0..
as TMA reads them (zeros past 2D; past D the a box runs into the b
columns), the GLU taken on the tile's two halves and only channels below D
stored; pw2 on tiles of 128 columns (zeros past D), out = x + mask(acc +
b2). Inputs from seeded numpy generators, bf16 x, at D 1024 (K 15 and 33),
D 256 and 144 (K 33: bf16's wide route by K; 144 is no multiple of 64),
T' = 9 < K - 1 and a ragged T' = 21, lengths below T'.

Tolerance: 2e-2 abs and rel (chip_smoke.py's TOL for bf16): out is bf16
on both sides (one ulp is 1/64 at |out| < 4), and both sides round y and
swish(LN(z)) to bf16 from float32 sums taken in other orders, which may
round a value the other way.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conformer_tpu.ops.pallas import conv_kernel as ck
from conformer_tpu_torch.ops import conv_block as pcb

TOL = dict(rtol=2e-2, atol=2e-2)
CSRC = Path(pcb.__file__).resolve().parents[1] / "csrc"
CASES = [(1024, 15, 21, [21, 13, 1]), (1024, 15, 9, [9, 4, 9]), (1024, 33, 9, [9, 9, 2]),
         (1024, 33, 21, [17, 21, 5]), (256, 33, 21, [21, 8, 21]), (144, 33, 9, [6, 9, 9])]


def _params(seed, d, k):
    rng = np.random.default_rng(seed)

    def u(*shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    p_conv = {
        "pointwise_conv1": {"kernel": u(1, d, 2 * d, bound=d ** -0.5), "bias": u(2 * d, bound=0.1)},
        "depthwise_conv": {"kernel": u(k, 1, d, bound=k ** -0.5), "bias": u(d, bound=0.1)},
        "norm": {"scale": 1.0 + u(d, bound=0.2), "bias": u(d, bound=0.1)},
        "pointwise_conv2": {"kernel": u(1, d, d, bound=d ** -0.5), "bias": u(d, bound=0.1)},
    }
    p_norm = {"scale": 1.1 + u(d, bound=0.1), "bias": u(d, bound=0.05)}
    return p_norm, p_conv


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def emulated_wide_bf16(x, lengths, p_norm, p_conv, k):
    """(out, cache) of the wide bf16 route's four launches."""
    b, t, d = x.shape
    m = b * t
    w = pcb.kernel_weights(p_norm, p_conv, torch.bfloat16)
    valid = (torch.arange(t)[None, :] < lengths[:, None]).reshape(m, 1)
    xf = x.float().reshape(m, d)
    # launch 1: the operand scratch holds y in bf16
    y = torch.where(valid, pcb._ln(xf, w["pre_s"], w["pre_b"]), 0.0).to(torch.bfloat16)
    # launch 2: 64-channel tiles; B boxes of W1 [D, 2D] at columns c0 and D + c0
    w1 = F.pad(w["w1"].float(), (0, 128))
    g = torch.full((m, d), float("nan"))
    for c0 in range(0, d, 64):
        acc = y.float() @ torch.cat([w1[:, c0:c0 + 64], w1[:, d + c0:d + c0 + 64]], dim=1)
        ch = torch.arange(c0, min(c0 + 64, d))
        n = len(ch)
        g[:, ch] = (acc[:, :n] + w["b1"][ch]) * torch.sigmoid(acc[:, 64:64 + n] + w["b1"][d + ch])
    assert not torch.isnan(g).any()          # every channel stored once
    # launch 3: depthwise, LN, swish into the scratch; the cache from g
    ctx = k - 1
    g3 = g.reshape(b, t, d)
    gpad = F.pad(g3, (0, 0, ctx // 2, ctx - ctx // 2))
    z = sum(gpad[:, tap:tap + t, :] * w["wd"][tap] for tap in range(k)) + w["bd"]
    z = pcb._ln(z, w["ln_s"], w["ln_b"])
    zq = (z * torch.sigmoid(z)).to(torch.bfloat16).reshape(m, d)
    # launch 4: 128-column tiles, W2 zero past D, out = x + mask(acc + b2)
    w2 = F.pad(w["w2"].float(), (0, 128))
    out = torch.full((m, d), float("nan"))
    for n0 in range(0, d, 128):
        acc = zq.float() @ w2[:, n0:n0 + 128]
        cols = torch.arange(n0, min(n0 + 128, d))
        out[:, cols] = xf[:, cols] + torch.where(valid, acc[:, :len(cols)] + w["b2"][cols], 0.0)
    assert not torch.isnan(out).any()
    cache = F.pad(g3, (0, 0, ctx, 0))[:, t:t + ctx, :]
    return out.to(torch.bfloat16).reshape(b, t, d), cache.to(torch.bfloat16)


@pytest.mark.parametrize("d,k,t,lengths", CASES,
                         ids=[f"D{d}-K{k}-T{t}" for d, k, t, _ in CASES])
def test_wide_bf16_arithmetic_matches_pallas(d, k, t, lengths):
    """out and the cache of the emulated route against JAX's kernel on the
    same bf16 inputs; the plain version lies as close."""
    assert pcb.width_error(torch.bfloat16, d, k) is None
    assert pcb.route(torch.bfloat16, d, k) == "wide"
    p_norm, p_conv = _params(d + k, d, k)
    b = len(lengths)
    x = np.random.default_rng(t + k).standard_normal((b, t, d)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    lens = np.asarray(lengths, np.int32)
    j_out, j_cache = ck.conv_block_fused(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(lens),
        _tree(jnp.asarray, p_norm), _tree(jnp.asarray, p_conv), kernel_size=k, interpret=True)
    want = np.asarray(j_out.astype(jnp.float32)), np.asarray(j_cache.astype(jnp.float32))
    pn, pc = _tree(torch.from_numpy, p_norm), _tree(torch.from_numpy, p_conv)
    lt = torch.from_numpy(lens)
    for got in (emulated_wide_bf16(xb, lt, pn, pc, k),
                pcb.conv_block_plain(xb, lt, pn, pc, kernel_size=k)):
        assert got[1].shape == (b, k - 1, d)
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), wnt, **TOL)


def test_scratch_shapes_follow_the_route():
    """g float32 [B, T', D] on every route; the bf16 operand scratch only
    where bf16 takes the wide route (by D or by K)."""
    f32, bf16 = torch.float32, torch.bfloat16
    g = ((8, 374, 1024), f32)
    assert pcb.scratch_shapes(bf16, 8, 374, 1024, 15) == [g, ((8, 374, 1024), bf16)]
    assert pcb.scratch_shapes(f32, 8, 374, 1024, 15) == [g]
    assert pcb.scratch_shapes(bf16, 2, 9, 256, 32) == [((2, 9, 256), f32)]
    assert pcb.scratch_shapes(bf16, 2, 9, 256, 33) == [((2, 9, 256), f32), ((2, 9, 256), bf16)]
    assert pcb.scratch_shapes(f32, 2, 9, 512, 31) == [((2, 9, 512), f32)]   # f32 wide: none


def gemm_tiles(m, n, cols, grid):
    """The output elements each block of the persistent grid stores, as
    hopper_gemm.cuh's walk gives them: tiles of TM rows x ``cols`` columns,
    tile t = (t / tn, t % tn), block i takes t = i, i + grid, ..."""
    src = (CSRC / "hopper_gemm.cuh").read_text()
    tm = 64 * int(re.search(r"constexpr int WGS = (\d+);", src).group(1))
    assert "for (int t = blockIdx.x; t < tiles; t += gridDim.x)" in src
    assert "load(s.ring + st * STAGE, &s.full[st], t / tn, t % tn, kc);" in src
    tn = -(-n // cols)
    tiles = -(-m // tm) * tn
    hits = np.zeros((m, n), np.int64)
    for i in range(grid):
        for t in range(i, tiles, grid):
            r0, c0 = (t // tn) * tm, (t % tn) * cols
            hits[r0:r0 + tm, c0:c0 + cols] += 1
    return hits


@pytest.mark.parametrize("m,n,cols,grid", [(2992, 1024, 64, 132), (2992, 1024, 128, 128),
                                           (2992, 4096, 128, 132), (37, 144, 64, 3),
                                           (193, 130, 128, 1), (9, 1040, 128, 132)])
def test_persistent_tiles_cover_each_output_once(m, n, cols, grid):
    """Every output element of ragged M and N lies in exactly one block's
    tiles, whatever the grid (pg::grid_size: min(tiles, SMs))."""
    assert (gemm_tiles(m, n, cols, grid) == 1).all()
