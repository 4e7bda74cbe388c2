"""The port's plain kernel versions against the JAX Pallas kernels (run in
interpret mode on the CPU), and the wrappers' CPU dispatch.

Inputs come from a seeded numpy generator and go through both packages in
float32. Tolerance 1e-4 abs and rel: both sides compute in float32 with
sums in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.ops.pallas import attention_kernel as ak
from conformer_tpu.ops.pallas import conv_kernel as ck
from conformer_tpu_torch.ops import conv_block as pcb
from conformer_tpu_torch.ops import ctc_dp as pcd
from conformer_tpu_torch.ops import int8_ffn as pif
from conformer_tpu_torch.ops import int8_matmul as pim
from conformer_tpu_torch.ops import joint_lattice as pjl
from conformer_tpu_torch.ops import rel_attention as pra
from conformer_tpu_torch.ops import rnnt_lattice as prl

TOL = dict(rtol=1e-4, atol=1e-4)


def _attn_inputs(seed, b, h, tq, tk, dk, d, lengths, dead_rows=()):
    rng = np.random.default_rng(seed)
    q_u = rng.standard_normal((b, h, tq, dk)).astype(np.float32)
    ab = (0.3 * rng.standard_normal((b, h, tq, d))).astype(np.float32)
    k = rng.standard_normal((b, h, tk, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, dk)).astype(np.float32)
    feats = rng.standard_normal((tk, d)).astype(np.float32)
    mask = np.arange(tk)[None, None, :] < np.asarray(lengths)[:, None, None]
    mask = np.broadcast_to(mask, (b, tq, tk)).copy()
    for bi, row in dead_rows:
        mask[bi, row, :] = False
    return q_u, ab, k, v, feats, mask


@pytest.mark.parametrize(
    "tq,tk,lengths,dead_rows,dk,d",
    [
        (37, 37, [37, 30, 1], [(0, 5)], 8, 16),      # T a multiple of no tile; a dead row
        (29, 37, [37, 12, 37], [(2, 28)], 8, 16),    # Tq != Tk (keys include a left cache)
        (16, 16, [16, 16, 16], [(1, 0), (1, 15)], 8, 16),
        (21, 21, [21, 9, 1], [(0, 3)], 36, 144),     # Conformer-S: d=144, 4 heads
        (21, 21, [21, 14, 21], [(2, 20)], 64, 512),  # Conformer-L: d=512, 8 heads
    ],
    ids=["37-37-lengths0-dead_rows0", "29-37-lengths1-dead_rows1",
         "16-16-lengths2-dead_rows2", "conformer_s-dk36-D144", "conformer_l-dk64-D512"],
)
def test_rel_attention_plain_matches_pallas(tq, tk, lengths, dead_rows, dk, d):
    b, h = 3, 2
    q_u, ab, k, v, feats, mask = _attn_inputs(0, b, h, tq, tk, dk, d, lengths, dead_rows)
    scale = 1.0 / np.sqrt(dk)
    j_out, j_lse = ak._fwd_impl(
        *(jnp.asarray(a) for a in (q_u, ab, k, v, feats, mask)),
        jnp.zeros((1,), jnp.int32), scale, 16, 16, 0.0, True,
    )
    p_out, p_lse = pra.rel_attention_plain(
        *(torch.from_numpy(a) for a in (q_u, ab, k, v, feats, mask)), scale=scale
    )
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), **TOL)
    for bi, row in dead_rows:
        assert (p_out[bi, :, row] == 0).all()
        assert (p_lse[bi, :, row] == pra.LSE_BIG).all()


def test_rel_attention_wrapper_takes_plain_on_cpu():
    q_u, ab, k, v, feats, mask = _attn_inputs(1, 2, 2, 11, 11, 8, 16, [11, 4])
    args = [torch.from_numpy(a) for a in (q_u, ab, k, v, feats, mask)]
    before = pra.rel_attention.launches
    out, lse = pra.rel_attention(*args, scale=0.3)
    ref_out, ref_lse = pra.rel_attention_plain(*args, scale=0.3)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert pra.rel_attention.launches == before


def test_kernel_width_limits():
    """The widths the CUDA wrappers take, checked before any launch: every
    shipped attention width (Conformer-S, M, L) in bf16 and in float32,
    Conformer-M's and -L's bf16 on the wide kernels and the others on the
    narrow ones, and the 1024-wide Conformer's (dk 128, D 1024; dk
    64, D 1024) and D 2048 on the wide ones, refusing dk past 128 and, in
    bf16's wide path, dk or D not a multiple of 8; the DP kernels past 1024
    states (their shared-memory limits); the conv block at every shipped
    width (D 144, 256, 512 with K = 15) on the narrow kernels and at D 1024
    (K 15, 32, 64), D 2048 and float32 D 512 with K 31 on the wide ones,
    refusing D past 2048 or not a multiple of 16 and K past 64; the joint
    kernels at every shipped join width (J 320, 512, 640) in bf16 on the
    narrow kernels (J padded to a multiple of 128), float32 at every J and
    every wider bf16 J (641 and above) on the wide route, refusing only a J
    below 1 or an enc dtype other than float32 and bf16; the int8 kernels at every shipped width (the matmul's K = D:
    144, 256, 512; the FFN's D / H: 144 / 576, 256 / 2048, 512 / 2048) on
    the narrow kernels, refusing K past 1024; the FFN past D 512 or H 2048
    (Conformer XL's 1024 / 4096, 2048 / 8192) on its wide route, refusing
    only D or H below 1."""
    for d in (144, 256, 512):
        for dtype in (torch.bfloat16, torch.float32):
            assert pcb.width_error(dtype, d, 15) is None
            assert pcb.route(dtype, d, 15) == "narrow"
    for dtype in (torch.bfloat16, torch.float32):
        for k in (15, 32, 64):
            assert pcb.width_error(dtype, 1024, k) is None
            assert pcb.route(dtype, 1024, k) == "wide"
        assert pcb.width_error(dtype, 2048, 31) is None
        assert pcb.width_error(dtype, 528, 15) is None
        assert "up to 2048" in pcb.width_error(dtype, 2064, 15)
        assert pcb.width_error(dtype, 150, 15) is not None
        assert "K <= 64" in pcb.width_error(dtype, 1024, 65)
    assert pcb.width_error(torch.bfloat16, 512, 32) is None
    assert pcb.route(torch.bfloat16, 512, 33) == "wide"
    assert pcb.width_error(torch.float32, 512, 31) is None
    assert pcb.route(torch.float32, 512, 31) == "wide"
    assert pcb.route(torch.float32, 512, 17) == "narrow"
    for j in (320, 512, 640):
        assert pjl.width_error(torch.bfloat16, j) is None
        assert pjl.route(torch.bfloat16, j) == "narrow"
    for j in (320, 512):
        assert pjl.width_error(torch.float32, j) is None
        assert pjl.route(torch.float32, j) == pjl.route(torch.float32, j, "bwd") == "wide"
    for dtype, wide in ((torch.bfloat16, (641, 700, 1024, 2048)),
                        (torch.float32, (513, 640, 700, 1024, 2048))):
        for j in wide:
            assert pjl.width_error(dtype, j) is None
            assert pjl.route(dtype, j) == "wide"
        assert "positive" in pjl.width_error(dtype, 0)
    assert "float32 or bfloat16" in pjl.width_error(torch.float16, 512)
    for dtype in (torch.bfloat16, torch.float32):
        for dk, d in ((36, 144), (64, 256), (64, 512)):
            assert pra.width_error(dtype, dk, d) is None
            wide = dtype == torch.bfloat16 and dk % 8 == 0
            assert pra.route(dtype, dk, d) == ("wide" if wide else "narrow")
        for dk, d in ((128, 1024), (64, 1024), (128, 2048), (96, 768), (64, 576)):
            assert pra.width_error(dtype, dk, d) is None
            assert pra.route(dtype, dk, d) == "wide"
        assert "dk=136 > 128" in pra.width_error(dtype, 136, 1024)
    assert "multiples of 8" in pra.width_error(torch.bfloat16, 68, 1024)
    assert "multiples of 8" in pra.width_error(torch.bfloat16, 64, 1028)
    assert pra.width_error(torch.float32, 68, 1028) is None
    for k in (144, 256, 512, 1024):
        assert pim.width_error(k) is None
    assert "K <= 1024" in pim.width_error(1056)
    for d, h in ((144, 576), (256, 2048), (512, 2048)):
        assert pif.width_error(d, h) is None
        assert pif.route(d, h) == "narrow"
    for d, h in ((544, 2048), (512, 2080), (1024, 4096), (2048, 8192)):
        assert pif.width_error(d, h) is None
        assert pif.route(d, h) == "wide"
    assert "D >= 1 and H >= 1" in pif.width_error(0, 2048)
    assert "D >= 1 and H >= 1" in pif.width_error(512, 0)
    assert pcd.max_states() == 29056
    assert prl.max_u1(374) == 28869 and prl.max_u1(1300) > 1024


@pytest.mark.parametrize("script", ["torch_attention_ablation", "torch_joint_ablation",
                                    "torch_conv_ablation", "torch_simple_lattice_ablation",
                                    "torch_int8_ablation", "torch_rnnt_lattice_ablation",
                                    "torch_ctc_dp_ablation", "torch_fbank_ablation"])
def test_ablation_texts_apply_to_the_kernels(script):
    """Every stage that an ablation script takes out of a kernel is a text
    substitution in that kernel's source; each must still apply to the
    source as it stands, or the script fails on the card."""
    import importlib
    import sys
    from pathlib import Path

    scripts = Path(__file__).resolve().parents[1] / "scripts"
    sys.path.insert(0, str(scripts))
    try:
        mod = importlib.import_module(script)
        base = importlib.import_module("torch_attention_ablation")
    finally:
        sys.path.remove(str(scripts))
    csrc = Path(pra.__file__).resolve().parents[1] / "csrc"
    for name, source, subs in mod.ABLATIONS:
        text = (csrc / f"{source}.cu").read_text()
        out = base.variant_source(text, subs)
        assert (out == text) == (not subs), name


def _conv_params(seed, d, k):
    rng = np.random.default_rng(seed)

    def u(*shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    p_conv = {
        "pointwise_conv1": {"kernel": u(1, d, 2 * d, bound=d ** -0.5), "bias": u(2 * d, bound=d ** -0.5)},
        "depthwise_conv": {"kernel": u(k, 1, d, bound=k ** -0.5), "bias": u(d, bound=k ** -0.5)},
        "norm": {"scale": 1.0 + u(d, bound=0.2), "bias": u(d, bound=0.1)},
        "pointwise_conv2": {"kernel": u(1, d, d, bound=d ** -0.5), "bias": u(d, bound=d ** -0.5)},
    }
    p_norm = {"scale": 1.1 + u(d, bound=0.1), "bias": u(d, bound=0.05)}
    return p_norm, p_conv


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.mark.parametrize(
    "t,k,lengths,d",
    [
        (29, 15, [29, 17, 1], 32),    # T a multiple of no tile
        (9, 15, [9, 6, 1], 32),       # T < K-1: zero-left-padded cache
        (40, 7, [40, 40, 33], 32),
        (21, 15, [21, 14, 1], 144),   # Conformer-S's width
        (9, 15, [9, 9, 4], 144),
        (21, 15, [21, 9, 21], 512),   # Conformer-L's width
        (9, 15, [9, 2, 9], 512),
    ],
    ids=["29-15-lengths0", "9-15-lengths1", "40-7-lengths2", "conformer_s-D144-T21",
         "conformer_s-D144-T9", "conformer_l-D512-T21", "conformer_l-D512-T9"],
)
def test_conv_block_plain_matches_pallas(t, k, lengths, d):
    b = 3
    p_norm, p_conv = _conv_params(2, d, k)
    x = np.random.default_rng(3).standard_normal((b, t, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    j_out, j_cache = ck.conv_block_fused(
        jnp.asarray(x), jnp.asarray(lens), _tree(jnp.asarray, p_norm),
        _tree(jnp.asarray, p_conv), kernel_size=k, interpret=True,
    )
    p_out, p_cache = pcb.conv_block_plain(
        torch.from_numpy(x), torch.from_numpy(lens), _tree(torch.from_numpy, p_norm),
        _tree(torch.from_numpy, p_conv), kernel_size=k,
    )
    assert p_cache.shape == (b, k - 1, d)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(p_cache.numpy(), np.asarray(j_cache), **TOL)


def test_conv_block_wrapper_takes_plain_on_cpu():
    p_norm, p_conv = _conv_params(4, 32, 7)
    p_norm, p_conv = _tree(torch.from_numpy, p_norm), _tree(torch.from_numpy, p_conv)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 10, 32)).astype(np.float32))
    lens = torch.tensor([10, 3])
    before = pcb.conv_block.launches
    out, cache = pcb.conv_block(x, lens, p_norm, p_conv, kernel_size=7)
    ref_out, ref_cache = pcb.conv_block_plain(x, lens, p_norm, p_conv, kernel_size=7)
    assert torch.equal(out, ref_out) and torch.equal(cache, ref_cache)
    assert pcb.conv_block.launches == before
