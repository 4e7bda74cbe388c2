"""The bf16 attention at the model's head widths (<= 64) in the port, on
the CPU: which route each width takes (Conformer-M's and -L's on the
wgmma kernels fed by TMA, the wide route; Conformer-S's dk 36 forward on
the mma.sync kernel), the bf16 backward's zero-padding of widths that
are no multiples of 8 up to the wide kernels' (Conformer-S's), the
16-byte alignment the TMA boxes need, and a float32 emulation of the
wide route's bf16 rounding points held against JAX's
``rel_flash_attention`` in interpret mode.

The kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers take their plain versions. Inputs come from a seeded numpy
generator, rounded to bf16 (the kernels' inputs). Tolerance:
``chip_smoke.TOL["bfloat16"]`` (2e-2 abs + rel), the card's tolerance for
these kernels: the rounding of P, dS and pd to bf16 must stay inside it.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conformer_tpu.ops.pallas.attention_kernel import rel_flash_attention as j_attention
from conformer_tpu_torch.ops import cuda_build
from conformer_tpu_torch.ops import rel_attention as ra

CSRC = Path(ra.__file__).resolve().parents[1] / "csrc"
RATE, SEED = 0.1, 20240917


def _constant(name: str) -> int:
    """The value of ``constexpr ... name = <int>`` in the attention header."""
    found = re.search(rf"\b{name} = (\d+)", (CSRC / "rel_attention_common.cuh").read_text())
    assert found, name
    return int(found.group(1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_route_at_shipped_widths_and_chunk_shapes(dtype):
    """Conformer-M (dk 64, D 256) and -L (dk 64, D 512) take the wide route
    in bf16 (the kernels on wgmma fed by TMA, measured faster than the
    mma.sync ones there), Conformer-S (dk 36: a TMA row stride of 72
    bytes) the mma.sync forward; float32 keeps its narrow / wide routes.
    The route is a function of the widths alone, so the stream's chunk
    shapes (Tq 16 against 80 or 528 keys, a session's 14 / 5 queries) take
    their model's. No width is refused that was taken before: the mma.sync
    forward keeps every bf16 width that is no multiple of 8 while its
    block fits shared memory (``fwd_bf16_smem`` against the C limit)."""
    bf = dtype == torch.bfloat16
    assert cuda_build.SMEM_LIMIT == _constant("SMEM_LIMIT")
    for dk, d in ((64, 256), (64, 512), (32, 136), (24, 96), (8, 8), (48, 136)):
        assert ra.route(dtype, dk, d) == ("wide" if bf else "narrow")
        assert ra.width_error(dtype, dk, d) is None
    for dk, d in ((36, 144), (64, 500), (60, 256), (20, 100)):
        assert ra.route(dtype, dk, d) == "narrow"
        assert ra.width_error(dtype, dk, d) is None
    assert ra.route(dtype, 48, 528) == "wide"   # float32: D <= 512; bf16: multiples of 8
    assert ra.width_error(dtype, 48, 528) is None
    assert ra.route(dtype, 44, 528) == ("narrow" if bf else "wide")
    for dk, d in ((64, 520), (64, 576), (64, 1024), (128, 1024)):
        assert ra.route(dtype, dk, d) == "wide"
    # the narrow forward's block at its widest score depth (576) fits
    assert ra.fwd_bf16_smem(36, 512) <= cuda_build.SMEM_LIMIT
    assert ra.fwd_bf16_smem(36, 512) == 2 * (64 * 584 + 2 * 32 * (584 + 56))


@pytest.mark.parametrize("dk,d", [(36, 144), (20, 100)], ids=["S-dk36-D144", "dk20-D100"])
def test_backward_zero_padding_changes_no_gradient(dk, d):
    """The bf16 backward of a width that is no multiple of 8 runs the wide
    kernels on q+u, K, V, dO padded with zeros to ``tma_width(dk)`` and AB,
    F to ``tma_width(d)``: the plain backward on the padded operands, cut
    back to dk and D, equals the one on the operands as they are (the
    zeros add nothing to any score or product), and the padded columns of
    its gradients are zero."""
    assert (ra.tma_width(dk), ra.tma_width(d)) == (-(-dk // 8) * 8, -(-d // 8) * 8)
    assert ra.tma_width(64) == 64 and ra.tma_width(dk) % 8 == 0
    b, h, tq, tk = 2, 2, 24, 20
    q_u, ab, k, v, feats, mask, g = _inputs(7, b, h, tq, tk, dk, d)
    seed = torch.tensor([SEED], dtype=torch.int32)
    scale = dk ** -0.5
    out, lse = ra.rel_attention_plain(q_u, ab, k, v, feats, mask, scale=scale,
                                      dropout_rate=RATE, seed=seed)
    delta = (g * out).sum(-1)
    kw = dict(scale=scale, dropout_rate=RATE)
    want = ra.rel_attention_bwd_plain(q_u, ab, k, v, feats, mask, seed, g, lse, delta, **kw)
    pk, pd = ra.tma_width(dk), ra.tma_width(d)
    padded = [ra._pad_to(x, pk) for x in (q_u, k, v, g)]
    assert all(x.shape[-1] == pk and bool((x[..., dk:] == 0).all()) for x in padded)
    assert ra._pad_to(q_u, dk) is q_u
    q_p, k_p, v_p, g_p = padded
    got = ra.rel_attention_bwd_plain(q_p, ra._pad_to(ab, pd), k_p, v_p, ra._pad_to(feats, pd),
                                     mask, seed, g_p, lse, delta, **kw)
    for name, x, w, n in zip(("dQu", "dAB", "dK", "dV"), got, want, (dk, d, dk, dk)):
        torch.testing.assert_close(x[..., :n], w, rtol=1e-5, atol=1e-6, msg=name)
        assert bool((x[..., n:] == 0).all()), name


def test_tma_alignment_copies_only_unaligned_tensors():
    """The wide route reads its operands by TMA from 16-byte aligned
    addresses: ``_aligned`` passes aligned tensors through
    and copies a tensor whose data starts off 16 bytes, values kept."""
    x = torch.randn(4, 64).to(torch.bfloat16)
    off = x.view(-1)[1:].view(1, -1)[:, :64 * 3]
    assert x.data_ptr() % 16 == 0 and off.data_ptr() % 16 != 0
    same, moved = ra._aligned(x, off)
    assert same is x
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)


def _inputs(seed, b, h, tq, tk, dk, d):
    """bf16-valued float32 q_u, ab, k, v, feats, dO and a mask with keys
    Tk and Tk - 9, a dead query row and, at b > 2, a fully masked row."""
    rng = np.random.default_rng(seed)

    def bf(*shape, s=1.0):
        x = torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))
        return x.to(torch.bfloat16).float()

    q_u, g = bf(b, h, tq, dk), bf(b, h, tq, dk)
    k, v = bf(b, h, tk, dk), bf(b, h, tk, dk)
    ab, feats = bf(b, h, tq, d, s=0.2), bf(tk, d)
    lens = torch.tensor([tk, tk - 9, 0][:b])
    mask = (torch.arange(tk)[None, None, :] < lens[:, None, None]).expand(b, tq, tk).clone()
    mask[0, 5] = False
    return q_u, ab, k, v, feats, mask, g


def _wide_emulation(q_u, ab, k, v, feats, mask, g, scale, h_total, h_offset):
    """The bf16 kernels' arithmetic in float32, with bf16 rounding where
    they round: the dropped probabilities before P V (forward, wgmma's and
    mma.sync's alike; the normaliser from the unrounded ones), dS and pd
    as the wide backward's bf16 scratches, before dS [K | F], dS^T (q+u)
    and pd^T dO. Returns (out, dQu, dAB, dK, dV)."""
    def bf(x):
        return x.to(torch.bfloat16).float()

    b, h, tq, _ = q_u.shape
    tk = k.shape[2]
    m4 = mask[:, None]
    s = (q_u @ k.transpose(-1, -2) + ab @ feats.T) * scale
    s = torch.where(m4, s, torch.full_like(s, ra.NEG_INF))
    mx = s.amax(-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - mx), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    keep = ra.keep_mask(torch.tensor([SEED], dtype=torch.int32), b, h, tq, tk, RATE, "cpu",
                        h_total, h_offset)
    inv = 1.0 / (1.0 - RATE)
    live = l > 0
    out = torch.where(live, (bf(torch.where(keep, p * inv, 0.0)) @ v) / l.clamp_min(1e-30), 0.0)
    lse = torch.where(live, mx + torch.log(l.clamp_min(1e-30)), ra.LSE_BIG)[..., 0]
    out = bf(out)                                   # the kernel's output dtype
    delta = (g * out).sum(-1)
    p = torch.where(m4, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.where(keep, (g @ v.transpose(-1, -2)) * inv, torch.zeros_like(s))
    ds = bf(p * (dp - delta[..., None]) * scale)
    pd = bf(torch.where(keep, p * inv, torch.zeros_like(p)))
    return out, ds @ k, ds @ feats, ds.transpose(-1, -2) @ q_u, pd.transpose(-1, -2) @ g


@pytest.mark.parametrize("dk,d,tq,tk,heads", [
    (64, 256, 40, 56, None), (64, 512, 56, 40, None), (64, 256, 40, 56, (2, 4)),
    (36, 144, 40, 56, None),
], ids=["M-D256-Tq40-Tk56", "L-D512-Tq56-Tk40", "M-heads2-3of4", "S-dk36-D144"])
def test_bf16_rounding_points_match_jax(dk, d, tq, tk, heads):
    """The emulation of the bf16 kernels' rounding at head width 64 (D 256
    and 512, ragged Tq != Tk both ways, dropout 0.1, a dead query row, a
    fully masked batch row; ``heads`` (h_offset, h_total): heads 2-3 of
    4, the keep-mask hashed at the global head) and at Conformer-S's 36
    (D 144; its backward padded to dk 40, which changes nothing: see
    ``test_backward_zero_padding_changes_no_gradient``) against JAX's
    kernel in interpret mode and its VJP on the same bf16-valued inputs,
    within TOL["bfloat16"] abs + rel; and the emulated forward within the
    same of the port's plain version."""
    import jax

    b = 3
    h_all = heads[1] if heads else 2
    q_u, ab, k, v, feats, mask, g = _inputs(5, b, h_all, tq, tk, dk, d)
    scale = dk ** -0.5
    jm, jf = jnp.asarray(mask.numpy()), jnp.asarray(feats.numpy())

    def f(q_u, ab, k, v):
        return j_attention(q_u, ab, k, v, jf, jm, scale=scale, dropout_rate=RATE,
                           dropout_seed=jnp.asarray([SEED], jnp.int32), tile_q=16, tile_k=16,
                           interpret=True)

    j_out, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q_u, ab, k, v)))
    lo, hi = (heads[0], heads[1]) if heads else (0, h_all)
    emu = _wide_emulation(*(x[:, lo:hi] for x in (q_u, ab, k, v)), feats, mask, g[:, lo:hi],
                          scale, h_all, lo)
    # JAX's gradients for dO on this rank's heads and the emulated output
    g_j = torch.zeros_like(g)
    g_j[:, lo:hi] = g[:, lo:hi]
    want = [np.asarray(j_out)[:, lo:hi]] + [
        np.asarray(x)[:, lo:hi] for x in vjp(jnp.asarray(g_j.numpy()))]
    tol = chip_smoke.TOL["bfloat16"]
    for name, got, w in zip(("out", "dQu", "dAB", "dK", "dV"), emu, want):
        err, ok = chip_smoke.max_err(got, torch.from_numpy(np.array(w)), tol)
        assert ok, f"{name}: max abs err {err:.3g} beyond {tol} abs + rel"
    plain, _ = ra.rel_attention_plain(*(x[:, lo:hi] for x in (q_u, ab, k, v)), feats, mask,
                                      scale=scale, dropout_rate=RATE,
                                      seed=torch.tensor([SEED], dtype=torch.int32),
                                      h_total=h_all, h_offset=lo)
    err, ok = chip_smoke.max_err(emu[0], plain, tol)
    assert ok, f"out against the plain version: {err:.3g}"
    assert bool((emu[0][2] == 0).all()) and bool((emu[0][0, :, 5] == 0).all())
