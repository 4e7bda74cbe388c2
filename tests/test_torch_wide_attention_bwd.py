"""The wide attention path's gradients (head width 64 or 128 against a
position term of depth D = 1024, the widths the wide kernels take) in the
port against the JAX package on the CPU: the port's differentiable
``rel_flash_attention`` with autograd against ``jax.vjp`` of JAX's
``rel_flash_attention`` in interpret mode, with dropout 0.1 (the keep-mask
hash is JAX's bit for bit), ragged Tq != Tk and a head offset; then the
combined backward wrapper against the two it joins, and the scratch's
shape.

Inputs come from a seeded numpy generator. Tolerance 1e-4 abs and rel in
float32: both sides sum in float32 in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.ops.pallas.attention_kernel import rel_flash_attention as j_attention
from conformer_tpu_torch.ops import rel_attention as ra

TOL = dict(rtol=1e-4, atol=1e-4)
RATE, SEED = 0.1, 20240917


def _inputs(seed, b, h, tq, tk, dk, d):
    """q_u, ab, k, v, feats, mask, dO as float32 / bool numpy arrays: key
    lengths Tk and Tk - 7, a dead query row."""
    rng = np.random.default_rng(seed)
    q_u, g = (rng.standard_normal((b, h, tq, dk)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, tk, dk)).astype(np.float32) for _ in range(2))
    ab = (0.03 * rng.standard_normal((b, h, tq, d))).astype(np.float32)
    feats = rng.standard_normal((tk, d)).astype(np.float32)
    lens = np.array([tk, tk - 7][:b])
    mask = np.broadcast_to(np.arange(tk)[None, None, :] < lens[:, None, None], (b, tq, tk)).copy()
    mask[0, 5] = False
    return q_u, ab, k, v, feats, mask, g


def _jax_vjp(q_u, ab, k, v, feats, mask, g, scale):
    def f(q_u, ab, k, v):
        return j_attention(q_u, ab, k, v, jnp.asarray(feats), jnp.asarray(mask), scale=scale,
                           dropout_rate=RATE, dropout_seed=jnp.asarray([SEED], jnp.int32),
                           tile_q=16, tile_k=16, interpret=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q_u, ab, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("dk,tq,tk,heads", [
    (128, 24, 40, None), (64, 40, 24, None), (128, 24, 40, (2, 4)),
], ids=["dk128-Tq24-Tk40", "dk64-Tq40-Tk24", "dk128-heads2-3of4"])
def test_wide_attention_gradients_match_jax(dk, tq, tk, heads):
    """Output and dQu, dAB, dK, dV at D = 1024 (B=2), dropout 0.1 under one
    seed; ``heads`` (h_offset, h_total): the port runs heads [h_offset,
    h_total) of JAX's h_total heads, hashing the keep-mask at their global
    index."""
    b, d = 2, 1024
    h_all = heads[1] if heads else 2
    for dtype in (torch.float32, torch.bfloat16):
        assert ra.width_error(dtype, dk, d) is None and ra.route(dtype, dk, d) == "wide"
    q_u, ab, k, v, feats, mask, g = _inputs(dk + tq, b, h_all, tq, tk, dk, d)
    scale = dk ** -0.5
    want_out, want_grads = _jax_vjp(q_u, ab, k, v, feats, mask, g, scale)
    part = slice(heads[0], heads[1]) if heads else slice(None)
    kw = dict(h_total=heads[1], h_offset=heads[0]) if heads else {}
    leaves = [torch.from_numpy(np.ascontiguousarray(x[:, part])).requires_grad_()
              for x in (q_u, ab, k, v)]
    out = ra.rel_flash_attention(*leaves, torch.from_numpy(feats), torch.from_numpy(mask),
                                 scale=scale, dropout_rate=RATE,
                                 seed=torch.tensor([SEED], dtype=torch.int32), **kw)
    (out * torch.from_numpy(np.ascontiguousarray(g[:, part]))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out[:, part], **TOL)
    assert (out[0, :, 5] == 0).all()
    for leaf, want in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), want[:, part], **TOL)


def test_combined_backward_equals_the_two_wrappers():
    """``rel_attention_bwd`` (the autograd backward's call) returns what
    ``rel_attention_bwd_dq`` and ``rel_attention_bwd_dkv`` return, at the
    wide widths and a head offset, dropout 0.1; on the CPU no kernel
    launches."""
    q_u, ab, k, v, feats, mask, g = (torch.from_numpy(x) for x in
                                     _inputs(5, 2, 2, 24, 40, 128, 1024))
    seed = torch.tensor([SEED], dtype=torch.int32)
    kw = dict(scale=128 ** -0.5, dropout_rate=RATE, h_total=4, h_offset=1)
    out, lse = ra.rel_attention(q_u, ab, k, v, feats, mask, seed=seed, **kw)
    args = (q_u, ab, k, v, feats, mask, seed, g, lse, (g * out).sum(-1))
    counts = (ra.rel_attention_bwd_dq.launches, ra.rel_attention_bwd_dkv.launches)
    both = ra.rel_attention_bwd(*args, **kw)
    one_by_one = (*ra.rel_attention_bwd_dq(*args, **kw), *ra.rel_attention_bwd_dkv(*args, **kw))
    assert len(both) == 4
    for x, y in zip(both, one_by_one):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert (ra.rel_attention_bwd_dq.launches, ra.rel_attention_bwd_dkv.launches) == counts


def test_scratch_shape():
    """dS [B, H, Tq, round128(Tk)] alone for dq, with pd after it for dkv
    and the combined backward."""
    assert ra.scratch_shape(32, 8, 374, 374, pd=False) == (1, 32, 8, 374, 384)
    assert ra.scratch_shape(16, 8, 16, 528, pd=True) == (2, 16, 8, 16, 640)
    assert ra.scratch_shape(1, 1, 5, 128, pd=True) == (2, 1, 1, 5, 128)
    assert ra.scratch_shape(1, 1, 5, 129, pd=False)[-1] == 2 * ra.DS_KEYS
