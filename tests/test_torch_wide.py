"""The port at the widths of a 1024-wide Conformer (Conformer XL's: d=1024,
8 heads of 128, FFN 4096), which its attention and conv-block kernels take
on their wide path: each plain version the CPU runs against the JAX Pallas
kernel in interpret mode, and one encoder layer of that width with its
loss through the weights bridge.

Inputs come from a seeded numpy generator; parameters from the JAX
initialisers through ``from_jax_params``. Tolerance 1e-4 abs and rel in
float32: both sides sum in float32 in different orders.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import convolution as j_conv
from conformer_tpu.models import embedding as j_emb
from conformer_tpu.models import layers as j_layers
from conformer_tpu.models import transducer as j_tr
from conformer_tpu.ops.pallas import attention_kernel as ak
from conformer_tpu.ops.pallas import conv_kernel as ck
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.models import transducer as p_tr
from conformer_tpu_torch.ops import conv_block as pcb
from conformer_tpu_torch.ops import rel_attention as pra
from conformer_tpu_torch.params import from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_rel_flash_attention_wide_matches_pallas():
    """Forward and gradient at dk=128, D=1024 (B=1, H=2, T=40): key padding
    to 31 of 40 and a dead query row."""
    b, h, t, dk, d = 1, 2, 40, 128, 1024
    for dtype in (torch.float32, torch.bfloat16):
        assert pra.width_error(dtype, dk, d) is None and pra.route(dtype, dk, d) == "wide"
    rng = np.random.default_rng(21)
    q_u, k, v, cot = (rng.standard_normal((b, h, t, dk)).astype(np.float32) for _ in range(4))
    ab = (0.03 * rng.standard_normal((b, h, t, d))).astype(np.float32)
    feats = rng.standard_normal((t, d)).astype(np.float32)
    mask = np.broadcast_to(np.arange(t)[None, None, :] < 31, (b, t, t)).copy()
    mask[0, 7, :] = False
    scale = dk ** -0.5

    def j_loss(q_u, ab, k, v):
        out = ak.rel_flash_attention(q_u, ab, k, v, jnp.asarray(feats), jnp.asarray(mask),
                                     scale=scale, tile_q=16, tile_k=16, interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (j_g, j_out) = jax.grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (q_u, ab, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q_u, ab, k, v)]
    out = pra.rel_flash_attention(*leaves, torch.from_numpy(feats), torch.from_numpy(mask),
                                  scale=scale)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, j_out)
    assert (out[0, :, 7] == 0).all()
    for leaf, want in zip(leaves, j_g):
        _close(leaf.grad, want)


@pytest.mark.parametrize("d,k", [(1024, 32), (512, 31)], ids=["D1024-K32", "D512-K31"])
def test_conv_block_wide_matches_pallas(d, k):
    """Output and cache at lengths [40, 23] (B=2, T=40)."""
    assert pcb.width_error(torch.float32, d, k) is None
    assert pcb.route(torch.float32, d, k) == "wide"
    keys = jax.random.split(jax.random.PRNGKey(d + k), 2)
    p_conv = j_conv.init_conv_module(keys[0], d, k)
    p_norm = j_layers.init_layer_norm(d)
    p_norm["scale"] = p_norm["scale"] * 1.1 + 0.05
    x = np.random.default_rng(d + k).standard_normal((2, 40, d)).astype(np.float32)
    lengths = np.array([40, 23], np.int32)
    want, want_cache = ck.conv_block_fused(jnp.asarray(x), jnp.asarray(lengths), p_norm, p_conv,
                                           kernel_size=k, interpret=True)
    got, got_cache = pcb.conv_block(torch.from_numpy(x), torch.from_numpy(lengths),
                                    _to_torch(p_norm), _to_torch(p_conv), kernel_size=k)
    _close(got, want)
    _close(got_cache, want_cache)


def _numpy_params(cfg, seed):
    """A parameter tree of ``init_transducer``'s shapes (``jax.eval_shape``),
    drawn with numpy, which is seconds faster than JAX's initialisers at
    this width on the CPU: matrices N(0, 1 / fan_in), norm scales 1 +
    N(0, 0.05), other vectors N(0, 0.05); the fixed sinusoid table as JAX
    makes it."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(j_tr.init_transducer, cfg=cfg),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['pos_table']"):
            return np.asarray(j_emb.signed_sinusoid_table(cfg.max_len, cfg.encoder_dim))
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:   # the encoder layers' leaves stack a layer axis first
            layers = cfg.encoder_num_layers if "['layers']" in name else 1
            return x / np.sqrt(np.prod(leaf.shape[:-1]) / layers)
        return 1.0 + 0.05 * x if name.endswith("['scale']") else 0.05 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_wide_encoder_layer_and_loss_match_jax():
    """One encoder layer of width 1024 (8 heads, FFN 4096, K = 15), both
    encoder kernel flags on, the pruned loss with CTC: encoder output and
    loss terms, T' = 9 (16 input features: the subsampling's width is
    d_model's all the same)."""
    cfg = dataclasses.replace(
        tiny_test_config().model, input_dim=16, encoder_dim=1024, num_heads=8,
        hidden_dim=4096, encoder_num_layers=1, kernel_size=15, use_pallas_attention=True,
        use_pallas_conv=True, use_pruned_loss=True, prune_range=3,
    )
    jp = _numpy_params(cfg, 31)
    rng = np.random.default_rng(31)
    feats = rng.standard_normal((2, 39, cfg.input_dim)).astype(np.float32)
    feat_lens = np.array([39, 27], np.int32)
    labels = rng.integers(1, cfg.vocab_size - 1, (2, 4)).astype(np.int32)
    label_lens = np.array([4, 2], np.int32)
    labels = np.where(np.arange(4)[None, :] < label_lens[:, None], labels, 0).astype(np.int32)
    batch = (feats, feat_lens, labels, label_lens)
    forward = jax.jit(functools.partial(j_tr.transducer_forward, cfg=cfg, deterministic=True))
    want = forward(jax.tree.map(jnp.asarray, jp), *(jnp.asarray(a) for a in batch))
    pcfg = PConfig.from_dict({"model": dataclasses.asdict(cfg)}).model
    got = p_tr.transducer_forward(_to_torch(jp), *(torch.from_numpy(a) for a in batch), pcfg,
                                  deterministic=True)
    assert got["encoder_out"].shape == (2, 9, 1024)
    _close(got["encoder_out"], want["encoder_out"])
    for key in ("loss", "loss_ctc", "loss_rnnt", "loss_simple"):
        _close(got[key], want[key])
