"""The port's last wide widths against the JAX package on the CPU: the
full-lattice joint at join widths past the narrow joint kernels (J 640 in
float32, 700 and 1024: their wide route) and the fused int8 FFN at
Conformer XL's D 1024 / H 4096 and at 2048 / 8192 (its wide route). Each
plain version, which the CPU runs, against JAX's Pallas kernel in
interpret mode; then a 1024-wide encoder layer on int8 route B and a
2-layer float32 full-lattice loss at join 640, each through the weights
bridge, against JAX.

Inputs from seeded numpy generators. Tolerances: float32 1e-4 (both sides
sum in float32 in other orders); bf16 and int8 as stated at each test.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import embedding as j_emb
from conformer_tpu.models import transducer as j_tr
from conformer_tpu.models.encoder import encoder_forward as j_encoder
from conformer_tpu.ops import quant as jq
from conformer_tpu.ops.pallas import joint_kernel as jk
from conformer_tpu.ops.pallas.ffn_kernel import int8_ffn_fused as j_ffn_kernel
from conformer_tpu.ops.pallas.ffn_kernel import int8_ffn_reference as j_ffn_ref
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.models import transducer as p_tr
from conformer_tpu_torch.models.encoder import encoder_forward as p_encoder
from conformer_tpu_torch.ops import int8_ffn as pif
from conformer_tpu_torch.ops import joint_lattice as p_joint
from conformer_tpu_torch.ops import quant as pq
from conformer_tpu_torch.params import from_jax_params
from conformer_tpu_torch.train.optimizer import leaf_paths

F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 enc (the model's: float32 pred, the sum in float32, x rounded to
# bf16): the plain version and JAX's kernel round x and W alike and sum in
# float32; they differ where XLA's and PyTorch's float32 tanh round a bf16
# value the other way (tests/test_torch_joint.py: BF16_FWD_TOL and its
# backward's tolerance)
BF16_FWD_TOL = dict(rtol=0, atol=2e-3)
BF16_BWD_TOL = dict(rtol=1e-2, atol=2e-3)
# JAX's own int8 FFN tolerance (tests/test_int8_ffn.py, tests/test_torch_quant.py)
INT8_TOL = dict(rtol=1e-2, atol=2e-3)
SKIP = ("predictor", "cmvn", "joint", "ctc")       # conformer_tpu/serve/runner.py:66


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _numpy_params(cfg, seed):
    """A parameter tree of ``init_transducer``'s shapes, drawn with numpy
    (tests/test_torch_wide.py's draw): matrices N(0, 1 / fan_in), norm
    scales 1 + N(0, 0.05), other vectors N(0, 0.05), the sinusoid table."""
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


# ------------------------------------------------------------------ joint

# (B, T, U, J, V, enc dtype): J 640 in float32 (Conformer-L's join_dim,
# past the narrow float32 kernels' 512), 1024 in both dtypes (past bf16's
# 640), a J of no multiple of 128 (700: the wrappers pad it to 768)
JOINT_CASES = {
    "f32-J640": (2, 9, 4, 640, 70, "float32"),
    "f32-J1024": (2, 5, 3, 1024, 45, "float32"),
    "bf16-J1024": (2, 5, 3, 1024, 45, "bfloat16"),
    "f32-J700-ragged": (3, 7, 2, 700, 130, "float32"),
}


def _pallas(enc, pred, w, bias, lab):
    return jk.joint_lattice_log_probs_pallas(enc, pred, w, bias, lab, 0, t_tile=8, v_tile=128,
                                             interpret=True)


@pytest.mark.parametrize("case", sorted(JOINT_CASES))
def test_joint_plain_matches_pallas_at_wide_j(case):
    """Forward (lp_blank, lp_emit, logZ) and both backward calls (d enc, d
    pred; dW, dbias) of the plain joint against JAX's kernel and its VJP;
    every wrapper takes the width on its wide route."""
    b, t, u, j, v, dt = JOINT_CASES[case]
    dtype = getattr(torch, dt)
    assert p_joint.width_error(dtype, j) is None and p_joint.route(dtype, j) == "wide"
    rng = np.random.default_rng(j + t)
    enc = rng.standard_normal((b, t, j)).astype(np.float32)
    pred = rng.standard_normal((b, u + 1, j)).astype(np.float32)
    w = (0.3 * rng.standard_normal((j, v)) / np.sqrt(j / 64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    lab = np.pad(labels, ((0, 0), (0, 1)))
    g_b, g_e = (rng.standard_normal((b, t, u + 1)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    jx = (jnp.asarray(enc, jdt), jnp.asarray(pred), jnp.asarray(w), jnp.asarray(bias))
    want, vjp = jax.vjp(lambda *a: _pallas(*a, jnp.asarray(lab)), *jx)
    want_g = vjp((jnp.asarray(g_b), jnp.asarray(g_e)))
    logz = jk._forward(*jx, jnp.asarray(lab), 0, 8, 128, True)[2][-1][:, :t, :u + 1]

    tx = (torch.from_numpy(enc).to(dtype), torch.from_numpy(pred), torch.from_numpy(w),
          torch.from_numpy(bias), torch.from_numpy(lab))
    got = p_joint.joint_lattice_plain_fwd(*tx, 0)
    fwd_tol = F32_TOL if dt == "float32" else BF16_FWD_TOL
    for g, wnt in zip(got, (*want, logz)):
        np.testing.assert_allclose(_np(g), _np(wnt), **fwd_tol)
    args = (*tx, got[2], torch.from_numpy(g_b), torch.from_numpy(g_e), 0)
    grads = (*p_joint.joint_lattice_plain_bwd_xp(*args), *p_joint.joint_lattice_plain_bwd_w(*args))
    grads = (grads[0].to(dtype), *grads[1:])           # JAX returns d enc in enc's dtype
    bwd_tol = F32_TOL if dt == "float32" else BF16_BWD_TOL
    for name, g, wnt in zip(("d_enc", "d_pred", "d_w", "d_bias"), grads, want_g):
        np.testing.assert_allclose(_np(g), _np(wnt), **bwd_tol, err_msg=name)


def _port_model(model_cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(model_cfg)}).model


def test_full_lattice_loss_at_join_640_matches_jax():
    """Two float32 layers, the full-lattice loss with use_pallas_joint at
    join_dim 640 (Conformer-L's): losses and every gradient leaf against
    JAX (its joint kernel in interpret mode at small tiles), 1e-4;
    parameters drawn with numpy on ``init_transducer``'s shapes."""
    cfg = dataclasses.replace(tiny_test_config().model, use_pruned_loss=False,
                              use_pallas_joint=True, join_dim=640)
    assert cfg.encoder_num_layers == 2
    jp = jax.tree.map(jnp.asarray, _numpy_params(cfg, 17))
    rng = np.random.default_rng(18)
    feats = rng.standard_normal((2, 37, cfg.input_dim)).astype(np.float32)
    feat_lens = np.array([37, 22], np.int32)
    label_lens = np.array([4, 2], np.int32)
    labels = rng.integers(1, cfg.vocab_size - 1, (2, 4)).astype(np.int32)
    labels = np.where(np.arange(4)[None, :] < label_lens[:, None], labels, 0).astype(np.int32)
    batch = (feats, feat_lens, labels, label_lens)

    def j_loss(p):
        out = j_tr.transducer_forward(p, *(jnp.asarray(a) for a in batch), cfg,
                                      deterministic=True)
        return out["loss"], out

    small = functools.partial(jk.joint_lattice_log_probs_pallas, t_tile=8, v_tile=128,
                              v_tile_bwd=128, interpret=True)
    with mock.patch.object(jk, "joint_lattice_log_probs_pallas", small):
        j_g, j_out = jax.jit(jax.grad(j_loss, has_aux=True))(jp)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    for leaf in dict(leaf_paths(pp)).values():
        leaf.requires_grad_(True)
    out = p_tr.transducer_forward(pp, *(torch.from_numpy(a) for a in batch), _port_model(cfg),
                                  deterministic=True)
    out["loss"].backward()
    for k in ("loss", "loss_ctc", "loss_rnnt"):
        np.testing.assert_allclose(_np(out[k]), _np(j_out[k]), **F32_TOL, err_msg=k)
    want = dict(leaf_paths(from_jax_params(jax.tree.map(np.asarray, j_g), "cpu")))
    got = dict(leaf_paths(pp))
    assert set(got) == set(want)
    for k, leaf in got.items():
        np.testing.assert_allclose(_np(leaf.grad), _np(want[k]), **F32_TOL, err_msg=k)


# ------------------------------------------------------------------ int8 FFN


@pytest.mark.parametrize("d,h", [(1024, 4096), (2048, 8192)], ids=["D1024-H4096", "D2048-H8192"])
def test_int8_ffn_plain_matches_pallas_at_wide(d, h):
    """The plain fused int8 FFN against JAX's reference and its Pallas
    kernel (interpret, tile_m=32) at M = 37 with an all-zero row, float32,
    at JAX's own tolerance (an ulp of the LayerNorm or the sigmoid may flip
    one int8 value at a rounding boundary); the wrapper takes the widths on
    its wide route."""
    assert pif.width_error(d, h) is None and pif.route(d, h) == "wide"
    rng = np.random.default_rng(d + h)
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
    got = pif.int8_ffn_plain(*p_args, half=0.5).numpy()
    for want in (j_ffn_ref(*j_args, half=0.5),
                 j_ffn_kernel(*j_args, half=0.5, tile_m=32, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **INT8_TOL)


def test_wide_encoder_layer_int8_route_b_matches_jax():
    """One encoder layer of width 1024 (8 heads, FFN 4096) on int8 route B
    (``quantize_tree(fuse_ffn=True)``: both FFN halves through the fused
    int8 FFN at D 1024 / H 4096), the quantized tree carried through the
    weights bridge, port vs JAX, float32. The fused FFN takes its own
    LayerNorm, where an ulp may flip an int8 value at a .5 boundary; one
    flipped hidden value moves every output of its row (by s_h s2 |w2q|,
    ~1e-3 at this width), so the limits are set against the quantization's
    own error (JAX's int8 layer against its float layer), as chip_smoke.py
    holds the kernel path: the mean within a tenth of that error's mean,
    the max within a quarter of its max (on these inputs 6 of 15 rows take
    a flip: 3.6 % and 15 %). A wrong scale, row or product moves the
    outputs by the quantization's error or more."""
    cfg = dataclasses.replace(tiny_test_config().model, input_dim=16, encoder_dim=1024,
                              num_heads=8, hidden_dim=4096, encoder_num_layers=1,
                              kernel_size=15)
    assert pif.route(cfg.encoder_dim, cfg.hidden_dim) == "wide"
    jp = jax.tree.map(jnp.asarray, _numpy_params(cfg, 41))
    jqp = jq.quantize_tree(jp, skip_keys=SKIP, fuse_ffn=True)["encoder"]
    pqp = from_jax_params(jax.tree.map(np.asarray, jqp), "cpu")
    assert pqp["layers"]["feed_forward"]["w_2"]["kernel_q"].dtype == torch.int8
    rng = np.random.default_rng(42)
    feats = rng.standard_normal((2, 39, cfg.input_dim)).astype(np.float32)
    lens = np.array([39, 27], np.int32)
    forward = jax.jit(lambda p: j_encoder(p, jnp.asarray(feats), jnp.asarray(lens), cfg))
    want, mask = forward(jqp)
    float_out, _ = forward(jp["encoder"])
    got, p_mask = p_encoder(pqp, torch.from_numpy(feats), torch.from_numpy(lens),
                            _port_model(cfg))
    assert got.shape == (2, 9, 1024)
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(mask))
    live = np.asarray(mask)[..., None]
    diff = np.abs(got.numpy() - np.asarray(want)) * live
    quant = np.abs(np.asarray(want) - np.asarray(float_out)) * live
    assert diff.mean() <= 0.1 * quant.mean() and diff.max() <= 0.25 * quant.max(), (
        diff.mean(), quant.mean(), diff.max(), quant.max())
    # the port's own quantization of the float weights is the bridged tree
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    mine = pq.quantize_tree(pp, skip_keys=SKIP, fuse_ffn=True)["encoder"]
    for half in ("feed_forward", "feed_forward_macaron"):
        for w in ("w_1", "w_2"):
            assert torch.equal(mine["layers"][half][w]["kernel_q"],
                               pqp["layers"][half][w]["kernel_q"])
