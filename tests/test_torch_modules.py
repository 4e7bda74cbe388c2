"""The port's modules against the JAX package's at tiny width, in float32.

Parameters come from the JAX initialisers and cross over through
``from_jax_params``; inputs come from a seeded numpy generator. Where the
JAX function reaches a Pallas kernel it runs in interpret mode. Tolerance
1e-4 abs and rel (float32 on both sides, sums in different orders).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import attention as j_att
from conformer_tpu.models import cmvn as j_cmvn
from conformer_tpu.models import convolution as j_conv
from conformer_tpu.models import embedding as j_emb
from conformer_tpu.models import encoder as j_enc
from conformer_tpu.models import masks as j_masks
from conformer_tpu.models import predictor as j_pred
from conformer_tpu.ops import fbank as j_fbank
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.models import attention as p_att
from conformer_tpu_torch.models import cmvn as p_cmvn
from conformer_tpu_torch.models import convolution as p_conv
from conformer_tpu_torch.models import embedding as p_emb
from conformer_tpu_torch.models import encoder as p_enc
from conformer_tpu_torch.models import masks as p_masks
from conformer_tpu_torch.models import predictor as p_pred
from conformer_tpu_torch.ops import fbank as p_fbank
from conformer_tpu_torch.params import from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = tiny_test_config().model


def _port_cfg(cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(cfg)}).model


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_subsampling_matches():
    jp = j_conv.init_subsampling(jax.random.PRNGKey(0), CFG.input_dim, CFG.encoder_dim)
    x = _randn(1, 2, 67, CFG.input_dim)
    want = j_conv.subsampling(jp, jnp.asarray(x))
    got = p_conv.subsampling(_to_torch(jp), torch.from_numpy(x))
    assert got.shape == (2, 16, CFG.encoder_dim)
    _close(got, want)


def test_conv_module_matches():
    d, k = CFG.encoder_dim, CFG.kernel_size
    jp = j_conv.init_conv_module(jax.random.PRNGKey(2), d, k)
    x = _randn(3, 3, 5, d)                                     # T < K-1
    lens = np.array([5, 3, 1])
    mask = np.arange(5)[None, :] < lens[:, None]
    want_y, want_c = j_conv.conv_module(jp, jnp.asarray(x), jnp.asarray(mask), kernel_size=k)
    got_y, got_c = p_conv.conv_module(_to_torch(jp), torch.from_numpy(x),
                                      torch.from_numpy(mask), kernel_size=k)
    _close(got_y, want_y)
    _close(got_c, want_c)


def _mhsa_setup(t=19, b=2, seed=4):
    d, h = CFG.encoder_dim, CFG.num_heads
    jp = j_att.init_mhsa(jax.random.PRNGKey(seed), d, h, relative=True)
    x = _randn(seed, b, t, d)
    lens = np.array([t, t - 6])
    mask = np.broadcast_to((np.arange(t)[None, :] < lens[:, None])[:, None, :], (b, t, t))
    return jp, x, np.ascontiguousarray(mask)


@pytest.mark.parametrize("mode", ["skew", "decomposed", "kernel"])
def test_mhsa_matches(mode):
    jp, x, mask = _mhsa_setup()
    t, h = x.shape[1], CFG.num_heads
    table = j_emb.signed_sinusoid_table(64, CFG.encoder_dim)
    pos_emb = j_emb.relative_pos_embed(table, t, t) if mode != "decomposed" else None
    rel = (jnp.arange(t), jnp.arange(t)) if mode != "skew" else None
    want, _ = j_att.mhsa(jp, jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask), num_heads=h,
                         pos_emb=pos_emb, rel_positions=rel, use_pallas=mode == "kernel")
    pt = torch.from_numpy(x)
    got, _ = p_att.mhsa(
        _to_torch(jp), pt, pt, torch.from_numpy(mask), num_heads=h,
        pos_emb=None if pos_emb is None else torch.from_numpy(np.array(pos_emb)),
        rel_positions=None if rel is None else (torch.arange(t), torch.arange(t)),
        use_pallas=mode == "kernel",
    )
    _close(got, want)


@pytest.mark.parametrize("kernels", [False, True])
def test_encoder_layer_matches(kernels):
    cfg = dataclasses.replace(CFG, use_pallas_attention=kernels, use_pallas_conv=kernels)
    jp = j_enc.init_encoder_layer(jax.random.PRNGKey(5), cfg)
    x = _randn(6, 2, 23, cfg.encoder_dim)
    lens = np.array([23, 9])
    pad = np.arange(23)[None, :] < lens[:, None]
    mask = np.ascontiguousarray(np.broadcast_to(pad[:, None, :], (2, 23, 23)))
    table = j_emb.signed_sinusoid_table(64, cfg.encoder_dim)
    pos_emb = j_emb.relative_pos_embed(table, 23, 23)
    want, _, want_cache = j_enc.encoder_layer(
        jp, jnp.asarray(x), jnp.asarray(mask), pos_emb, jnp.asarray(pad), cfg,
        rel_positions=(jnp.arange(23), jnp.arange(23)) if kernels else None,
        use_pallas=kernels, use_pallas_conv=kernels,
    )
    got, _, got_cache = p_enc.encoder_layer(
        _to_torch(jp), torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(np.array(pos_emb)), torch.from_numpy(pad), _port_cfg(cfg),
        rel_positions=(torch.arange(23), torch.arange(23)) if kernels else None,
        use_pallas=kernels, use_pallas_conv=kernels,
    )
    _close(got, want)
    _close(got_cache, want_cache)


@pytest.mark.parametrize(
    "kernels,rel_mode,chunk",
    [(False, "skew", -1), (True, "skew", -1), (False, "decomposed", -1), (True, "skew", 4),
     (True, "ref_abs", -1), (True, "ref_batch", 4)],
)
def test_encoder_forward_matches(kernels, rel_mode, chunk):
    cfg = dataclasses.replace(CFG, use_pallas_attention=kernels, use_pallas_conv=kernels,
                              rel_mode=rel_mode, static_chunk_size=chunk)
    jp = j_enc.init_encoder(jax.random.PRNGKey(7), cfg)
    feats = _randn(8, 3, 61, cfg.input_dim)
    lens = np.array([61, 40, 7], np.int32)
    want, want_mask = j_enc.encoder_forward(jp, jnp.asarray(feats), jnp.asarray(lens), cfg)
    got, got_mask = p_enc.encoder_forward(
        _to_torch(jp), torch.from_numpy(feats), torch.from_numpy(lens), _port_cfg(cfg)
    )
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    _close(got, want)


def test_predictor_step_matches():
    cfg = dataclasses.replace(CFG, predictor_num_layers=2)
    jp = j_pred.init_predictor(jax.random.PRNGKey(9), cfg)
    pp = _to_torch(jp)
    h0, c0 = _randn(10, 2, 3, cfg.predictor_hidden_size), _randn(11, 2, 3, cfg.predictor_hidden_size)
    tok = np.array([0, 5, 63], np.int32)
    padding = np.array([0, 1, 0], np.int32)
    want, want_st = j_pred.predictor_step(
        jp, jnp.asarray(tok), j_pred.PredictorState(jnp.asarray(h0), jnp.asarray(c0)), cfg,
        padding=jnp.asarray(padding),
    )
    got, got_st = p_pred.predictor_step(
        pp, torch.from_numpy(tok), p_pred.PredictorState(torch.from_numpy(h0), torch.from_numpy(c0)),
        _port_cfg(cfg), padding=torch.from_numpy(padding),
    )
    _close(got, want)
    _close(got_st.h, want_st.h)
    _close(got_st.c, want_st.c)
    assert torch.equal(got_st.h[:, 1], torch.from_numpy(h0)[:, 1])     # padded row holds


def test_positions_and_masks_match():
    table = p_emb.signed_sinusoid_table(50, 16)
    _close(table, j_emb.signed_sinusoid_table(50, 16))
    _close(p_emb.relative_pos_embed(table, 7, 9),
           j_emb.relative_pos_embed(j_emb.signed_sinusoid_table(50, 16), 7, 9))
    lens = np.array([0, 1, 2, 7, 11, 400], np.int32)
    np.testing.assert_array_equal(
        p_masks.subsampled_lengths(torch.from_numpy(lens)).numpy(),
        np.asarray(j_masks.subsampled_lengths(jnp.asarray(lens))),
    )
    pad = np.arange(12)[None, :] < np.array([12, 5])[:, None]
    for chunk, left in ((-1, -1), (4, -1), (3, 1)):
        want = j_masks.make_attn_mask(
            jnp.asarray(pad), use_dynamic_chunk=False, use_dynamic_left_chunk=False,
            decoding_chunk_size=0, static_chunk_size=chunk, num_decoding_left_chunks=left,
        )
        got = p_masks.make_attn_mask(torch.from_numpy(pad), static_chunk_size=chunk,
                                     num_decoding_left_chunks=left)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fbank_and_cmvn_match(tmp_path):
    wav = (0.2 * _randn(12, 16000 + 123)) * (1 << 15)
    np.testing.assert_array_equal(p_fbank.fbank_numpy(wav), j_fbank.fbank_numpy(wav))
    np.testing.assert_array_equal(p_fbank.mel_banks(23, 512, 8000.0, 60.0, -400.0),
                                  j_fbank.mel_banks(23, 512, 8000.0, 60.0, -400.0))
    stats = {"mean_stat": (_randn(13, 80) * 100).tolist(),
             "var_stat": (np.abs(_randn(14, 80)) * 1e4 + 1e5).tolist(), "frame_num": 1000}
    path = tmp_path / "cmvn.json"
    path.write_text(json.dumps(stats))
    x = _randn(15, 2, 5, 80)
    want = j_cmvn.global_cmvn(j_cmvn.init_cmvn_from_file(str(path)), jnp.asarray(x))
    got = p_cmvn.global_cmvn(p_cmvn.init_cmvn_from_file(str(path)), torch.from_numpy(x))
    _close(got, want)


def test_cmvn_identity_matches_jax():
    want = j_cmvn.init_cmvn_identity(80)
    got = p_cmvn.init_cmvn_identity(80)
    for k in ("mean", "istd"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    x = _randn(12, 2, 5, 80)
    _close(p_cmvn.global_cmvn(got, torch.from_numpy(x)), j_cmvn.global_cmvn(want, jnp.asarray(x)))
