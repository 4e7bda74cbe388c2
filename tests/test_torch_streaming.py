"""The port's streaming encoder and decode against the JAX package's, on
the CPU in float32 at tiny width (``tiny_test_config``: 2 layers, D=64, 4
heads, K=7; the trained micro model: 3 layers, D=96).

Parameters come from the JAX initialisers (or the trained fixture) and
cross over through ``from_jax_params`` / ``load_jax_npz``; inputs come from
seeded numpy generators. Where JAX reaches the Pallas attention kernel it
runs in interpret mode; the port's wrapper takes its plain version on CPU
tensors. Tolerance 1e-4 abs and rel (float32 on both sides, sums in other
orders) unless a test states another; decodes agree token for token.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import ModelConfig, tiny_test_config
from conformer_tpu.decode.streaming import streaming_greedy_search as j_stream_search
from conformer_tpu.models import attention as j_att
from conformer_tpu.models import convolution as j_conv
from conformer_tpu.models import embedding as j_emb
from conformer_tpu.models import encoder as j_enc
from conformer_tpu.models.transducer import encode as j_encode
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.ops.pallas import attention_kernel as ak
from conformer_tpu.train.checkpoint import load_params_npz
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.decode.streaming import streaming_greedy_search as p_stream_search
from conformer_tpu_torch.models import attention as p_att
from conformer_tpu_torch.models import convolution as p_conv
from conformer_tpu_torch.models import encoder as p_enc
from conformer_tpu_torch.models.transducer import encode as p_encode
from conformer_tpu_torch.ops import rel_attention as pra
from conformer_tpu_torch.ops.fbank import fbank_numpy
from conformer_tpu_torch.params import from_jax_params, load_jax_npz

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dataclasses.replace(tiny_test_config().model, causal_conv=False)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "micro_trained.npz")


def _port_cfg(cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(cfg)}).model


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def _randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("cache_size", [4, 12])
@pytest.mark.parametrize("mode", ["skew", "decomposed", "kernel"])
def test_mhsa_with_cache_matches(mode, cache_size):
    """Rows with attn_len 0, partial and full; keys cache ++ new, the
    returned cache the trailing slots with length min(len + Tkv, C)."""
    d, h, q = CFG.encoder_dim, CFG.num_heads, 5
    dk = d // h
    jp = j_att.init_mhsa(jax.random.PRNGKey(7), d, h, relative=True)
    x = _randn(1, 3, q, d)
    ck, cv = _randn(2, 3, h, cache_size, dk), _randn(3, 3, h, cache_size, dk)
    length = np.array([0, cache_size // 2 + 1, cache_size], np.int32)
    j_cache = j_att.AttnCache(k=jnp.asarray(ck), v=jnp.asarray(cv), length=jnp.asarray(length))
    mask = j_att.cache_valid_mask(j_cache, q)
    k_len = cache_size + q
    table = j_emb.signed_sinusoid_table(64, d)
    pos_emb = j_emb.relative_pos_embed(table, q, k_len) if mode == "skew" else None
    rel = (cache_size + jnp.arange(q), jnp.arange(k_len)) if mode != "skew" else None
    want, want_cache = j_att.mhsa(
        jp, jnp.asarray(x), jnp.asarray(x), mask, num_heads=h, pos_emb=pos_emb,
        rel_positions=rel, cache=j_cache, use_pallas=mode == "kernel")

    fresh = p_att.init_attn_cache(3, h, cache_size, dk)
    for a, b in zip(fresh, j_att.init_attn_cache(3, h, cache_size, dk)):
        assert a.shape == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype)
        assert not a.any()
    p_cache = p_att.AttnCache(k=torch.from_numpy(ck), v=torch.from_numpy(cv),
                              length=torch.from_numpy(length))
    p_mask = p_att.cache_valid_mask(p_cache, q)
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(mask))
    xt = torch.from_numpy(x)
    got, got_cache = p_att.mhsa(
        _to_torch(jp), xt, xt, p_mask, num_heads=h,
        pos_emb=None if pos_emb is None else torch.from_numpy(np.array(pos_emb)),
        rel_positions=None if rel is None else (cache_size + torch.arange(q), torch.arange(k_len)),
        cache=p_cache, use_pallas=mode == "kernel")
    _close(got, want)
    _close(got_cache.k, want_cache.k)
    _close(got_cache.v, want_cache.v)
    np.testing.assert_array_equal(got_cache.length.numpy(), np.asarray(want_cache.length))


def test_rel_attention_plain_matches_pallas_at_chunk_shape():
    """The kernel branch's plain version against JAX's Pallas kernel in
    interpret mode at the runner's chunk shape: Tq=16, Tk=64+16, the cache
    slots masked on the left per row by attn_len 0 (a fresh session), 1,
    37 and 64 (a full cache)."""
    b, h, tq, cache, dk, d = 4, 2, 16, 64, 8, 16
    tk = cache + tq
    rng = np.random.default_rng(11)
    q_u, k, v = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, tq, dk), (b, h, tk, dk), (b, h, tk, dk)))
    ab = (0.3 * rng.standard_normal((b, h, tq, d))).astype(np.float32)
    feats = rng.standard_normal((tk, d)).astype(np.float32)
    attn_len = np.array([0, 1, 37, cache])
    j = np.arange(tk)
    valid = np.where(j[None, :] < cache, j[None, :] >= cache - attn_len[:, None], True)
    mask = np.ascontiguousarray(np.broadcast_to(valid[:, None, :], (b, tq, tk)))
    scale = 1.0 / np.sqrt(dk)
    j_out, j_lse = ak._fwd_impl(*(jnp.asarray(a) for a in (q_u, ab, k, v, feats, mask)),
                                jnp.zeros((1,), jnp.int32), scale, 16, 16, 0.0, True)
    p_out, p_lse = pra.rel_attention(*(torch.from_numpy(a) for a in (q_u, ab, k, v, feats, mask)),
                                     scale=scale)
    _close(p_out, j_out)
    _close(p_lse, j_lse)


# ------------------------------------------------------------ convolution


@pytest.mark.parametrize("chunk", [3, 9])
@pytest.mark.parametrize("causal", [False, True])
def test_conv_module_with_cache_matches(causal, chunk):
    """Three chunks carrying the cache (chunk 3 < K-1 = 6 keeps the
    trailing K-1 frames of the whole history), and the full-utterance form
    with the same ``causal``."""
    d, k = CFG.encoder_dim, CFG.kernel_size
    jp = j_conv.init_conv_module(jax.random.PRNGKey(2), d, k)
    pp = _to_torch(jp)
    j_cache = jnp.zeros((2, k - 1, d))
    p_cache = torch.zeros(2, k - 1, d)
    for i in range(3):
        x = _randn(10 + i, 2, chunk, d)
        want, j_cache = j_conv.conv_module(jp, jnp.asarray(x), None, kernel_size=k,
                                           causal=causal, cache=j_cache)
        got, p_cache = p_conv.conv_module(pp, torch.from_numpy(x), None, kernel_size=k,
                                          causal=causal, cache=p_cache)
        _close(got, want)
        _close(p_cache, j_cache)
    x = _randn(20, 2, 11, d)
    pad = np.arange(11)[None, :] < np.array([11, 4])[:, None]
    want, want_c = j_conv.conv_module(jp, jnp.asarray(x), jnp.asarray(pad), kernel_size=k,
                                      causal=causal)
    got, got_c = p_conv.conv_module(pp, torch.from_numpy(x), torch.from_numpy(pad),
                                    kernel_size=k, causal=causal)
    _close(got, want)
    _close(got_c, want_c)


# ------------------------------------------------------------ encoder


def _state_close(got, want):
    for name in ("attn_k", "attn_v", "conv_cache"):
        _close(getattr(got, name), getattr(want, name))
    for name in ("attn_len", "offset"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("kernels,rel_mode,left_chunks", [
    (False, "skew", 3), (True, "skew", 1), (False, "decomposed", 1), (True, "decomposed", 3)])
def test_encoder_forward_chunk_matches(kernels, rel_mode, left_chunks):
    """Three chunks of 4 against JAX's, the attention flag on and off (the
    conv kernel flag too: it must stay off under a conv cache), with a
    cache of three chunks or trimmed to one; then the chunk-by-chunk
    wrapper over the same frames."""
    chunk = 4
    cfg = dataclasses.replace(CFG, rel_mode=rel_mode, use_pallas_attention=kernels,
                              use_pallas_conv=kernels)
    pcfg = _port_cfg(cfg)
    jp = j_enc.init_encoder(jax.random.PRNGKey(0), cfg)
    pp = _to_torch(jp)
    stride, window, _ = j_enc.chunk_window_params(chunk)
    assert p_enc.chunk_window_params(chunk) == (stride, window, 7)
    feats = _randn(4, 2, 2 * stride + window, cfg.input_dim)
    j_state = j_enc.init_encoder_state(cfg, 2, chunk * left_chunks)
    p_state = p_enc.init_encoder_state(pcfg, 2, chunk * left_chunks)
    for i in range(3):
        f = feats[:, i * stride:i * stride + window]
        want, j_state = j_enc.encoder_forward_chunk(jp, jnp.asarray(f), j_state, cfg)
        got, p_state = p_enc.encoder_forward_chunk(pp, torch.from_numpy(f), p_state, pcfg)
        _close(got, want)
        _state_close(p_state, j_state)
    assert int(p_state.attn_len[0]) == min(3, left_chunks) * chunk
    assert int(p_state.offset[0]) == 3 * chunk
    want, want_mask = j_enc.encoder_forward_chunk_by_chunk(
        jp, jnp.asarray(feats), cfg, decoding_chunk_size=chunk,
        num_decoding_left_chunks=left_chunks)
    got, got_mask = p_enc.encoder_forward_chunk_by_chunk(
        pp, torch.from_numpy(feats), pcfg, decoding_chunk_size=chunk,
        num_decoding_left_chunks=left_chunks)
    _close(got, want)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_chunked_matches_full_context_causal():
    """Causal conv, a static chunk mask and an unlimited cache: the chunked
    forward reproduces the full forward (rtol 2e-4, atol 2e-5, as JAX's
    test_chunked_matches_full_context_causal), in the port alone."""
    chunk, n_chunks = 4, 3
    cfg = dataclasses.replace(CFG, causal_conv=True, static_chunk_size=chunk)
    pcfg = _port_cfg(cfg)
    pp = _to_torch(j_enc.init_encoder(jax.random.PRNGKey(0), cfg))
    stride, window, _ = p_enc.chunk_window_params(chunk)
    t_raw = (n_chunks - 1) * stride + window
    feats = torch.from_numpy(_randn(1, 2, t_raw, cfg.input_dim))
    full, _ = p_enc.encoder_forward(pp, feats, torch.tensor([t_raw, t_raw]), pcfg,
                                    decoding_chunk_size=chunk)
    state = p_enc.init_encoder_state(pcfg, 2, chunk * n_chunks)
    outs = []
    for i in range(n_chunks):
        y, state = p_enc.encoder_forward_chunk(pp, feats[:, i * stride:i * stride + window],
                                               state, pcfg)
        outs.append(y)
    chunked = torch.cat(outs, dim=1)
    assert chunked.shape == full.shape
    _close(chunked, full, dict(rtol=2e-4, atol=2e-5))


def test_decoding_chunk_size_is_read_only_under_live_dynamic_chunks():
    """A deterministic forward ignores decoding_chunk_size, as JAX's does
    (it is read only when dynamic chunks are live); a training forward
    with dynamic chunks takes it: > 0 a fixed chunk mask, < 0 full
    context. Dropout 0 on both sides, so the training forwards are exact."""
    cfg = dataclasses.replace(CFG, use_dynamic_chunk=True, dropout=0.0, attention_dropout=0.0)
    pcfg = _port_cfg(cfg)
    jp = j_init(jax.random.PRNGKey(3), cfg)
    pp = _to_torch(jp)
    feats = _randn(5, 2, 83, cfg.input_dim)
    lens = np.array([83, 60], np.int32)
    ft, lt = torch.from_numpy(feats), torch.from_numpy(lens)
    base, _ = p_encode(pp, ft, lt, pcfg)
    chunked, _ = p_encode(pp, ft, lt, pcfg, decoding_chunk_size=4, num_decoding_left_chunks=1)
    assert torch.equal(base, chunked)
    want, _ = j_encode(jp, jnp.asarray(feats), jnp.asarray(lens), cfg, decoding_chunk_size=4,
                       num_decoding_left_chunks=1)
    _close(chunked, want)
    outs = {}
    for size in (4, -1):
        want, _ = j_enc.encoder_forward(
            jp["encoder"], jnp.asarray(feats), jnp.asarray(lens), cfg,
            rng=jax.random.PRNGKey(9), deterministic=False, decoding_chunk_size=size,
            num_decoding_left_chunks=1)
        outs[size], _ = p_enc.encoder_forward(
            pp["encoder"], ft, lt, pcfg, deterministic=False, decoding_chunk_size=size,
            num_decoding_left_chunks=1)
        _close(outs[size], want)
    _close(outs[-1], base)
    assert not torch.allclose(outs[4], base, atol=1e-3)


# ------------------------------------------------------------ streaming decode


def _micro_cfg():
    """The model of scripts/train_micro_wer.py (vocab 24), kernel flags on."""
    return ModelConfig(
        input_dim=80, vocab_size=24, sos_eos_id=23, encoder_dim=96,
        encoder_num_layers=3, num_heads=4, hidden_dim=192, kernel_size=7,
        predictor_embed_size=64, predictor_hidden_size=64, predictor_dim=64,
        predictor_num_layers=1, join_dim=96, compute_dtype="float32",
        use_dynamic_chunk=False, use_dynamic_left_chunk=False, ctc_weight=0.2,
        attention_weight=0.3, decoder_num_layers=1, use_pruned_loss=True,
        use_pallas_attention=True, use_pallas_conv=True,
    )


def _speech_feats(seed, seconds):
    """fbank of seeded harmonic tones that change pitch every ~120 ms, padded
    to one length -> (feats [B, T, 80], lens [B])."""
    rng = np.random.default_rng(seed)
    sr = 16000
    feats = []
    for s in seconds:
        n = int(s * sr)
        t = np.arange(n) / sr
        f0 = np.repeat(rng.uniform(90, 260, n // 1920 + 1), 1920)[:n]
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(rng.uniform(0.05, 0.3) * np.sin(k * phase) for k in (1, 2, 3, 5))
        wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(n)
        feats.append(fbank_numpy(wav.astype(np.float32) * (1 << 15)))
    lens = np.array([len(f) for f in feats], np.int32)
    out = np.zeros((len(feats), lens.max(), 80), np.float32)
    for i, f in enumerate(feats):
        out[i, : len(f)] = f
    return out, lens


@pytest.fixture(scope="module")
def trained():
    return load_params_npz(FIXTURE), load_jax_npz(FIXTURE, "cpu"), _speech_feats(2, [1.3, 0.9, 0.45])


@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("left_chunks", [-1, 2])
def test_streaming_greedy_search_matches_jax_on_trained(trained, left_chunks, reset):
    """Token for token against JAX's streaming decode of the trained micro
    model (chunk 8; left chunks -1 caches max_cache_size = 32 frames)."""
    jp, pp, (feats, lens) = trained
    cfg = _micro_cfg()
    kw = dict(decoding_chunk_size=8, num_decoding_left_chunks=left_chunks, max_cache_size=32,
              n_steps=4, max_hyp_len=48, reset_predictor_per_chunk=reset)
    j_hyps, j_lens = j_stream_search(jp, jnp.asarray(feats), jnp.asarray(lens), cfg, **kw)
    p_hyps, p_lens = p_stream_search(pp, torch.from_numpy(feats), torch.from_numpy(lens),
                                     _port_cfg(cfg), **kw)
    np.testing.assert_array_equal(p_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_array_equal(p_hyps.numpy(), np.asarray(j_hyps))
    assert p_lens.max() > 0
