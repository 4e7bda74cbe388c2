"""The slice end to end: the port's encode + greedy RNN-T decode against
the JAX package's, with both kernel flags on (JAX runs its Pallas kernels
in interpret mode), on three sets of weights:

  - a tiny random init carried across as initialised: it emits on most
    frames, so it runs into the per-frame cap and the hypothesis cap;
  - the same init with +6 on the joint's blank bias (as bench.py does);
    at this tiny width the joint's logits are too flat for that, so its
    output kernel is also scaled by 8, and emissions stop short of the caps;
  - the trained tests/fixtures/micro_trained.npz, read by each package's
    own npz loader, fed fbank features of synthetic audio.

Hypotheses and lengths must be identical token for token; encoder outputs
must agree to 1e-4 (float32 on both sides).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import ModelConfig, tiny_test_config
from conformer_tpu.decode.greedy import greedy_search_batch as j_greedy
from conformer_tpu.models.transducer import encode as j_encode
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.train.checkpoint import load_params_npz
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.decode.greedy import greedy_search_batch as p_greedy
from conformer_tpu_torch.models.transducer import encode as p_encode
from conformer_tpu_torch.ops.fbank import fbank_numpy
from conformer_tpu_torch.params import from_jax_params, load_jax_npz

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "micro_trained.npz")


def _with_kernels(cfg):
    return dataclasses.replace(cfg, use_pallas_attention=True, use_pallas_conv=True)


def _port_cfg(cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(cfg)}).model


def _micro_cfg():
    """The model of scripts/train_micro_wer.py:38-61 (vocab 24)."""
    return ModelConfig(
        input_dim=80, vocab_size=24, sos_eos_id=23, encoder_dim=96,
        encoder_num_layers=3, num_heads=4, hidden_dim=192, kernel_size=7,
        predictor_embed_size=64, predictor_hidden_size=64, predictor_dim=64,
        predictor_num_layers=1, join_dim=96, compute_dtype="float32",
        use_dynamic_chunk=False, use_dynamic_left_chunk=False, ctc_weight=0.2,
        attention_weight=0.3, decoder_num_layers=1, use_pruned_loss=True,
    )


def _synthetic_speech_feats(seed, seconds):
    """fbank of seeded audio: harmonic tones that change pitch every
    ~120 ms over low noise, padded to one length. Returns (feats, lens)."""
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
    lens = np.array([f.shape[0] for f in feats], np.int32)
    out = np.zeros((len(feats), lens.max(), 80), np.float32)
    for i, f in enumerate(feats):
        out[i, : len(f)] = f
    return out, lens


def _decode_both(jp, pp, cfg, feats, lens, *, n_steps, max_hyp_len):
    j_out, j_lens = j_encode(jp, jnp.asarray(feats), jnp.asarray(lens), cfg)
    j_hyps, j_hl, _ = j_greedy(jp, j_out, j_lens, cfg, n_steps=n_steps, max_hyp_len=max_hyp_len)
    pcfg = _port_cfg(cfg)
    p_out, p_lens = p_encode(pp, torch.from_numpy(feats), torch.from_numpy(lens), pcfg)
    p_hyps, p_hl, _ = p_greedy(pp, p_out, p_lens, pcfg, n_steps=n_steps, max_hyp_len=max_hyp_len)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(p_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_array_equal(p_hl.numpy(), np.asarray(j_hl))
    np.testing.assert_array_equal(p_hyps.numpy(), np.asarray(j_hyps))
    return p_hyps.numpy(), p_hl.numpy()


@pytest.mark.parametrize("blank_bias", [0.0, 6.0])
def test_greedy_matches_on_tiny_init(blank_bias):
    cfg = _with_kernels(tiny_test_config().model)
    jp = j_init(jax.random.PRNGKey(0), cfg)
    if blank_bias:
        out = jp["joint"]["ffn_out"]
        jp["joint"]["ffn_out"] = {"kernel": out["kernel"] * 8.0,
                                  "bias": out["bias"].at[cfg.blank_id].add(blank_bias)}
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    feats = np.random.default_rng(1).standard_normal((3, 150, 80)).astype(np.float32)
    lens = np.array([150, 97, 11], np.int32)
    max_hyp_len = 48
    _, hl = _decode_both(jp, pp, cfg, feats, lens, n_steps=3, max_hyp_len=max_hyp_len)
    if blank_bias == 0.0:
        assert hl.max() == max_hyp_len          # the raw init runs into the buffer cap
    else:
        assert 0 < hl.max() < max_hyp_len       # emissions below the caps


def test_greedy_matches_on_trained_fixture():
    cfg = _with_kernels(_micro_cfg())
    jp = load_params_npz(FIXTURE)
    pp = load_jax_npz(FIXTURE, "cpu")
    feats, lens = _synthetic_speech_feats(2, [1.3, 0.9, 0.45])
    hyps, hl = _decode_both(jp, pp, cfg, feats, lens, n_steps=64, max_hyp_len=64)
    assert hl.max() > 0
