"""The attention decoder and rescoring of the port against the JAX
package's: the decoder's masks and position table, its logits, loss and
gradients (``jax.grad`` at deterministic=True), ``transducer_forward``
with the attention branch on, ``attention_rescoring_batch`` and the host
``attention_rescoring`` on the trained tests/fixtures/micro_trained.npz
(one L2R decoder layer) and on a bidirectional tiny init, the weights
bridge of the decoder subtree, and ``Trainer.validate`` in all five decode
modes against JAX's decode function of each on the same features.

Float32 on both sides. Decoder logits and losses within 1e-5 relative,
gradients within 1e-4 of each leaf's max-abs, hypotheses identical.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import FIXTURE, _micro_cfg, _port_cfg, _synthetic_speech_feats

from conformer_tpu.config import tiny_test_config
from conformer_tpu.decode import rescoring as j_rs
from conformer_tpu.decode.beam_batched import beam_search_batch as j_beam
from conformer_tpu.decode.ctc_beam_batched import ctc_prefix_beam_decode_batch as j_cpb
from conformer_tpu.decode.ctc_decode import ctc_greedy_decode as j_ctc_greedy
from conformer_tpu.decode.greedy import greedy_search_batch as j_greedy
from conformer_tpu.models import decoder as j_dec
from conformer_tpu.models import embedding as j_emb
from conformer_tpu.models import masks as j_masks
from conformer_tpu.models import transducer as j_tr
from conformer_tpu.train import checkpoint as j_ckpt
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.decode import rescoring as p_rs
from conformer_tpu_torch.models import decoder as p_dec
from conformer_tpu_torch.models import embedding as p_emb
from conformer_tpu_torch.models import masks as p_masks
from conformer_tpu_torch.models import transducer as p_tr
from conformer_tpu_torch.params import from_jax_params, load_jax_npz
from conformer_tpu_torch.train import checkpoint as p_ckpt
from conformer_tpu_torch.train.loop import Trainer
from conformer_tpu_torch.train.optimizer import leaf_paths


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def _rel_close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _bi_cfg():
    return dataclasses.replace(tiny_test_config().model, decoder_num_layers=2,
                               reverse_weight=0.3, attention_weight=0.3, lsm_weight=0.1)


# ---------------------------------------------------------- building blocks


def test_masks_and_position_table_match_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(1, 60, (3, 7)).astype(np.int32)
    lens = np.array([7, 3, 0], np.int32)
    labels[1, 3:] = -1
    j_in, j_out = j_masks.add_sos_eos(jnp.asarray(labels), jnp.asarray(lens), 63, 63, -1)
    p_in, p_out = p_masks.add_sos_eos(torch.from_numpy(labels), torch.from_numpy(lens), 63, 63, -1)
    np.testing.assert_array_equal(p_in.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(p_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(
        p_masks.reverse_sequence(torch.from_numpy(labels), torch.from_numpy(lens), -1).numpy(),
        np.asarray(j_masks.reverse_sequence(jnp.asarray(labels), jnp.asarray(lens), -1)))
    np.testing.assert_array_equal(p_masks.make_subsequent_mask(6).numpy(),
                                  np.asarray(j_masks.make_subsequent_mask(6)))
    # XLA's float32 exp and torch's may differ by one ulp in a frequency (7
    # of these 32); row p of the table then moves by up to p times that
    # difference, plus one rounding of the angle p * omega and the sin / cos
    # evaluation's own error (a few 2^-24)
    d = 64
    j_freqs = np.asarray(jnp.exp(jnp.arange(0, d, 2, dtype=jnp.float32)
                                 * (-jnp.log(10000.0) / d)))      # JAX's sinusoid_table's
    p_freqs = p_emb.rel_freqs(d).numpy()
    np.testing.assert_array_max_ulp(p_freqs, j_freqs, maxulp=1)
    table = p_emb.sinusoid_table(5000, d)
    pos = np.arange(600, dtype=np.float64)[:, None]
    angle = (pos * p_freqs.astype(np.float64)).astype(np.float32)
    bound = (pos * np.abs(p_freqs.astype(np.float64) - j_freqs.astype(np.float64))
             + np.spacing(angle) + 4.0 * 2.0 ** -24)
    diff = np.abs(table[:600].numpy().astype(np.float64)
                  - np.asarray(j_emb.sinusoid_table(5000, d))[:600].astype(np.float64))
    assert (diff[:, 0::2] <= bound).all() and (diff[:, 1::2] <= bound).all(), (
        float((diff[:, 0::2] - bound).max()), float((diff[:, 1::2] - bound).max()))
    np.testing.assert_array_equal(p_emb.absolute_pos_embed(table, 4998, 5).numpy(),
                                  table[4995:].numpy())     # clamped as lax.dynamic_slice


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss_matches_jax(normalize_length):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    targets[1, 3:] = -1
    targets[2] = -1
    want = j_dec.label_smoothing_loss(jnp.asarray(logits), jnp.asarray(targets), 0.1,
                                      normalize_length=normalize_length)
    got = p_dec.label_smoothing_loss(torch.from_numpy(logits), torch.from_numpy(targets), 0.1,
                                     normalize_length=normalize_length)
    _rel_close(float(got), float(want))


def _decoder_case(name):
    """(cfg, JAX decoder params, memory, memory mask, labels, label lengths)."""
    rng = np.random.default_rng(2)
    if name == "trained":
        cfg = _micro_cfg()
        dec = j_ckpt.load_params_npz(FIXTURE)["decoder"]
    else:
        cfg = _bi_cfg()
        dec = j_dec.init_bi_decoder(jax.random.PRNGKey(3), cfg, cfg.decoder_num_layers)
    mem = rng.standard_normal((3, 11, cfg.encoder_dim)).astype(np.float32)
    mem_mask = np.arange(11)[None, :] < np.array([11, 6, 1])[:, None]
    labels = rng.integers(1, cfg.vocab_size - 1, (3, 6)).astype(np.int32)
    lens = np.array([6, 2, 0], np.int32)
    labels = np.where(np.arange(6)[None, :] < lens[:, None], labels, 0).astype(np.int32)
    return cfg, dec, mem, mem_mask, labels, lens


@pytest.mark.parametrize("name", ["trained", "bidirectional"])
def test_decoder_logits_and_loss_match_jax(name):
    cfg, jdec, mem, mem_mask, labels, lens = _decoder_case(name)
    pcfg = _port_cfg(cfg)
    j_in, _ = j_masks.add_sos_eos(jnp.asarray(labels), jnp.asarray(lens), cfg.sos_eos_id,
                                  cfg.sos_eos_id, cfg.ignore_id)
    pdec = _to_torch(jdec)
    for side in jdec:
        want = j_dec.transformer_decoder_forward(jdec[side], jnp.asarray(mem), jnp.asarray(mem_mask),
                                                 j_in, jnp.asarray(lens) + 1, cfg)
        got = p_dec.transformer_decoder_forward(pdec[side], torch.from_numpy(mem),
                                                torch.from_numpy(mem_mask),
                                                torch.from_numpy(np.array(j_in)),
                                                torch.from_numpy(lens) + 1, pcfg)
        _rel_close(got.numpy(), want)
    want = j_dec.attention_loss(jdec, jnp.asarray(mem), jnp.asarray(mem_mask),
                                jnp.asarray(labels), jnp.asarray(lens), cfg)
    got = p_dec.attention_loss(pdec, torch.from_numpy(mem), torch.from_numpy(mem_mask),
                               torch.from_numpy(labels), torch.from_numpy(lens), pcfg)
    _rel_close(float(got), float(want))


def test_decoder_grads_match_jax():
    """Both decoders' leaves and the memory, against jax.grad."""
    cfg, jdec, mem, mem_mask, labels, lens = _decoder_case("bidirectional")

    def j_loss(d, m):
        return j_dec.attention_loss(d, m, jnp.asarray(mem_mask), jnp.asarray(labels),
                                    jnp.asarray(lens), cfg)

    jg, jg_mem = jax.grad(j_loss, argnums=(0, 1))(jdec, jnp.asarray(mem))
    pdec = _to_torch(jdec)
    leaves = dict(leaf_paths(pdec))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    mem_t = torch.from_numpy(mem).requires_grad_(True)
    p_dec.attention_loss(pdec, mem_t, torch.from_numpy(mem_mask), torch.from_numpy(labels),
                         torch.from_numpy(lens), _port_cfg(cfg)).backward()
    want_g = {**dict(leaf_paths(_to_torch(jg))), "memory": torch.from_numpy(np.array(jg_mem))}
    _grads_close({**{k: v.grad for k, v in leaves.items()}, "memory": mem_t.grad}, want_g)


def _grads_close(got: dict, want: dict):
    """Each leaf within 1e-4 of its max-abs. A key projection's bias has no
    true gradient (softmax is shift-invariant along the keys): there both
    sides hold rounding noise only, below 1e-6 of the largest leaf's
    max-abs."""
    assert set(got) == set(want)
    largest = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, g in got.items():
        g, w = g.numpy(), want[k].numpy()
        if k.endswith("linear_k.bias"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * largest, k
        else:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k


def test_transducer_forward_with_attention_branch_matches_jax():
    """The losses with both decoders on (the decoder's gradients are held
    to JAX's in test_decoder_grads_match_jax); the loss reaches every
    decoder leaf."""
    cfg = _bi_cfg()
    jp = j_tr.init_transducer(jax.random.PRNGKey(6), cfg)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, 67, cfg.input_dim)).astype(np.float32)
    feat_lens = np.array([67, 41, 0], np.int32)
    label_lens = np.array([5, 3, 0], np.int32)
    labels = np.where(np.arange(5)[None, :] < label_lens[:, None],
                      rng.integers(1, cfg.vocab_size - 1, (3, 5)), 0).astype(np.int32)
    batch = (feats, feat_lens, labels, label_lens)
    want = jax.jit(lambda p, *b: j_tr.transducer_forward(p, *b, cfg, deterministic=True))(
        jp, *map(jnp.asarray, batch))
    pp = _to_torch(jp)
    leaves = dict(leaf_paths(pp["decoder"]))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    got = p_tr.transducer_forward(pp, *map(torch.from_numpy, batch), _port_cfg(cfg),
                                  deterministic=True)
    for k, rtol in (("loss_attn", 1e-5), ("loss", 1e-4), ("loss_ctc", 1e-4), ("loss_rnnt", 1e-4)):
        _rel_close(float(got[k].detach()), float(want[k]), rtol=rtol)
    got["loss"].backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in leaves.values())


def test_init_transducer_makes_the_decoder_of_the_jax_shapes():
    cfg = _bi_cfg()
    want = dict(leaf_paths(_to_torch(j_tr.init_transducer(jax.random.PRNGKey(0), cfg))))
    got = dict(leaf_paths(p_tr.init_transducer(_port_cfg(cfg))))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert "decoder.right_decoder.pos_table" in got
    one_way = dataclasses.replace(cfg, reverse_weight=0.0)
    assert "right_decoder" not in p_tr.init_transducer(_port_cfg(one_way))["decoder"]


# ------------------------------------------------------------ weights bridge


def test_bridge_carries_the_decoder_subtree(tmp_path):
    """Every key of micro_trained.npz arrives (written back, the same file
    contents); a JAX tree with both decoders of two layers goes JAX .npz ->
    port -> port .npz -> JAX leaf for leaf."""
    p_ckpt.save_params_npz(str(tmp_path / "fixture.npz"), load_jax_npz(FIXTURE))
    with np.load(FIXTURE) as want, np.load(tmp_path / "fixture.npz") as got:
        assert set(got.files) == set(want.files)
        assert any(k.startswith("decoder/left_decoder/layers/") for k in want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])
    cfg = dataclasses.replace(_bi_cfg(), decoder_num_layers=2)
    jp = j_tr.init_transducer(jax.random.PRNGKey(1), cfg)
    j_ckpt.save_params_npz(str(tmp_path / "jax.npz"), jp)
    pp = load_jax_npz(str(tmp_path / "jax.npz"))
    assert pp["decoder"]["right_decoder"]["layers"]["norm1"]["scale"].shape[0] == 2
    p_ckpt.save_params_npz(str(tmp_path / "port.npz"), pp)
    back = j_ckpt.load_params_npz(str(tmp_path / "port.npz"))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


# ---------------------------------------------------------------- rescoring


@pytest.fixture(scope="module")
def rescoring_cases():
    """name -> (cfg, JAX params, port params, encoder output, lengths)."""
    cases = {}
    cfg = _micro_cfg()
    jp = j_ckpt.load_params_npz(FIXTURE)
    feats, lens = _synthetic_speech_feats(4, [1.4, 1.0, 0.7, 0.35])
    enc, el = j_tr.encode(jp, jnp.asarray(feats), jnp.asarray(lens), cfg)
    cases["trained"] = (cfg, jp, load_jax_npz(FIXTURE, "cpu"), np.array(enc), np.array(el))
    cfg = _bi_cfg()
    jp = j_tr.init_transducer(jax.random.PRNGKey(8), cfg)
    enc = np.random.default_rng(9).standard_normal((3, 14, cfg.encoder_dim)).astype(np.float32)
    cases["bidirectional"] = (cfg, jp, _to_torch(jp), enc, np.array([14, 9, 3], np.int32))
    return cases


@pytest.mark.parametrize("name", ["trained", "bidirectional"])
def test_rescoring_batch_and_host_match_jax(rescoring_cases, name):
    cfg, jp, pp, enc, lens = rescoring_cases[name]
    pcfg = _port_cfg(cfg)
    kw = dict(beam_size=4, ctc_weight=0.5, max_hyp_len=24)
    jh, jl = j_rs.attention_rescoring_batch(jp, jnp.asarray(enc), jnp.asarray(lens), cfg,
                                            top_c=16, **kw)
    ph, pl = p_rs.attention_rescoring_batch(pp, torch.from_numpy(enc), torch.from_numpy(lens),
                                            pcfg, top_c=16, **kw)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    want = j_rs.attention_rescoring(jp, jnp.asarray(enc), jnp.asarray(lens), cfg, **kw)
    got = p_rs.attention_rescoring(pp, torch.from_numpy(enc), torch.from_numpy(lens), pcfg, **kw)
    assert got == want
    if name == "trained":
        assert min(len(h) for h in got) > 0


@pytest.mark.parametrize("reverse", [False, True])
def test_batched_decoder_scores_match_jax(rescoring_cases, reverse):
    cfg, jp, pp, enc, lens = rescoring_cases["bidirectional"]
    side = "right_decoder" if reverse else "left_decoder"
    hyps = np.random.default_rng(10).integers(1, 60, (3, 5)).astype(np.int32)
    hl = np.array([5, 2, 0], np.int32)
    mask = np.arange(enc.shape[1])[None, :] < lens[:, None]
    want = j_rs.batched_decoder_scores(jp["decoder"][side], jnp.asarray(enc), jnp.asarray(mask),
                                       jnp.asarray(hyps), jnp.asarray(hl), cfg, reverse=reverse)
    got = p_rs.batched_decoder_scores(pp["decoder"][side], torch.from_numpy(enc),
                                      torch.from_numpy(mask), torch.from_numpy(hyps),
                                      torch.from_numpy(hl), _port_cfg(cfg), reverse=reverse)
    _rel_close(got.numpy(), want)


def test_rescoring_without_decoder_raises(rescoring_cases):
    cfg, _, pp, enc, lens = rescoring_cases["trained"]
    no_dec = {k: v for k, v in pp.items() if k != "decoder"}
    for fn in (p_rs.attention_rescoring, p_rs.attention_rescoring_batch):
        with pytest.raises(ValueError, match="needs an attention decoder head"):
            fn(no_dec, torch.from_numpy(enc), torch.from_numpy(lens), _port_cfg(cfg))


# --------------------------------------------------------------- validate

_DECODE = dict(beam_size=4, beam_expansions=2, beam_blank_skip_window=4, prefix_beam_top_c=16,
               rescore_ctc_weight=0.5, max_hyp_len=32, n_steps=64)


def _jax_decode(mode, jp, cfg, enc, el):
    """JAX's ``Trainer._decode_fn`` for each mode after the encoder, on the
    same settings."""
    d = _DECODE
    if mode == "greedy_rnnt":
        h, n, _ = j_greedy(jp, enc, el, cfg, n_steps=d["n_steps"], max_hyp_len=d["max_hyp_len"])
    elif mode == "beam_rnnt":
        t, n, _ = j_beam(jp, enc, el, cfg, beam_size=d["beam_size"], max_hyp_len=d["max_hyp_len"],
                         max_expansions=d["beam_expansions"],
                         blank_skip_window=d["beam_blank_skip_window"])
        h, n = t[:, 0], n[:, 0]
    elif mode == "greedy_ctc":
        h, n = j_ctc_greedy(jp, enc, el, cfg)
    elif mode == "prefix_beam_ctc":
        t, n, _ = j_cpb(jp, enc, el, cfg, beam_size=d["beam_size"], max_hyp_len=d["max_hyp_len"],
                        top_c=d["prefix_beam_top_c"])
        h, n = t[:, 0], n[:, 0]
    else:
        h, n = j_rs.attention_rescoring_batch(
            jp, enc, el, cfg, beam_size=d["beam_size"], ctc_weight=d["rescore_ctc_weight"],
            max_hyp_len=d["max_hyp_len"], top_c=d["prefix_beam_top_c"])
    return [" ".join(map(str, np.asarray(h)[i, :int(n[i])].tolist())) for i in range(len(el))]


@pytest.fixture(scope="module")
def validation_set():
    """Two batches of synthetic speech and JAX's encoder output of each."""
    jp = j_ckpt.load_params_npz(FIXTURE)
    batches, encoded = [], []
    for i, secs in enumerate(([1.2, 0.7], [0.9, 0.5, 0.3])):
        feats, lens = _synthetic_speech_feats(20 + i, secs)
        batches.append({"feats": feats, "feat_lengths": lens,
                        "keys": [f"utt{i}_{j}" for j in range(len(secs))],
                        "transcripts": ["3 5 7 11"] * len(secs)})
        encoded.append(j_tr.encode(jp, jnp.asarray(feats), jnp.asarray(lens), _micro_cfg()))
    return batches, jp, encoded


@pytest.mark.parametrize("mode", ["greedy_rnnt", "beam_rnnt", "greedy_ctc", "prefix_beam_ctc",
                                  "attention_rescoring"])
def test_validate_matches_jax_in_every_mode(validation_set, mode, tmp_path):
    batches, jp, encoded = validation_set
    cfg = PConfig()
    cfg.model = _port_cfg(_micro_cfg())
    cfg.decode = dataclasses.replace(cfg.decode, mode=mode, **_DECODE)
    cfg.train.checkpoint_dir = str(tmp_path)
    trainer = Trainer(cfg, params=load_jax_npz(FIXTURE), device="cpu")
    wer = trainer.validate(batches)
    trainer.logger.close()
    preds = [line[len("Pred: "):] for line in open(os.path.join(tmp_path, "tmp_prediction.txt"))
             .read().splitlines() if line.startswith("Pred: ")]
    want = [p for enc, el in encoded for p in _jax_decode(mode, jp, _micro_cfg(), enc, el)]
    assert preds == want
    assert all(preds) and np.isfinite(wer)


def test_validate_refuses_an_unknown_mode(tmp_path):
    cfg = PConfig()
    cfg.model = _port_cfg(_micro_cfg())
    cfg.decode.mode = "no_such_mode"
    cfg.train.checkpoint_dir = str(tmp_path)
    trainer = Trainer(cfg, params=load_jax_npz(FIXTURE), device="cpu")
    with pytest.raises(ValueError, match="unknown decode.mode"):
        trainer.validate([])
    trainer.logger.close()
