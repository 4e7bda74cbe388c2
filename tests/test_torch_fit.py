"""The port's real-data training path against the JAX package on the CPU,
at tiny size: tokenizer, processing stages and ``AsrDataset`` batches,
``Prefetcher``, WER, checkpoints and the ``.npz`` bridge, ``Trainer.fit``
with validation and resume, and ``main``'s config handling.

Audio comes from ``conformer_tpu_torch.data.synthetic`` (seeded speech-like
wavs, a '▁'-piece vocab). Here both pipelines are held to their numpy
paths (the C++ runtimes turned off in the test): for one seed the batches
must be equal. ``test_torch_features.py`` holds them on their C++ runtimes.
"""

import dataclasses
import io
import json
import os
import struct
import time
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from conformer_tpu import main as j_main
from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import tiny_test_config
from conformer_tpu.data import dataset as j_ds
from conformer_tpu.data import native as j_native
from conformer_tpu.data import spm_reader as j_spm
from conformer_tpu.data import tokenizer as j_tok
from conformer_tpu.train import checkpoint as j_ckpt
from conformer_tpu.train import metrics as j_metrics
from conformer_tpu_torch import main as p_main
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.data import dataset as p_ds
from conformer_tpu_torch.data import native as p_native
from conformer_tpu_torch.data import spm_reader as p_spm
from conformer_tpu_torch.data import tokenizer as p_tok
from conformer_tpu_torch.data.prefetch import Prefetcher
from conformer_tpu_torch.data.synthetic import synthetic_vocab, write_corpus
from conformer_tpu_torch.models.transducer import init_transducer
from conformer_tpu_torch.train import checkpoint as p_ckpt
from conformer_tpu_torch.train import metrics as p_metrics
from conformer_tpu_torch.train.loop import Trainer
from conformer_tpu_torch.train.optimizer import leaf_paths

TRANSCRIPTS = ["HELLO WORLD", "it's a  test", "AB AB BA", "HELLO 你好 WORLD", "[noise] OK"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return write_corpus(str(root), seed=3, n_train=10, n_dev=3, seconds=(0.6, 2.4),
                        vocab_size=64)


def _tiny_cfgs(corpus, **data):
    """(JAX config, port config) of tiny_test_config on the corpus."""
    cfg = tiny_test_config()
    cfg.data = dataclasses.replace(
        cfg.data, train_data_list_path=corpus["train"], dev_data_list_path=corpus["dev"],
        test_data_list_path=corpus["dev"], vocab_path=corpus["vocab"], bpe_model=None,
        cmvn_path="", **data)
    return cfg, PConfig.from_dict(dataclasses.asdict(cfg))


# ------------------------------------------------------------ tokenizer


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b, n = n & 0x7F, n >> 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _write_model(path, pieces, model_type):
    """A SentencePiece .model protobuf, built as tests/test_spm_reader.py
    builds it."""
    buf = b"".join(
        _ld(1, _ld(1, p.encode()) + _varint((2 << 3) | 5) + struct.pack("<f", s)
            + _varint(3 << 3) + _varint(t))
        for p, s, t in pieces
    ) + _ld(2, _varint(3 << 3) + _varint(model_type))
    path.write_bytes(buf)
    return str(path)


SPM_PIECES = [("<unk>", 0.0, 2), ("▁HE", -1.0, 1), ("▁HELLO", -2.0, 1), ("LLO", -1.5, 1),
              ("▁", -4.0, 1), ("H", -5.0, 1), ("E", -5.0, 1), ("L", -5.0, 1), ("O", -5.0, 1),
              ("▁WORLD", -2.5, 1), ("AB", -1.0, 1), ("▁AB", -2.0, 1), ("A", -5.0, 1),
              ("B", -5.0, 1)] + [(f"<0x{b:02X}>", -10.0, 6) for b in range(256)]


@pytest.mark.parametrize("kind", ["char", "greedy_vocab", "unigram_model", "bpe_model"])
def test_tokenizer_matches_jax(kind, tmp_path):
    bpe = None
    if kind == "char":
        vocab = ["<blank>", "<unk>", "_", "'", *"ABCDEFGHIJKLMNOPQRSTUVWXYZ", "你", "<sos/eos>"]
    elif kind == "greedy_vocab":
        vocab = synthetic_vocab(64, 0) + ["▁HELLO", "▁WORLD"]
    else:
        bpe = _write_model(tmp_path / f"{kind}.model", SPM_PIECES, 1 if kind == "unigram_model"
                           else 2)
        vocab = ["<blank>", "<unk>", *(p for p, _, t in SPM_PIECES[1:] if t == 1), "<sos/eos>"]
        pe, je = p_spm.PureSentencePieceEncoder(bpe), j_spm.PureSentencePieceEncoder(bpe)
        for text in ("HELLO WORLD", "HEX  AB", "BA É"):
            assert pe.encode_as_pieces(text) == je.encode_as_pieces(text)
            assert pe.decode_pieces(pe.encode_as_pieces(text)) == je.decode_pieces(
                je.encode_as_pieces(text))
    path = str(tmp_path / "vocab.txt")
    p_tok.save_vocab({w: i for i, w in enumerate(vocab)}, path)
    assert p_tok.load_vocab(path) == j_tok.load_vocab(path)
    with pytest.warns(UserWarning) if bpe else _no_warning():
        jt = j_tok.Tokenizer(j_tok.load_vocab(path), bpe_model=bpe, non_lang_syms=["[NOISE]"])
    pt = p_tok.Tokenizer(p_tok.load_vocab(path), bpe_model=bpe, non_lang_syms=["[NOISE]"])
    assert type(pt.encoder).__name__ == type(jt.encoder).__name__
    for text in TRANSCRIPTS:
        tokens, ids = pt.encode(text)
        assert (tokens, ids) == jt.encode(text)
        assert pt.decode_ids(ids + [len(vocab) - 1, 5], stop_id=len(vocab) - 1) == jt.decode_ids(
            ids + [len(vocab) - 1, 5], stop_id=len(vocab) - 1)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------------ data pipeline


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["keys"] == w["keys"] and g["transcripts"] == w["transcripts"]
        for k in ("feats", "feat_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_asr_dataset_batches_match_jax(corpus, monkeypatch):
    """Train batches (speed perturbation, dither, SpecAugment, shuffle,
    sort, bucket batching) for two epochs, and dev batches, equal JAX's
    numpy path element for element."""
    monkeypatch.setattr(j_native, "native_available", lambda: False)
    monkeypatch.setattr(p_native, "native_available", lambda: False)
    jcfg, pcfg = _tiny_cfgs(corpus, bucket_boundaries=(128, 256), max_frames_in_batch=512,
                            max_label_len=40, shuffle_size=4, sort_size=3)
    j_train = j_ds.AsrDataset(jcfg.data, "train", shard_id=0, num_shards=1)
    p_train = p_ds.AsrDataset(pcfg.data, "train")
    for epoch in (0, 1):
        j_train.set_epoch(epoch)
        p_train.set_epoch(epoch)
        _assert_batches_equal(list(p_train), list(j_train))
    assert p_train.padding_stats.summary() == j_train.padding_stats.summary()
    j_dev = j_ds.AsrDataset(j_ds.eval_config(jcfg.data), "dev", shard_id=0, num_shards=1)
    p_dev = p_ds.AsrDataset(p_ds.eval_config(pcfg.data), "dev")
    _assert_batches_equal(list(p_dev), list(j_dev))
    assert p_ds.shard_list(list(range(10)), 3, 1, 3) == j_ds.shard_list(list(range(10)), 3, 1, 3)
    with pytest.raises(ValueError, match="unknown feat_type"):
        list(p_ds.AsrDataset(dataclasses.replace(pcfg.data, feat_type="plp"), "train"))


def test_prefetcher_order_errors_and_close():
    assert list(Prefetcher(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        raise KeyError("boom")

    it = Prefetcher(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = Prefetcher(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n <= 3 + 2 + 2       # the producer stopped
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


def test_wer_matches_jax():
    preds = ["HELLO WORLD", "A B C", "", "THE CAT SAT"]
    refs = ["HELLO WORLD", "A C", "ONE TWO", "THE HAT SAT ON"]
    pw, jw = p_metrics.WordErrorRate(), j_metrics.WordErrorRate()
    pw.update(preds, refs)
    jw.update(preds, refs)
    assert (pw.errors, pw.total, pw.compute()) == (jw.errors, jw.total, jw.compute())
    assert p_metrics.edit_distance(list("kitten"), list("sitting")) == 3


# ------------------------------------------------------------ checkpoints


def _tiny_params():
    cfg = PConfig.from_dict(dataclasses.asdict(tiny_test_config()))
    return init_transducer(cfg.model, 0, "cpu")


def test_checkpoint_save_gc_last_and_restore(tmp_path):
    params = _tiny_params()
    d = str(tmp_path / "ckpt")
    for step, wer in ((1, None), (2, 0.5), (3, None)):
        path = p_ckpt.save_checkpoint(d, {"params": params, "opt_state": {"count": step},
                                          "step": step}, step=step, wer=wer, keep=2)
    names = sorted(os.listdir(d))
    assert names == ["last", "params_last", "step_2-wer_0.500000", "step_3"]
    assert open(os.path.join(d, "last")).read() == "step_3"
    assert p_ckpt.latest_checkpoint(d) == path
    state = p_ckpt.restore_checkpoint(path, "cpu")
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    for (k, a), (_, b) in zip(leaf_paths(params), leaf_paths(state["params"])):
        assert torch.equal(a, b), k
    served = p_ckpt.restore_params(d)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaf_paths(params),
                                                           leaf_paths(served)))


def test_params_npz_loads_in_jax(tmp_path):
    params = _tiny_params()
    path = str(tmp_path / "p.npz")
    p_ckpt.save_params_npz(path, params)
    want = dict(leaf_paths(params))
    got = j_ckpt.load_params_npz(path)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(want)
    for kpath, leaf in flat:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kpath)
        np.testing.assert_array_equal(np.asarray(leaf), want[key].numpy(), err_msg=key)
    back = dict(leaf_paths(p_ckpt.load_params_npz(path)))
    assert all(torch.equal(back[k], v) for k, v in want.items())


# ------------------------------------------------------------ fit


def test_fit_validates_checkpoints_and_resumes(corpus, tmp_path):
    """Two steps with one validation, then a resume to step 3 from
    ``last``: params, optimizer state and step restored exactly."""
    _, pcfg = _tiny_cfgs(corpus, batch_type="static", batch_size=3, prefetch_depth=2)
    ckpt = str(tmp_path / "ckpt")
    pcfg.train = dataclasses.replace(pcfg.train, max_steps=2, val_check_interval=2, log_every=1,
                                     num_sanity_val_steps=1, checkpoint_dir=ckpt, accum_grad=2)
    pcfg.decode = dataclasses.replace(pcfg.decode, max_hyp_len=8, n_steps=2)
    trainer = Trainer(pcfg, device="cpu")
    trainer.fit()
    trainer.logger.close()
    assert trainer.step == 2
    names = set(os.listdir(ckpt))
    assert {"last", "params_last", "step_2", "tmp_prediction.txt", "metrics.jsonl"} <= names
    assert any(n.startswith("step_2-wer_") for n in names)
    recs = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
    train = [r for r in recs if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["train_grad_norm"])
               and r["train_audio_s"] > 0 for r in train)
    wer = [r["valid_wer"] for r in recs if "valid_wer" in r]
    assert len(wer) == 1 and np.isfinite(wer[0])

    saved = {k: v.detach().clone() for k, v in leaf_paths(trainer.params)}
    resumed = Trainer(dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, max_steps=3, resume_from="last", num_sanity_val_steps=0)), device="cpu")
    resumed.restore("last")
    assert resumed.step == 2 and resumed.opt_state.count == 2
    assert all(torch.equal(v, saved[k]) for k, v in leaf_paths(resumed.params))
    resumed.fit()
    resumed.logger.close()
    assert resumed.step == 3 and resumed.opt_state.count == 3
    assert open(os.path.join(ckpt, "last")).read() == "step_3"


def test_validate_refuses_unported_modes(corpus):
    """Every decode mode of JAX is ported (tests/test_torch_rescoring.py
    holds each to JAX's); an unknown mode is refused with JAX's ValueError,
    and attention rescoring on params without a decoder raises."""
    _, pcfg = _tiny_cfgs(corpus)
    pcfg.decode.mode = "beam_rnnt"
    trainer = Trainer(pcfg, device="cpu")
    dev = p_ds.AsrDataset(p_ds.eval_config(pcfg.data), "dev", tokenizer=trainer.tokenizer)
    assert np.isfinite(trainer.validate(dev, max_batches=1))
    pcfg.decode.mode = "no_such_mode"
    with pytest.raises(ValueError, match="unknown decode.mode"):
        trainer.validate(dev)
    pcfg.decode.mode = "attention_rescoring"
    with pytest.raises(ValueError, match="needs an attention decoder head"):
        trainer.validate(dev, max_batches=1)
    # streaming evaluation decodes whatever decode.mode says, as in JAX
    # (tests/test_torch_stream_serve.py holds it to JAX's decode)
    pcfg.decode.streaming = True
    pcfg.decode.mode = "no_such_mode"
    assert np.isfinite(trainer.validate(dev, max_batches=1))


# ------------------------------------------------------------ main


@pytest.mark.parametrize("overrides", [
    [],
    ["model.use_pallas_attention=true", "train.max_steps=4", "train.val_check_interval=2",
     "data.bpe_model=null", "data.bucket_boundaries=[128, 256]", "train.lr=0.002"],
])
def test_main_print_config_matches_jax(overrides):
    argv = ["--config", "configs/conformer_m.json", "--print_config", "--resume_from", "last"]
    argv += ["--set", *overrides] if overrides else []
    outs = []
    for fn in (j_main.main, p_main.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert fn(argv) == 0
        outs.append(json.loads(buf.getvalue()))
    assert outs[1] == outs[0]
    cfg = JConfig.from_json_file("configs/conformer_m.json").apply_overrides(overrides)
    assert PConfig.from_json_file("configs/conformer_m.json").apply_overrides(
        overrides).to_json() == cfg.to_json()
    with pytest.raises(KeyError):
        PConfig().apply_overrides(["model.no_such_field=1"])


def test_main_runs_on_the_card_unless_asked(monkeypatch, corpus):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_main.main(["--set", f"data.vocab_path={corpus['vocab']}", "--eval"])
    # the multi-process flags (tests/test_torch_distributed.py runs them):
    # --print_config joins no group; a process count without a coordinator
    # raises before anything is built
    for flag in (["--coordinator", "localhost:1"], ["--num_processes", "2"]):
        assert p_main.main(flag + ["--print_config"]) == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--coordinator"):
        p_main.main(["--num_processes", "2", "--device", "cpu", "--set",
                     f"data.vocab_path={corpus['vocab']}", "--eval"])
