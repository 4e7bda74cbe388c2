"""The port's host features and dataset modes against the JAX package's on
the CPU: ``mfcc_numpy``, and ``AsrDataset`` batches with fbank on both
C++ runtimes (the JAX package's built from ``runtime/`` into a temporary
directory and pinned, the port's built at first use), fbank on both numpy
paths, and MFCC, in train mode at the recipe's data settings (dither 0.1,
speed perturbation, SpecAugment, shuffle, sort, bucket batching) and in
dev mode; then the eager mode. Every comparison is exact.
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest

from conformer_tpu.config import tiny_test_config
from conformer_tpu.data import dataset as j_ds
from conformer_tpu.data import native as j_native
from conformer_tpu.ops import fbank as j_fbank
from conformer_tpu.tools.gen_golden_fbank import golden_signals
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.data import dataset as p_ds
from conformer_tpu_torch.data import native as p_native
from conformer_tpu_torch.data.synthetic import synthetic_wav, write_corpus
from conformer_tpu_torch.ops import fbank as p_fbank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lib_path(tmp_path_factory):
    """The JAX package's runtime built from runtime/ into a temporary
    directory (nothing is written under runtime/)."""
    build = tmp_path_factory.mktemp("jax_runtime")
    subprocess.run(["make", "-C", os.path.join(REPO, "runtime"), f"BUILD={build}"],
                   check=True, capture_output=True)
    return str(build / "libaudio_runtime.so")


@pytest.fixture
def runtimes(jax_lib_path, monkeypatch):
    """``runtimes(native)``: both packages on their C++ runtime (True) or
    both on numpy (False); the JAX package's paths are put back after."""
    old, available = j_native._LIB_PATHS[:], p_native.native_available

    def pin(native: bool):
        j_native._LIB_PATHS[:] = [jax_lib_path] if native else []
        j_native._load.cache_clear()
        p_native.reset()
        monkeypatch.setattr(p_native, "native_available", available if native else lambda: False)
        assert j_native.native_available() is p_native.native_available() is native

    yield pin
    j_native._LIB_PATHS[:] = old
    j_native._load.cache_clear()
    p_native.reset()


# ------------------------------------------------------------------- MFCC


def _mfcc_inputs():
    sigs = golden_signals()
    sigs["synthetic"] = synthetic_wav(5, 1.3) * (1 << 15)
    return sigs


@pytest.mark.parametrize("num_ceps,num_mel_bins", [(13, 23), (40, 80)])
@pytest.mark.parametrize("lifter", [0.0, 22.0])
@pytest.mark.parametrize("dither", [0.0, 0.1])
def test_mfcc_matches_jax(num_ceps, num_mel_bins, lifter, dither):
    for name, wave in _mfcc_inputs().items():
        kw = dict(num_mel_bins=num_mel_bins, num_ceps=num_ceps, cepstral_lifter=lifter,
                  dither=dither)
        got = p_fbank.mfcc_numpy(wave, rng=np.random.default_rng(7), **kw)
        want = j_fbank.mfcc_numpy(wave, rng=np.random.default_rng(7), **kw)
        assert got.shape == (1 + (len(wave) - 400) // 160, num_ceps) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    # high_freq and low_freq reach the mel banks
    wave = _mfcc_inputs()["chirp"]
    kw = dict(low_freq=100.0, high_freq=-400.0)
    np.testing.assert_array_equal(p_fbank.mfcc_numpy(wave, **kw), j_fbank.mfcc_numpy(wave, **kw))


# ---------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return write_corpus(str(root), seed=4, n_train=9, n_dev=3, seconds=(0.6, 2.4),
                        vocab_size=64)


def _cfgs(corpus, **data):
    """(JAX data config, port data config): tiny_test_config's data (the
    recipe's dither, speed perturbation, SpecAugment, shuffle, sort and
    bucket batching) on the corpus, at small buckets."""
    cfg = tiny_test_config()
    cfg.data = dataclasses.replace(
        cfg.data, train_data_list_path=corpus["train"], dev_data_list_path=corpus["dev"],
        test_data_list_path=corpus["dev"], vocab_path=corpus["vocab"], bpe_model=None,
        cmvn_path="", bucket_boundaries=(128, 256), max_frames_in_batch=512, max_label_len=40,
        shuffle_size=4, sort_size=3, **data)
    return cfg.data, PConfig.from_dict(dataclasses.asdict(cfg)).data


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["keys"] == w["keys"] and g["transcripts"] == w["transcripts"]
        for k in ("feats", "feat_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


CASES = {"fbank native": ("fbank", True), "fbank numpy": ("fbank", False),
         "mfcc": ("mfcc", True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_and_dev_batches_match_jax(corpus, runtimes, case):
    feat_type, native = CASES[case]
    runtimes(native)
    jcfg, pcfg = _cfgs(corpus, feat_type=feat_type)
    j_train = j_ds.AsrDataset(jcfg, "train", shard_id=0, num_shards=1)
    p_train = p_ds.AsrDataset(pcfg, "train")
    for epoch in (0, 1):
        j_train.set_epoch(epoch)
        p_train.set_epoch(epoch)
        got = list(p_train)
        _assert_batches_equal(got, list(j_train))
    assert got[0]["feats"].shape[-1] == (40 if feat_type == "mfcc" else 80)
    assert p_train.padding_stats.summary() == j_train.padding_stats.summary()
    j_dev = j_ds.AsrDataset(j_ds.eval_config(jcfg), "dev", shard_id=0, num_shards=1)
    p_dev = p_ds.AsrDataset(p_ds.eval_config(pcfg), "dev")
    _assert_batches_equal(list(p_dev), list(j_dev))


def test_native_and_numpy_paths_differ_at_dither(corpus, runtimes):
    """At dither 0.1 the two paths draw differently, so which one runs
    decides the batches: this is why both sides are pinned above."""
    _, pcfg = _cfgs(corpus)
    runtimes(True)
    native = list(p_ds.AsrDataset(pcfg, "train"))
    runtimes(False)
    numpy_ = list(p_ds.AsrDataset(pcfg, "train"))
    assert any(not np.array_equal(a["feats"], b["feats"]) for a, b in zip(native, numpy_))


def test_unknown_feat_type_raises(corpus):
    _, pcfg = _cfgs(corpus, feat_type="plp")
    with pytest.raises(ValueError, match="unknown feat_type 'plp'"):
        list(p_ds.AsrDataset(pcfg, "train"))
    with pytest.raises(ValueError, match="unknown feat_type"):
        p_ds.AsrDataset(p_ds.eval_config(pcfg), "dev", eager=True)


@pytest.mark.parametrize("mode", ["train", "dev"])
def test_eager_matches_lazy_and_jax(corpus, runtimes, mode):
    runtimes(True)
    jcfg, pcfg = _cfgs(corpus)
    if mode == "dev":
        jcfg, pcfg = j_ds.eval_config(jcfg, batch_size=2), p_ds.eval_config(pcfg, batch_size=2)
    eager = p_ds.AsrDataset(pcfg, mode, eager=True)
    lazy = p_ds.AsrDataset(pcfg, mode)
    j_eager = j_ds.AsrDataset(jcfg, mode, shard_id=0, num_shards=1, eager=True)
    want = list(lazy)
    assert len(eager) == len(want) == len(j_eager) > 1
    _assert_batches_equal([eager[i] for i in range(len(eager))], want)
    _assert_batches_equal(list(eager), want)
    _assert_batches_equal(list(eager), list(j_eager))
    assert eager[-1]["keys"] == want[-1]["keys"]
    with pytest.raises(RuntimeError, match="set_epoch on an eager"):
        eager.set_epoch(1)
    with pytest.raises(TypeError, match="len"):
        len(lazy)
    with pytest.raises(TypeError, match="indexing"):
        lazy[0]
