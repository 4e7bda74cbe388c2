"""The port's micro corpus tool and micro-WER script against the JAX
package's (``conformer_tpu/tools/make_micro_corpus.py``,
``scripts/train_micro_wer.py``) on the CPU, at tiny size: the corpus from
one seeded directory of four synthetic 8 s recordings (24 train and 8 eval
utterances), byte for byte; ``build_config`` field for field; the decode
sweep on the trained ``tests/fixtures/micro_trained.npz`` in four modes,
hypothesis for hypothesis; and a ``--save-fixture`` file of two CPU steps
read back by JAX's ``load_params_npz``.
"""

import dataclasses
import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.tools import make_micro_corpus as j_tool
from conformer_tpu.train import metrics as j_metrics
from conformer_tpu.train.checkpoint import load_params_npz as j_load_npz
from conformer_tpu.train.checkpoint import save_params_npz as j_save_npz
from conformer_tpu_torch.data.synthetic import write_recordings
from conformer_tpu_torch.tools import make_micro_corpus as p_tool
from conformer_tpu_torch.train.checkpoint import load_params_npz as p_load_npz
from conformer_tpu_torch.train.checkpoint import save_params_npz as p_save_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_train_micro_wer as p_wer  # noqa: E402
import train_micro_wer as j_wer  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "fixtures", "micro_trained.npz")
SIZES = dict(n_train=24, n_eval=8)
MODES = ("greedy_rnnt", "beam_rnnt_6exp_skip8", "ctc_prefix_beam", "attention_rescoring")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("micro")
    samples = write_recordings(str(root / "samples"))
    meta_j = j_tool.build_micro_corpus(str(root / "jax"), samples_dir=samples, **SIZES)
    meta_p = p_tool.build_micro_corpus(str(root / "port"), samples_dir=samples, **SIZES)
    return root, samples, meta_j, meta_p


def _same_apart_from_root(path_j, path_p, root_j, root_p):
    with open(path_j) as f:
        text_j = f.read()
    with open(path_p) as f:
        text_p = f.read()
    assert text_p == text_j.replace(root_j, root_p)


def test_micro_corpus_matches_jax(corpora):
    root, _, meta_j, meta_p = corpora
    rj, rp = str(root / "jax"), str(root / "port")
    wavs = sorted(os.listdir(os.path.join(rj, "wav")))
    assert wavs == sorted(os.listdir(os.path.join(rp, "wav")))
    assert len(wavs) == SIZES["n_train"] + SIZES["n_eval"]
    for name in wavs:
        assert filecmp.cmp(os.path.join(rj, "wav", name), os.path.join(rp, "wav", name),
                           shallow=False), name
    for name in ("train.list", "eval.list", "meta.json"):
        _same_apart_from_root(os.path.join(rj, name), os.path.join(rp, name), rj, rp)
    assert filecmp.cmp(os.path.join(rj, "vocab.txt"), os.path.join(rp, "vocab.txt"),
                       shallow=False)
    assert meta_p == json.loads(json.dumps(meta_j).replace(rj, rp))
    assert meta_p["vocab_size"] == 24 and meta_p["n_segments"] == 64
    assert p_tool.WORDS == j_tool.WORDS


def test_micro_corpus_main_matches_jax(corpora, tmp_path, capsys):
    """``python -m conformer_tpu_torch.tools.make_micro_corpus`` with JAX's
    flags writes the function's files; --samples is required."""
    root, samples, _, _ = corpora
    out = str(tmp_path / "cli")
    p_tool.main(["--out", out, "--samples", samples, "--n-train", "24", "--n-eval", "8",
                 "--seed", "0"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["vocab_size"] == 24 and "words" not in printed
    rj = str(root / "jax")
    for name in sorted(os.listdir(os.path.join(rj, "wav"))):
        assert filecmp.cmp(os.path.join(rj, "wav", name), os.path.join(out, "wav", name),
                           shallow=False), name
    _same_apart_from_root(os.path.join(rj, "train.list"), os.path.join(out, "train.list"),
                          rj, out)
    with pytest.raises(SystemExit):
        p_tool.main(["--out", out])


def test_build_config_matches_jax(corpora):
    _, _, meta_j, _ = corpora
    for pruned in (False, True):
        cj = j_wer.build_config(meta_j, "exp", pruned=pruned, steps=123, seed=5)
        cp = p_wer.build_config(meta_j, "exp", pruned=pruned, steps=123, seed=5)
        assert dataclasses.asdict(cp) == dataclasses.asdict(cj)


def _recording_wer(module, monkeypatch):
    """Patch ``module.WordErrorRate`` so that each sweep's (hypothesis,
    truth) pairs are kept, one list per sweep."""
    sweeps = []

    class Recording(module.WordErrorRate):
        def __init__(self):
            super().__init__()
            sweeps.append([])

        def update(self, preds, refs):
            sweeps[-1].extend(zip(preds, refs))
            super().update(preds, refs)

    monkeypatch.setattr(module, "WordErrorRate", Recording)
    return sweeps


def _without_times(results: dict) -> dict:
    return {k: {**v, "eval_s": None} if isinstance(v, dict) else v for k, v in results.items()}


def test_sweep_matches_jax_on_the_fixture(corpora, monkeypatch):
    """The fixed-shape sweep on the trained weights: the same hypotheses and
    WERs as JAX's in greedy RNN-T, the blank-skipping beam, the CTC prefix
    beam and attention rescoring."""
    _, _, meta_j, meta_p = corpora
    sweeps_j = _recording_wer(j_metrics, monkeypatch)
    sweeps_p = _recording_wer(p_wer, monkeypatch)
    cfg_j = j_wer.build_config(meta_j, "exp", pruned=True, steps=0)
    res_j = j_wer.eval_decode_modes(cfg_j, j_load_npz(FIXTURE), meta_j, modes_filter=MODES)
    cfg_p = p_wer.build_config(meta_p, "exp", pruned=True, steps=0)
    details = {}
    res_p = p_wer.eval_decode_modes(cfg_p, p_load_npz(FIXTURE, "cpu"), meta_p,
                                       modes_filter=MODES, details=details)
    assert list(details) == list(MODES)
    assert len(sweeps_j) == len(sweeps_p) == len(MODES)
    for mode, pairs_j, pairs_p in zip(MODES, sweeps_j, sweeps_p):
        assert pairs_p == pairs_j, mode
        assert details[mode]["hyps"] == [h for h, _ in pairs_j]
        assert details[mode]["tokens"] > 0, mode
    assert _without_times(res_p) == _without_times(res_j)


def test_save_fixture_round_trip(corpora, tmp_path, capsys):
    """Two CPU steps of the script's ``main`` (pruned loss) and its
    ``--save-fixture``: JAX's ``load_params_npz`` reads the file, its keys
    are JAX's own params' for this config, every value the trained params'
    (``params_last``); the meta and ``wer_results.json`` have JAX's keys."""
    _, _, _, meta_p = corpora
    exp, fx = str(tmp_path / "exp"), str(tmp_path / "fx.npz")
    p_wer.main(["--corpus", os.path.dirname(meta_p["vocab_path"]), "--exp", exp,
                   "--pruned", "--steps", "2", "--cpu", "--save-fixture", fx])
    capsys.readouterr()
    trained = str(tmp_path / "trained.npz")
    p_save_npz(trained, torch.load(os.path.join(exp, "params_last"), weights_only=True))
    with np.load(trained) as f:
        flat_p = dict(f)
    j_tree = j_load_npz(fx)
    j_save_npz(str(tmp_path / "again.npz"), j_tree)
    with np.load(str(tmp_path / "again.npz")) as again:
        assert set(again.files) == set(flat_p)
        for k in again.files:
            np.testing.assert_array_equal(again[k], flat_p[k], err_msg=k)
    # JAX's params of this config name the same leaves, of the same shapes
    import jax

    cfg_j = j_wer.build_config(meta_p, exp, pruned=True, steps=2)
    assert isinstance(cfg_j.model, JModelConfig)
    # the tree init_transducer builds, traced for its shapes (jax.eval_shape)
    # rather than run: eager initialisation of every leaf took most of this
    # test's time, and only the leaves' names and shapes are compared
    shapes = jax.eval_shape(lambda key: j_init(key, cfg_j.model), jax.random.PRNGKey(0))
    j_save_npz(str(tmp_path / "init.npz"),
               jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    with np.load(str(tmp_path / "init.npz")) as init, np.load(FIXTURE) as fixture:
        assert set(init.files) == set(flat_p) == set(fixture.files)
        for k in init.files:
            assert init[k].shape == flat_p[k].shape, k
    with open(fx + ".meta.json") as f:
        meta = json.load(f)
    with open(FIXTURE + ".meta.json") as f:
        assert set(meta) == set(json.load(f))
    assert meta["steps"] == 2 and meta["pruned_loss"] and meta["vocab_size"] == 24
    with open(os.path.join(exp, "wer_results.json")) as f:
        res = json.load(f)
    assert set(meta["wer"]) == {k for k, v in res.items() if isinstance(v, dict) and "wer" in v}
    assert len(meta["wer"]) == 10 and res["steps"] == 2 and res["n_eval_utts"] == 8


def test_script_needs_the_card_unless_asked(corpora, tmp_path, monkeypatch):
    """Without --cpu the script trains on the card, with every kernel flag
    of the model on and the config otherwise ``build_config``'s: where CUDA
    is absent it raises before training; a missing corpus without --samples
    exits."""
    _, _, _, meta_p = corpora
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    given = []

    class Recording(p_wer.Trainer):
        def __init__(self, cfg, **kw):
            given.append(cfg)
            super().__init__(cfg, **kw)

    monkeypatch.setattr(p_wer, "Trainer", Recording)
    corpus = os.path.dirname(meta_p["vocab_path"])
    exp = str(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_wer.main(["--corpus", corpus, "--exp", exp, "--steps", "1"])
    (cfg,) = given
    flags = {k: v for k, v in dataclasses.asdict(cfg.model).items() if k.startswith("use_pallas")}
    assert flags and all(flags.values()), flags
    want = p_wer.build_config(meta_p, exp, pruned=False, steps=1)
    want.model = dataclasses.replace(want.model, **flags)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    with pytest.raises(SystemExit, match="--samples"):
        p_wer.main(["--corpus", str(tmp_path / "none"), "--exp", str(tmp_path / "exp2"),
                       "--cpu"])
