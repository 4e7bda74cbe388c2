"""The port's offline tools against the JAX package's on the CPU, at tiny
size: the data lists of a LibriSpeech-like tree, global CMVN statistics
with one and two worker processes, vocab conversion, and the golden fbank
signals; each through its function and its ``python -m`` entry point.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conformer_tpu.models.cmvn import load_cmvn_stats as j_load_cmvn_stats
from conformer_tpu.tools import collect_librispeech as j_collect
from conformer_tpu.tools import compute_cmvn_stats as j_cmvn
from conformer_tpu.tools import convert_vocab as j_vocab
from conformer_tpu.tools import gen_golden_fbank as j_golden
from conformer_tpu_torch.data.audio import save_wav
from conformer_tpu_torch.data.synthetic import synthetic_wav
from conformer_tpu_torch.models.cmvn import load_cmvn_stats as p_load_cmvn_stats
from conformer_tpu_torch.tools import collect_librispeech as p_collect
from conformer_tpu_torch.tools import compute_cmvn_stats as p_cmvn
from conformer_tpu_torch.tools import convert_vocab as p_vocab
from conformer_tpu_torch.tools import gen_golden_fbank as p_golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_module(name, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", f"conformer_tpu_torch.tools.{name}", *args],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def libri(tmp_path_factory):
    """A LibriSpeech-like tree: speaker/chapter/spk-chap-utt.wav with a
    .trans.txt per chapter, one wav without a transcript, an 8 kHz wav."""
    root = tmp_path_factory.mktemp("LibriSpeech")
    texts = {}
    for spk, chap, n in (("19", "198", 3), ("103", "1240", 2)):
        d = root / spk / chap
        d.mkdir(parents=True)
        lines = []
        for u in range(n):
            key = f"{spk}-{chap}-{u:04d}"
            sr = 8000 if key == "103-1240-0001" else 16000
            save_wav(str(d / f"{key}.wav"), synthetic_wav(len(texts), 0.4 + 0.3 * u, sr), sr)
            texts[key] = f"WORD{u} OF {spk}  SPEAKER"
            lines.append(f"{key} {texts[key]}")
        (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n\n")
    save_wav(str(root / "19" / "198" / "19-198-9999.wav"), synthetic_wav(9, 0.3), 16000)
    return root


def test_collect_librispeech_matches_jax(libri, tmp_path):
    n = p_collect.collect(str(libri), str(tmp_path / "port"), audio_ext="wav")
    assert n == j_collect.collect(str(libri), str(tmp_path / "jax"), audio_ext="wav") == 5
    for name in ("data.list", "transcripts.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    entries = [json.loads(line) for line in open(tmp_path / "port" / "data.list")]
    assert entries[0] == {"key": "103-1240-0000", "wav_path": str(libri / "103" / "1240" /
                          "103-1240-0000.wav"), "transcript": "WORD0 OF 103  SPEAKER"}
    out = _run_module("collect_librispeech", "--data_dir", str(libri), "--output_dir",
                      str(tmp_path / "cli"), "--audio_ext", "wav")
    assert "wrote 5 utterances" in out
    assert (tmp_path / "cli" / "data.list").read_bytes() == \
        (tmp_path / "jax" / "data.list").read_bytes()
    assert p_collect.collect(str(libri), str(tmp_path / "flac")) == 0     # the default: flac


@pytest.mark.parametrize("workers", [1, 2])
def test_compute_cmvn_stats_matches_jax(libri, tmp_path, workers):
    p_collect.collect(str(libri), str(tmp_path), audio_ext="wav")
    lst = str(tmp_path / "data.list")
    got = p_cmvn.compute(lst, str(tmp_path / "port_cmvn"), num_workers=workers)
    want = j_cmvn.compute(lst, str(tmp_path / "jax_cmvn"), num_workers=1)
    assert got["frame_num"] == want["frame_num"] == sum(
        1 + (int(s * sr) * 16000 // sr - 400) // 160
        for s, sr in ((0.4, 16000), (0.7, 16000), (1.0, 16000), (0.4, 16000), (0.7, 8000)))
    for k in ("mean_stat", "var_stat"):
        assert len(got[k]) == 80
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
        if workers == 1:
            assert got[k] == want[k]
    with open(tmp_path / "port_cmvn") as f:
        assert json.load(f) == got
    for load in (p_load_cmvn_stats, j_load_cmvn_stats):
        mean, istd = load(str(tmp_path / "port_cmvn"))
        j_mean, j_istd = j_load_cmvn_stats(str(tmp_path / "jax_cmvn"))
        np.testing.assert_allclose(mean, j_mean, rtol=1e-6)
        np.testing.assert_allclose(istd, j_istd, rtol=1e-6)
        assert np.isfinite(mean).all() and (istd > 0).all()


def test_compute_cmvn_stats_entry_point(libri, tmp_path):
    p_collect.collect(str(libri), str(tmp_path), audio_ext="wav")
    out = _run_module("compute_cmvn_stats", "--data_list", str(tmp_path / "data.list"),
                      "--output", str(tmp_path / "cmvn"), "--num_mel_bins", "40",
                      "--num_workers", "1")
    want = j_cmvn.compute(str(tmp_path / "data.list"), str(tmp_path / "jax"), num_mel_bins=40,
                          num_workers=1)
    assert f"frames: {want['frame_num']}" in out
    with open(tmp_path / "cmvn") as f:
        assert json.load(f) == want


def test_convert_vocab_matches_jax(tmp_path):
    spm = tmp_path / "bpe.vocab"
    spm.write_text("<unk>\t0\n<s>\t0\n</s>\t0\n▁THE\t-2.5\nA\t-3.1\n\n▁ΚΑΛΗ\t-4\nB\n",
                   encoding="utf-8")
    n = p_vocab.convert(str(spm), str(tmp_path / "port.txt"))
    assert n == j_vocab.convert(str(spm), str(tmp_path / "jax.txt")) == 7
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    out = _run_module("convert_vocab", "--spm_vocab", str(spm), "--output",
                      str(tmp_path / "cli.txt"))
    assert "wrote 7 entries" in out
    assert (tmp_path / "cli.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_golden_signals_and_torchaudio_gate(monkeypatch, tmp_path):
    for rate in (16000, 8000):
        got, want = p_golden.golden_signals(rate), j_golden.golden_signals(rate)
        assert sorted(got) == sorted(want) == ["chirp", "mix", "tone"]
        for k in got:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    monkeypatch.setitem(sys.modules, "torchaudio", None)
    monkeypatch.setitem(sys.modules, "torchaudio.compliance", None)
    monkeypatch.setitem(sys.modules, "torchaudio.compliance.kaldi", None)
    with pytest.raises(ImportError, match="needs torchaudio"):
        p_golden.main(["--out", str(tmp_path / "g.npz")])
    assert not (tmp_path / "g.npz").exists()


@pytest.mark.parametrize("driver", ["train", "eval", "preprocess_data"])
def test_shell_drivers(driver, libri, tmp_path):
    """scripts/torch_<driver>.sh as a user runs it, on the CPU: train and
    eval with ``--print_config --device cpu`` (the config main would run,
    with the driver's checkpoint directory; train copies the config there),
    preprocess_data on the tiny corpus (its data list and CMVN statistics
    equal the JAX tools')."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"],
               CKPT_DIR=str(tmp_path / "ckpt"), LIBRISPEECH=str(libri),
               OUT=str(tmp_path / "out"))
    extra = (["--audio_ext", "wav"] if driver == "preprocess_data"
             else ["--print_config", "--device", "cpu"])
    proc = subprocess.run(["bash", os.path.join(REPO, "scripts", f"torch_{driver}.sh"), *extra],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    if driver != "preprocess_data":
        cfg = json.loads(proc.stdout)
        assert cfg["train"]["checkpoint_dir"] == str(tmp_path / "ckpt")
        assert cfg["model"]["encoder_num_layers"] == 12        # configs/conformer_m.json
        assert (tmp_path / "ckpt" / "conformer_m.json").exists() == (driver == "train")
        return
    j_collect.collect(str(libri), str(tmp_path / "jax"), audio_ext="wav")
    for name in ("data.list", "transcripts.txt"):
        assert (tmp_path / "out" / name).read_text() == (tmp_path / "jax" / name).read_text()
    want = j_cmvn.compute(str(tmp_path / "jax" / "data.list"), str(tmp_path / "jax" / "cmvn"),
                          num_workers=1)
    with open(tmp_path / "out" / "global_cmvn") as f:
        assert json.load(f) == want
