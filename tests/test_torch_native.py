"""The port's host audio runtime (``conformer_tpu_torch/data/native.py``,
built at first use from ``conformer_tpu_torch/runtime/audio_runtime.cc``)
against the JAX package's, built here from ``runtime/audio_runtime.cc``
with its Makefile into a temporary directory and pinned through
``conformer_tpu.data.native._LIB_PATHS``: the same flags and compiler on
the same machine, so every result must be equal bit for bit. Then the
port's rule for choosing the path: without g++ one RuntimeWarning and the
numpy path, a failed build or a wrong ABI raises, and processes that build
at once leave one library.
"""

import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
from scipy.io import wavfile

from conformer_tpu.data import native as j_native
from conformer_tpu_torch.data import audio as p_audio
from conformer_tpu_torch.data import native as p_native
from conformer_tpu_torch.data import processor as p_proc
from conformer_tpu_torch.ops.fbank import fbank_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's runtime, built from runtime/ into a temporary
    directory (nothing is written under runtime/) and pinned for the
    module; the old paths are put back after it."""
    build = tmp_path_factory.mktemp("jax_runtime")
    subprocess.run(["make", "-C", os.path.join(REPO, "runtime"), f"BUILD={build}"],
                   check=True, capture_output=True)
    old = j_native._LIB_PATHS[:]
    j_native._LIB_PATHS[:] = [str(build / "libaudio_runtime.so")]
    j_native._load.cache_clear()
    assert j_native.native_available()
    yield j_native
    j_native._LIB_PATHS[:] = old
    j_native._load.cache_clear()


@pytest.fixture(autouse=True)
def fresh_port_runtime():
    p_native.reset()
    yield
    p_native.reset()


def _tone(freq=600.0, secs=0.6, sr=16000):
    t = np.arange(int(sr * secs)) / sr
    return (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _noisy(seed, secs, sr=16000):
    rng = np.random.default_rng(seed)
    return (_tone(300.0 + 100 * seed, secs, sr)
            + 0.05 * rng.standard_normal(int(sr * secs))).astype(np.float32)


def _wav(data, sr=16000) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, data)
    return buf.getvalue()


WAVS = {
    "pcm16 mono": lambda: _wav((_noisy(0, 0.5) * 32767).astype(np.int16)),
    "pcm16 stereo": lambda: _wav((np.stack([_noisy(1, 0.4), _noisy(2, 0.4)], 1)
                                  * 32767).astype(np.int16), 8000),
    "pcm8": lambda: _wav((_noisy(3, 0.3) * 127 + 128).astype(np.uint8)),
    "float32": lambda: _wav(_noisy(4, 0.3)),
}


@pytest.mark.parametrize("kind", sorted(WAVS))
def test_decode_wav_bit_equal(jax_lib, kind):
    data = WAVS[kind]()
    got, sr = p_native.decode_wav(data)
    want, j_sr = jax_lib.decode_wav(data)
    assert sr == j_sr and got.dtype == np.float32 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    for mod in (p_native, jax_lib):
        with pytest.raises(ValueError):
            mod.decode_wav(b"not a wav file at all, but long enough to pass a size check")


def test_load_audio_takes_the_runtime_and_falls_through(jax_lib, tmp_path):
    """load_audio decodes with the runtime; a header the runtime refuses
    (32-bit PCM) falls through to the parsers, as in the JAX package."""
    path = tmp_path / "a.wav"
    path.write_bytes(WAVS["pcm16 stereo"]())
    got, sr = p_audio.load_audio(str(path))
    want, _ = jax_lib.decode_wav(path.read_bytes())
    np.testing.assert_array_equal(got, want)
    assert sr == 8000
    path32 = tmp_path / "b.wav"
    pcm32 = (_noisy(5, 0.2) * 2**31 * 0.9).astype(np.int32)
    path32.write_bytes(_wav(pcm32))
    with pytest.raises(ValueError):
        p_native.decode_wav(path32.read_bytes())
    got, sr = p_audio.load_audio(str(path32))
    np.testing.assert_array_equal(got, pcm32.astype(np.float32) / 2147483648.0)


@pytest.mark.parametrize("rates", [(16000, 8000), (8000, 16000), (16000, 16000)])
def test_resample_bit_equal(jax_lib, rates):
    wave = _noisy(6, 0.5, rates[0])
    got = p_native.resample(wave, *rates)
    np.testing.assert_array_equal(got, jax_lib.resample(wave, *rates))
    assert len(got) == int(len(wave) * rates[1] / rates[0])


@pytest.mark.parametrize("dither,seed", [(0.0, 0), (0.1, 1), (0.1, 42), (0.1, 2**63 - 5)])
def test_fbank_bit_equal(jax_lib, dither, seed):
    wave = _noisy(7, 0.7) * (1 << 15)
    got = p_native.fbank(wave, dither=dither, seed=seed)
    np.testing.assert_array_equal(got, jax_lib.fbank(wave, dither=dither, seed=seed))
    assert got.shape == (68, 80)
    # the runtime is the numpy fbank's counterpart: the JAX test's tolerance
    if dither == 0.0:
        np.testing.assert_allclose(got, fbank_numpy(wave), rtol=1e-3, atol=0.15)
    else:
        other = p_native.fbank(wave, dither=dither, seed=seed + 1)
        assert np.abs(got - other).max() > 0
        np.testing.assert_array_equal(got, p_native.fbank(wave, dither=dither, seed=seed))
    # 40 bins and another window: the other arguments reach the library
    np.testing.assert_array_equal(
        p_native.fbank(wave, num_mel_bins=40, frame_length=20.0, frame_shift=8.0,
                       dither=dither, seed=seed),
        jax_lib.fbank(wave, num_mel_bins=40, frame_length=20.0, frame_shift=8.0,
                      dither=dither, seed=seed))


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("dither", [0.0, 0.1])
def test_fbank_batch_bit_equal(jax_lib, threads, dither):
    waves = [_noisy(s, secs) * (1 << 15) for s, secs in ((8, 0.6), (9, 0.2), (10, 0.01),
                                                          (11, 1.1))]
    got = p_native.fbank_batch(waves, num_threads=threads, dither=dither, seed=9)
    want = jax_lib.fbank_batch(waves, num_threads=threads, dither=dither, seed=9)
    assert [g.shape for g in got] == [w.shape for w in want] == [(58, 80), (18, 80), (0, 80),
                                                                 (108, 80)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    one = p_native.fbank_batch(waves, num_threads=1, dither=dither, seed=9)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g, o)
    if dither == 0.0:
        for g, w in zip(got, waves):
            np.testing.assert_array_equal(g, p_native.fbank(w))


def _fake_runtime(monkeypatch, tmp_path, source: str):
    src = tmp_path / "fake.cc"
    src.write_text(source)
    monkeypatch.setattr(p_native, "SOURCE", src)
    monkeypatch.setattr(p_native, "BUILD_DIR", tmp_path / "host")


@pytest.mark.parametrize("source,match", [
    ('extern "C" int crt_abi_version() { return 3; }\n', "ABI v3, expected v2"),
    ('extern "C" int crt_decode_wav() { return -1; }\n', "exports no crt_abi_version"),
])
def test_wrong_abi_raises(monkeypatch, tmp_path, source, match):
    _fake_runtime(monkeypatch, tmp_path, source)
    with pytest.raises(RuntimeError, match=match):
        p_native.native_available()


def test_failed_build_raises_with_the_compiler_text(monkeypatch, tmp_path):
    _fake_runtime(monkeypatch, tmp_path, "int broken = ;\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: expected primary"):
        p_native.native_available()
    assert not list((tmp_path / "host").iterdir())      # no library, no leftover


def test_no_compiler_takes_numpy_with_one_warning(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    wave = _noisy(12, 0.5)
    sample = dict(key="k", label=[1], transcript="A", tokens=["A"], waveform=wave,
                  sample_rate=16000)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not p_native.native_available()
        assert not p_native.native_available()
        feat = next(p_proc.compute_fbank([dict(sample)], dither=0.1,
                                         rng=np.random.default_rng(3)))["feat"]
    runtime = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(runtime) == 1 and "numpy path" in str(runtime[0].message)
    np.testing.assert_array_equal(
        feat, fbank_numpy(wave * (1 << 15), dither=0.1, rng=np.random.default_rng(3)))
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        p_native.fbank(wave)


def test_hash_covers_source_flags_and_compiler(monkeypatch, tmp_path):
    cxx = p_native.compiler()
    base = p_native.library_path(cxx)
    assert base.parent == p_native.BUILD_DIR and base.name.startswith("libaudio_runtime-")
    monkeypatch.setattr(p_native, "CXXFLAGS", (*p_native.CXXFLAGS, "-g"))
    assert p_native.library_path(cxx) != base
    monkeypatch.undo()
    _fake_runtime(monkeypatch, tmp_path, p_native.SOURCE.read_text() + "// edited\n")
    assert p_native.library_path(cxx).name != base.name
    monkeypatch.undo()
    # another compiler, then another CPU: a g++ that answers one query otherwise
    for query, answer in (("--version", "g++ (Other) 99.1"),
                          ("-march=native -Q --help=target", "  -march=  znver9")):
        fake = tmp_path / "g++"
        fake.write_text(f'#!/bin/sh\nif [ "$*" = "{query}" ]; then echo "{answer}"; exit 0; fi\n'
                        f'exec {cxx} "$@"\n')
        fake.chmod(0o755)
        assert p_native.library_path(str(fake)) != base


_BUILD_ONE = """
import sys
from pathlib import Path
from conformer_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.native_available()
"""


def test_concurrent_builds_leave_one_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path / "host")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()
    files = sorted(os.listdir(tmp_path / "host"))
    assert len(files) == 1 and files[0].endswith(".so"), files
    lib = p_native.bind(tmp_path / "host" / files[0])
    assert lib.crt_abi_version() == p_native.ABI_VERSION


def test_source_is_the_jax_package_code():
    """The port's copy differs from runtime/audio_runtime.cc only by its
    header comment."""
    with open(os.path.join(REPO, "runtime", "audio_runtime.cc")) as f:
        jax_src = f.read()
    port_src = p_native.SOURCE.read_text()
    header, _, body = port_src.partition("\n//\n")
    assert body == jax_src and all(line.startswith("//") for line in header.splitlines())
