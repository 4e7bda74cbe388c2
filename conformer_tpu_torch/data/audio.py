"""Audio IO, resampling and speed perturbation on the host, in NumPy and
SciPy (the port's own copy of the JAX package's ``data/audio.py``). Audio
is float32 in [-1, 1]; fbank callers scale by 2**15. WAV only: other
formats raise. Where the host audio runtime is available (``native``),
``load_audio`` decodes with it, as the JAX package does.
"""

from __future__ import annotations

import wave
from fractions import Fraction

import numpy as np
from scipy.io import wavfile as _scipy_wav
from scipy.signal import resample_poly


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """WAV file -> (mono waveform float32 [N] in [-1, 1], sample rate).
    Multi-channel audio is averaged to mono."""
    if not path.lower().endswith(".wav"):
        raise RuntimeError(f"cannot load {path!r}: only wav is supported")
    from . import native

    if native.native_available():
        with open(path, "rb") as f:
            try:
                return native.decode_wav(f.read())
            except ValueError:
                pass        # a header the runtime refuses: the parsers below
    try:
        sr, data = _scipy_wav.read(path)
    except ValueError:
        return _load_wav_stdlib(path)
    if data.dtype == np.int16:
        wavf = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wavf = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wavf = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wavf = data.astype(np.float32)
    if wavf.ndim == 2:
        wavf = wavf.mean(axis=1)
    return wavf.astype(np.float32), int(sr)


def _load_wav_stdlib(path: str) -> tuple[np.ndarray, int]:
    """The stdlib parser, for headers SciPy refuses (8- and 16-bit PCM)."""
    with wave.open(path, "rb") as w:
        sr, ch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise RuntimeError(f"unsupported wav sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data.astype(np.float32), int(sr)


def save_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM wav."""
    pcm = (np.clip(waveform, -1.0, 1.0) * 32767.0).astype(np.int16)
    _scipy_wav.write(path, sample_rate, pcm)


def resample(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling."""
    if orig_sr == new_sr:
        return waveform
    frac = Fraction(new_sr, orig_sr)
    out = resample_poly(waveform.astype(np.float64), frac.numerator, frac.denominator)
    return out.astype(np.float32)


def speed_perturb(waveform: np.ndarray, sample_rate: int, speed: float) -> np.ndarray:
    """sox-style ``speed`` (tempo and pitch): resample by 1/speed, then read
    the result at the original rate."""
    if speed == 1.0:
        return waveform
    frac = Fraction(speed).limit_denominator(100)
    out = resample_poly(waveform.astype(np.float64), frac.denominator, frac.numerator)
    return out.astype(np.float32)
