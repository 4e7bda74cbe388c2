"""Kaldi-compatible log-mel fbank and MFCC on the host, in NumPy (the port's
own copy of the JAX package's ``ops/fbank.py`` ``fbank_numpy``,
``mfcc_numpy`` and their helpers).

Semantics of Kaldi's compute-fbank-feats with the recipe's settings:
waveform pre-scaled by 2**15 by the caller; snip_edges framing; optional
Gaussian dither; per-frame DC removal; preemphasis 0.97 with first-sample
replication; povey window (hann**0.85); FFT at the next power of two;
power spectrum; triangular mel banks (Kaldi mel scale 1127*ln(1+f/700),
nyquist bin dropped); log with a float32-epsilon floor. Float32 throughout.
"""

from __future__ import annotations

import math

import numpy as np

_EPSILON = 1.1920928955078125e-07  # float32 machine epsilon (Kaldi EPSILON)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def frame_params(sample_rate: float, frame_length_ms: float, frame_shift_ms: float):
    """(window size, window shift, padded FFT length) in samples."""
    window_size = int(sample_rate * frame_length_ms * 0.001)
    window_shift = int(sample_rate * frame_shift_ms * 0.001)
    return window_size, window_shift, _next_pow2(window_size)


def num_frames(num_samples: int, window_size: int, window_shift: int) -> int:
    """snip_edges=True frame count."""
    if num_samples < window_size:
        return 0
    return 1 + (num_samples - window_size) // window_shift


def povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2 * math.pi * n / (window_size - 1))) ** 0.85


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(
    num_bins: int,
    window_length_padded: int,
    sample_rate: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Triangular mel filterbank [num_bins, window_length_padded // 2]."""
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"bad mel range [{low_freq}, {high_freq}] for nyquist {nyquist}")
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel_freqs = mel_scale(sample_rate / window_length_padded * np.arange(num_fft_bins))
    bins = np.zeros((num_bins, num_fft_bins), np.float64)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[b] = np.maximum(0.0, np.minimum(up, down))
    return bins


def fbank_numpy(
    waveform: np.ndarray,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    dither: float = 0.0,
    preemphasis_coefficient: float = 0.97,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """waveform [N] (already x 2**15) -> log-mel fbank [T, num_mel_bins] float32."""
    waveform = np.asarray(waveform, np.float32).reshape(-1)
    ws, shift, padded = frame_params(sample_rate, frame_length, frame_shift)
    t = num_frames(len(waveform), ws, shift)
    if t == 0:
        return np.zeros((0, num_mel_bins), np.float32)

    frames = waveform[np.arange(ws)[None, :] + shift * np.arange(t)[:, None]]
    if dither != 0.0:
        rng = rng or np.random.default_rng()
        frames = frames + (dither * rng.standard_normal(frames.shape)).astype(np.float32)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True, dtype=np.float32)
    if preemphasis_coefficient != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - np.float32(preemphasis_coefficient) * prev
    frames = frames * povey_window(ws)[None, :].astype(np.float32)

    spec = np.fft.rfft(frames.astype(np.float32), n=padded, axis=1)
    power = (spec.real.astype(np.float32) ** 2 + spec.imag.astype(np.float32) ** 2)[
        :, : padded // 2
    ]
    banks = mel_banks(num_mel_bins, padded, sample_rate, low_freq, high_freq).astype(
        np.float32
    )
    mel_e = power @ banks.T
    return np.log(np.maximum(mel_e, np.float32(_EPSILON))).astype(np.float32)


def mfcc_numpy(
    waveform: np.ndarray,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 23,
    num_ceps: int = 13,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    dither: float = 0.0,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    cepstral_lifter: float = 22.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Kaldi-style MFCC: the orthonormal DCT-II of the log-mel fbank in
    float64, its first ``num_ceps`` coefficients, then the sine lifter
    (none at ``cepstral_lifter`` 0) -> [T, num_ceps] float32."""
    logmel = fbank_numpy(waveform, sample_rate, num_mel_bins, frame_length, frame_shift,
                         dither, low_freq=low_freq, high_freq=high_freq,
                         rng=rng).astype(np.float64)
    m = num_mel_bins
    k = np.arange(num_ceps)[:, None]
    n = np.arange(m)[None, :]
    dct = np.cos(math.pi * k * (2 * n + 1) / (2 * m)) * math.sqrt(2.0 / m)
    dct[0] *= 1.0 / math.sqrt(2.0)
    ceps = logmel @ dct.T
    if cepstral_lifter != 0.0:
        ceps = ceps * (1.0 + 0.5 * cepstral_lifter
                       * np.sin(math.pi * np.arange(num_ceps) / cepstral_lifter))
    return ceps.astype(np.float32)


def dft_matrices(window_size: int, padded: int) -> tuple[np.ndarray, np.ndarray]:
    """The real DFT as two products: (cos, sin) each [window_size,
    padded // 2] float64; frames @ cos and frames @ sin are the real and
    imaginary parts of the zero-padded rFFT for bins 0 .. padded/2 - 1
    (the mel banks drop the Nyquist bin)."""
    n = np.arange(window_size)[:, None]
    k = np.arange(padded // 2)[None, :]
    ang = 2.0 * math.pi * n * k / padded
    return np.cos(ang), -np.sin(ang)
