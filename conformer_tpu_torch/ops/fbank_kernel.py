"""Log-mel fbank features of a batch of waveforms: a CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/fbank_kernel.py``
(``fbank_pallas`` / ``_fbank_kernel``). The kernel is ``csrc/fbank.cu``; its
source note gives the math, the bound and the design. ``fbank_kernel``
launches it for CUDA tensors and takes the plain version only for CPU
tensors; ``fbank_kernel.launches`` counts its launches. As in the JAX
package, no serving or training path calls it: the runner and the data
pipeline featurize on the host (``ops/fbank.py`` ``fbank_numpy``).

The kernel computes the DFT as a float32 FFT, not as the plain version's
products. Its host tables are made here: the twiddles (``twiddles``,
laid out as the kernel reads them by ``pass_twiddles``) and the mel
weights packed per mel bin (``sparse_mel``); ``radix_plan`` is the FFT's
order of radix passes, the same rule as the kernel's ``plan_radix``.

The TPU kernel dithers with the TPU's own random bits, which nothing else
reproduces. Here each (seed, utterance, frame, sample) is hashed into two
uniforms (``dither_normal``) and Box-Muller makes the normal, the same in
the kernel and the plain version.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import cuda_build
from .fbank import dft_matrices, frame_params, mel_banks, num_frames, povey_window
from .rel_attention import _M32, _mul32

_EPS = 1.1920928955078125e-07


def _hash(seed: int, b, t, n, stream: int) -> torch.Tensor:
    """The kernel's uint32 counter hash in int64 arithmetic."""
    x = (_mul32(torch.as_tensor(seed & _M32, dtype=torch.int64, device=b.device), 0x9E3779B9)
         + _mul32(b, 0x85EBCA6B)) & _M32
    x = x ^ _mul32(t, 0xC2B2AE35)
    x = x ^ _mul32(n, 0x27D4EB2F)
    x = x ^ (stream * 0x165667B1 & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def dither_normal(seed: int, bsz: int, t: int, ws: int, device) -> torch.Tensor:
    """float32 [B, T, ws] standard normals of (seed, utterance, frame,
    sample): u1 in (0, 1] and u2 in [0, 1) from the top 24 bits of two
    hashes, then Box-Muller."""
    ar = lambda k: torch.arange(k, device=device, dtype=torch.int64)  # noqa: E731
    b, tt, n = ar(bsz)[:, None, None], ar(t)[None, :, None], ar(ws)[None, None, :]
    scale = 1.0 / 16777216.0
    u1 = ((_hash(seed, b, tt, n, 0) >> 8) + 1).float() * scale
    u2 = (_hash(seed, b, tt, n, 1) >> 8).float() * scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(np.float32(2 * math.pi) * u2)


def _to(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def mel_t32(num_mel_bins: int, padded: int, sample_rate: float) -> np.ndarray:
    """The mel banks transposed, [F, M] float32 (F = padded // 2)."""
    return np.ascontiguousarray(mel_banks(num_mel_bins, padded, sample_rate).T, dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _constants(sample_rate: float, num_mel_bins: int, frame_length: float, frame_shift: float,
               device: str):
    """(ws, shift, window [ws], cos [ws, F], sin [ws, F], mel^T [F, M]),
    float32 on ``device``."""
    ws, shift, padded = frame_params(sample_rate, frame_length, frame_shift)
    cos_m, sin_m = dft_matrices(ws, padded)
    mel_t = mel_t32(num_mel_bins, padded, sample_rate)
    return (ws, shift, _to(povey_window(ws), device), _to(cos_m, device), _to(sin_m, device),
            _to(mel_t, device))


# ----------------------------------------------------- the kernel's tables

MAX_WS = 1024           # samples a frame: padded <= 1024, 16 complex points a lane


def radix_plan(n: int) -> list[int]:
    """The radices of the kernel's FFT passes over ``n`` = padded / 2
    complex points, in order: 8 while 8 divides what is left, then 4, then
    2 (the kernel's ``plan_radix``): 512 -> 8, 8, 8; 256 -> 8, 8, 4;
    128 -> 8, 8, 2."""
    out = []
    while n > 1:
        r = 8 if n % 8 == 0 else 4 if n % 4 == 0 else 2
        out.append(r)
        n //= r
    return out


def twiddles(padded: int) -> np.ndarray:
    """[padded, 2] float32: exp(-2 pi i k / padded) for k < padded, made in
    float64 and rounded once."""
    ang = -2.0 * math.pi * np.arange(padded, dtype=np.float64) / padded
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def pass_twiddles(padded: int) -> np.ndarray:
    """The kernel's twiddle table, [n_tw, 2] float32, entries of
    ``twiddles(padded)`` laid out in the order the kernel reads them (its
    ``tw_offset``): for each FFT pass after the first, P points combined
    and radix R, W_{RP}^{jk} at row k (R - 1) + j - 1 (k < P, 1 <= j < R),
    so that the lanes of a warp read consecutive rows; then the split
    pass's W_padded^k, k <= padded / 4."""
    n = padded // 2
    tw = twiddles(padded)
    rows = []
    p = 1
    for r in radix_plan(n):
        if p > 1:
            jk = np.arange(p)[:, None] * np.arange(1, r)[None, :]
            rows.append(tw[(jk * (padded // (r * p))).ravel()])
        p *= r
    rows.append(tw[: n // 2 + 1])
    return np.concatenate(rows)


def sparse_mel(mel_t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The float32 mel^T [F, M] packed per mel bin: info int32 [M, 3] of
    (first FFT bin, count, offset into ``weights``) and ``weights`` float32,
    each bin's run from its first to its last non-zero weight (the
    triangles have no zero inside the run), starting at a multiple of 4
    (the kernel reads four weights at a time; zeros between runs). A bin
    with no non-zero weight has count 0.
    mel_t[info[m, 0] + j, m] == weights[info[m, 2] + j] for j < count."""
    f, m = mel_t.shape
    info = np.zeros((m, 3), np.int32)
    runs = []
    off = 0
    for b in range(m):
        nz = np.nonzero(mel_t[:, b])[0]
        lo, cnt = (int(nz[0]), int(nz[-1]) - int(nz[0]) + 1) if len(nz) else (0, 0)
        info[b] = (lo, cnt, off)
        run = np.zeros(-(-cnt // 4) * 4, np.float32)
        run[:cnt] = mel_t[lo:lo + cnt, b]
        runs.append(run)
        off += len(run)
    weights = np.concatenate(runs) if off else np.zeros(4, np.float32)
    return info, weights


@functools.lru_cache(maxsize=8)
def _kernel_tables(sample_rate: float, num_mel_bins: int, frame_length: float,
                   frame_shift: float, device: str):
    """(window [ws], pass twiddles [n_tw, 2], mel info [M, 3] int32, mel
    weights), float32 where not said, on ``device``."""
    ws, _, padded = frame_params(sample_rate, frame_length, frame_shift)
    info, weights = sparse_mel(mel_t32(num_mel_bins, padded, sample_rate))
    return (_to(povey_window(ws), device), _to(pass_twiddles(padded), device),
            _to(info, device, torch.int32), _to(weights, device))


def width_error(ws: int, bsz: int, t: int) -> str | None:
    """Why the kernel refuses a window of ``ws`` samples over ``bsz``
    waveforms of ``t`` frames, or None where it takes them: ws <= 1024
    (padded <= 1024: a lane holds at most 16 of a frame's 512 complex
    points), at least one waveform and one frame."""
    if ws > MAX_WS:
        return f"fbank_kernel takes a window of at most {MAX_WS} samples (got {ws})"
    if bsz == 0 or t == 0:
        return f"fbank_kernel: {bsz} waveforms of {t} frames: nothing to compute"
    return None


def fbank_plain(waveform, *, sample_rate: float = 16000.0, num_mel_bins: int = 80,
                frame_length: float = 25.0, frame_shift: float = 10.0, dither: float = 0.0,
                seed: int = 0) -> torch.Tensor:
    """[B, N] float32 (x 2**15) -> log-mel features [B, T, num_mel_bins]
    float32: the kernel's steps in PyTorch (the DFT as two products)."""
    ws, shift, window, cos_m, sin_m, mel_t = _constants(
        sample_rate, num_mel_bins, frame_length, frame_shift, str(waveform.device))
    bsz, n = waveform.shape
    t = num_frames(n, ws, shift)
    idx = torch.arange(ws, device=waveform.device)[None, :] + shift * torch.arange(
        t, device=waveform.device)[:, None]
    frames = waveform.float()[:, idx]                               # [B, T, ws]
    if dither != 0.0:
        frames = frames + dither * dither_normal(seed, bsz, t, ws, waveform.device)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - 0.97 * prev) * window
    re, im = frames @ cos_m, frames @ sin_m
    mel = (re * re + im * im) @ mel_t
    return torch.log(torch.clamp_min(mel, _EPS))


def fbank_kernel(waveform, *, sample_rate: float = 16000.0, num_mel_bins: int = 80,
                 frame_length: float = 25.0, frame_shift: float = 10.0, dither: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
    """Kernel wrapper with the contract of ``fbank_plain`` (the JAX
    ``fbank_pallas``): CPU tensors take the plain version, CUDA tensors
    launch the kernel or raise (float32 [B, N] within ``width_error``'s
    limits)."""
    kw = dict(sample_rate=sample_rate, num_mel_bins=num_mel_bins, frame_length=frame_length,
              frame_shift=frame_shift, dither=dither, seed=seed)
    if waveform.device.type == "cpu":
        return fbank_plain(waveform, **kw)
    if waveform.device.type != "cuda" or waveform.dtype != torch.float32 or waveform.dim() != 2:
        raise ValueError("fbank_kernel: a float32 [B, N] CUDA tensor expected")
    ws, shift, padded = frame_params(sample_rate, frame_length, frame_shift)
    bsz, n = waveform.shape
    t = num_frames(n, ws, shift)
    why = width_error(ws, bsz, t)
    if why:
        raise ValueError(why)
    window, tw, info, weights = _kernel_tables(sample_rate, num_mel_bins, frame_length,
                                               frame_shift, str(waveform.device))
    wave = waveform.contiguous()
    out = torch.empty((bsz, t, num_mel_bins), dtype=torch.float32, device=wave.device)
    fn = cuda_build.load_function("fbank", "fbank_features", n_ptrs=7, n_ints=9, n_floats=1)
    P = cuda_build.ptr
    seed32 = int(seed) & _M32                 # the hash's uint32 seed, passed as a C int
    err = fn(P(wave), P(window), P(tw), P(info), P(weights), P(out), cuda_build.stream_ptr(wave),
             bsz, n, t, ws, shift, padded, tw.shape[0], num_mel_bins,
             seed32 - (1 << 32) if seed32 >> 31 else seed32, float(dither))
    cuda_build.check(err, "fbank_kernel")
    fbank_kernel.launches += 1
    return out


fbank_kernel.launches = 0
