"""Log-mel fbank features of a batch of waveforms: a CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/fbank_kernel.py``
(``fbank_pallas`` / ``_fbank_kernel``). The kernel is ``csrc/fbank.cu``; its
source note gives the math, the bound and the design. ``fbank_kernel``
launches it for CUDA tensors and takes the plain version only for CPU
tensors; ``fbank_kernel.launches`` counts its launches. As in the JAX
package, no serving or training path calls it: the runner and the data
pipeline featurize on the host (``ops/fbank.py`` ``fbank_numpy``).

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


@functools.lru_cache(maxsize=8)
def _constants(sample_rate: float, num_mel_bins: int, frame_length: float, frame_shift: float,
               device: str):
    """(ws, shift, window [ws], cos [ws, F], sin [ws, F], mel^T [F, M]),
    float32 on ``device``."""
    ws, shift, padded = frame_params(sample_rate, frame_length, frame_shift)
    cos_m, sin_m = dft_matrices(ws, padded)
    mel_t = mel_banks(num_mel_bins, padded, sample_rate).T
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)  # noqa: E731
    return ws, shift, to(povey_window(ws)), to(cos_m), to(sin_m), to(mel_t)


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
    launch the kernel or raise (float32 [B, N], a window of at most 1024
    samples)."""
    kw = dict(sample_rate=sample_rate, num_mel_bins=num_mel_bins, frame_length=frame_length,
              frame_shift=frame_shift, dither=dither, seed=seed)
    if waveform.device.type == "cpu":
        return fbank_plain(waveform, **kw)
    if waveform.device.type != "cuda" or waveform.dtype != torch.float32 or waveform.dim() != 2:
        raise ValueError("fbank_kernel: a float32 [B, N] CUDA tensor expected")
    ws, shift, window, cos_m, sin_m, mel_t = _constants(
        sample_rate, num_mel_bins, frame_length, frame_shift, str(waveform.device))
    bsz, n = waveform.shape
    t = num_frames(n, ws, shift)
    if ws > 1024 or bsz == 0 or t == 0:
        raise ValueError(f"fbank_kernel: window {ws}, waveform {tuple(waveform.shape)} outside "
                         "the kernel")
    wave = waveform.contiguous()
    out = torch.empty((bsz, t, num_mel_bins), dtype=torch.float32, device=wave.device)
    fn = cuda_build.load_function("fbank", "fbank_features", n_ptrs=7, n_ints=8, n_floats=1)
    P = cuda_build.ptr
    seed32 = int(seed) & _M32                 # the hash's uint32 seed, passed as a C int
    err = fn(P(wave), P(window), P(cos_m), P(sin_m), P(mel_t), P(out), cuda_build.stream_ptr(wave),
             bsz, n, t, ws, shift, cos_m.shape[1], num_mel_bins,
             seed32 - (1 << 32) if seed32 >> 31 else seed32, float(dither))
    cuda_build.check(err, "fbank_kernel")
    fbank_kernel.launches += 1
    return out


fbank_kernel.launches = 0
