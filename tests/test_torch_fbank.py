"""The fbank kernel's host tables and arithmetic on the CPU
(``conformer_tpu_torch/ops/fbank_kernel.py``, ``csrc/fbank.cu``):

- the sparse mel tables rebuild the float32 mel^T exactly;
- the twiddle tables are float64 exp(-2 pi i k / padded) rounded once;
- a numpy float32 emulation of the kernel's FFT in its own stage order
  (even / odd packing, Stockham passes of ``radix_plan`` with the host
  twiddles, the split pass, the sparse mel sum) against numpy's FFT, and
  through the whole fbank against JAX's ``fbank_pallas`` (interpret mode)
  and against a float64 fbank of the same frames, where it must be at
  most twice as far as the plain version (the DFT as float32 products);
- ``width_error``.

The kernel itself runs only on the card (``chip_smoke.py``). Inputs from
seeded numpy generators; tolerances per test.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.ops.pallas.fbank_kernel import fbank_pallas
from conformer_tpu_torch.data.synthetic import synthetic_wav
from conformer_tpu_torch.ops import fbank_kernel as fk
from conformer_tpu_torch.ops.fbank import frame_params, num_frames, povey_window

F32 = np.float32
# (sample_rate, num_mel_bins, frame_length ms): padded 512, 256 (8 kHz), 1024 (50 ms)
WIDTHS = {"16k_25ms": (16000.0, 80, 25.0), "8k_25ms_40": (8000.0, 40, 25.0),
          "16k_50ms": (16000.0, 80, 50.0)}
# tests/test_torch_joint.py's: float32 sums in other orders
FBANK_TOL = dict(rtol=1e-3, atol=1e-2)


# ------------------------------------------------------------- host tables


@pytest.mark.parametrize("width", [*WIDTHS, "16k_25ms_128"])
def test_sparse_mel_rebuilds_mel_t_exactly(width):
    """Each bin's packed run put back in place gives the float32 mel^T bit
    for bit (128 bins at padded 512 have a bin with no weight)."""
    sr, bins, fl = WIDTHS.get(width, (16000.0, 128, 25.0))
    _, _, padded = frame_params(sr, fl, 10.0)
    mel_t = fk.mel_t32(bins, padded, sr)
    info, weights = fk.sparse_mel(mel_t)
    assert info.dtype == np.int32 and weights.dtype == np.float32
    assert info.shape == (bins, 3)
    rebuilt = np.zeros_like(mel_t)
    for m, (lo, cnt, off) in enumerate(info):
        rebuilt[lo:lo + cnt, m] = weights[off:off + cnt]
    assert np.array_equal(rebuilt, mel_t)
    assert int(info[:, 1].sum()) == int(np.count_nonzero(mel_t)) or width == "16k_25ms_128"
    assert (info[:, 1] == 0).any() == (width == "16k_25ms_128")
    if width == "16k_25ms":
        assert int(info[:, 1].sum()) == 501 and int(info[:, 1].max()) == 16


@pytest.mark.parametrize("padded", [1, 2, 256, 512, 1024])
def test_twiddles_are_float64_rounded_once(padded):
    tw = fk.twiddles(padded)
    want = np.exp(-2j * np.pi * np.arange(padded, dtype=np.float64) / padded)
    assert tw.dtype == np.float32 and tw.shape == (padded, 2)
    assert np.array_equal(tw[:, 0], want.real.astype(np.float32))
    assert np.array_equal(tw[:, 1], want.imag.astype(np.float32))


@pytest.mark.parametrize("padded", [1, 2, 256, 512, 1024])
def test_pass_twiddles_are_float64_rounded_once(padded):
    """Each entry of the kernel's table is its own W_{RP}^{jk} (then the
    split pass's W_padded^k) from float64, rounded once."""
    twp = fk.pass_twiddles(padded)
    n = padded // 2
    want = []
    p = 1
    for r in fk.radix_plan(n):
        if p > 1:
            want += [np.exp(-2j * np.pi * j * k / (r * p)) for k in range(p) for j in range(1, r)]
        p *= r
    want += list(np.exp(-2j * np.pi * np.arange(n // 2 + 1) / padded))
    want = np.asarray(want, np.complex128)
    assert twp.dtype == np.float32 and twp.shape == (len(want), 2)
    assert np.array_equal(twp[:, 0], want.real.astype(np.float32))
    assert np.array_equal(twp[:, 1], want.imag.astype(np.float32))


def test_radix_plan():
    assert fk.radix_plan(512) == [8, 8, 8]
    assert fk.radix_plan(256) == [8, 8, 4]
    assert fk.radix_plan(128) == [8, 8, 2]
    assert fk.radix_plan(1) == fk.radix_plan(0) == []
    for n in (2 ** k for k in range(10)):
        assert math.prod(fk.radix_plan(n)) == n


def test_buffer_addresses_split_into_lane_part_and_constant():
    """csrc/fbank.cu addresses a warp's buffer through sw(i) = i + i // 16,
    each address split into a part computed once a lane or butterfly and a
    compile-time constant: reads sw(lane + M) = sw(lane) + sw(M) (M a
    multiple of 16), a butterfly's writes sw(base + jP) = base + ((i - k) R
    >> 4) + (k >> 4) + sw(jP), the split pass's mirror sw(N - lane - 32c) =
    sw(N - lane) - sw(32c). Checked for every pass of every FFT size."""
    def sw(i):
        return i + (i >> 4)

    for n in (2 ** k for k in range(1, 10)):
        p = 1
        for r in fk.radix_plan(n):
            nb = n // r
            for i in range(nb):
                k = i & (p - 1)
                base = (i - k) * r + k
                for j in range(r):
                    assert sw(base + j * p) == base + (((i - k) * r) >> 4) + (k >> 4) + sw(j * p)
                    if nb % 16 == 0:
                        m = 32 * (i // 32) + j * nb
                        assert sw(i + j * nb) == sw(i % 32) + sw(m)
            p *= r
        for k in range(1, n // 2 + 1):
            lane, c = k % 32, k // 32
            assert n < 32 or sw(n - k) == sw(n - lane) - sw(32 * c)


# ----------------------------------------------- the kernel's FFT, emulated


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _fma(a, b, c):
    """fmaf(a, b, c) in float32: the product exact in float64, one
    rounding of the sum to float32 (float64 first: the second rounding
    moves a result only in rare ties)."""
    return (np.float64(a) * b + c).astype(F32) if np.isscalar(a) else \
        (a.astype(np.float64) * b + c).astype(F32)


def _cmul(a, b):
    """csrc/fbank.cu cmul(a, b): one fmaf and one product a component."""
    return _fma(a[0], b[0], -(a[1] * b[1])), _fma(a[0], b[1], a[1] * b[0])


def _mul_mi(a):
    return a[1], -a[0]


def _dft(u):
    """csrc/fbank.cu dft<R>, the same operations in the same order."""
    if len(u) == 1:
        return u
    if len(u) == 2:
        return [_add(u[0], u[1]), _sub(u[0], u[1])]
    if len(u) == 4:
        t0, t1 = _add(u[0], u[2]), _sub(u[0], u[2])
        t2, t3 = _add(u[1], u[3]), _mul_mi(_sub(u[1], u[3]))
        return [_add(t0, t2), _add(t1, t3), _sub(t0, t2), _sub(t1, t3)]
    e, o = _dft(u[0::2]), _dft(u[1::2])
    r = F32(0.70710678118654752)
    o[1] = ((o[1][0] + o[1][1]) * r, (o[1][1] - o[1][0]) * r)
    o[2] = _mul_mi(o[2])
    o[3] = ((o[3][1] - o[3][0]) * r, -(o[3][0] + o[3][1]) * r)
    return [_add(e[k], o[k]) for k in range(4)] + [_sub(e[k], o[k]) for k in range(4)]


def emulate_fft(zr, zi, twp):
    """FFT over the last axis of z = zr + i zi (float32 [..., n]) as the
    kernel runs it: Stockham passes of ``radix_plan(n)``; butterfly i of a
    radix-R pass after p points (k = i mod p) reads z[i + j n/R], multiplies
    input j by W_Rp^jk from the kernel's table ``twp`` (``pass_twiddles``;
    none in the first pass), and writes output j to (i - k) R + k + j p."""
    n = zr.shape[-1]
    p, off = 1, 0
    for r in fk.radix_plan(n):
        nb = n // r
        i = np.arange(nb)
        k = i % p
        u = [(zr[..., i + j * nb], zi[..., i + j * nb]) for j in range(r)]
        if p > 1:
            for j in range(1, r):
                w = twp[off + k * (r - 1) + j - 1]
                u[j] = _cmul(u[j], (w[:, 0], w[:, 1]))
            off += p * (r - 1)
        y = _dft(u)
        zr, zi = np.empty_like(zr), np.empty_like(zi)
        base = (i - k) * r + k
        for j in range(r):
            zr[..., base + j * p], zi[..., base + j * p] = y[j]
        p *= r
    return zr, zi


def emulate_power(zr, zi, twp):
    """The kernel's split pass: the power of the real DFT's bins 0 .. n-1
    from Z = FFT_n(z), pairs (k, n - k) for k <= n / 2, W_2n^k from the
    table's last n / 2 + 1 rows."""
    n = zr.shape[-1]
    k = np.arange(n // 2 + 1)
    kn = (n - k) & (n - 1)
    z, w = (zr[..., k], zi[..., k]), (zr[..., kn], zi[..., kn])
    half = F32(0.5)
    e = (half * (z[0] + w[0]), half * (z[1] - w[1]))
    o = (half * (z[1] + w[1]), -half * (z[0] - w[0]))
    tw = twp[len(twp) - len(k):]
    b = _cmul((tw[:, 0], tw[:, 1]), o)
    yk, yn = _add(e, b), _sub(e, b)
    pw = np.empty(zr.shape, np.float32)
    keep = k < n
    pw[..., k[keep]] = _fma(yk[0], yk[0], yk[1] * yk[1])[..., keep]
    mirror = (k > 0) & (2 * k != n)
    pw[..., n - k[mirror]] = _fma(yn[0], yn[0], yn[1] * yn[1])[..., mirror]
    return pw


def _warp_sum(x, n):
    """The kernel's sum of a frame's samples (the last axis) for an FFT of
    n points, then five xor-shuffle steps. Where the first pass is fused
    with the framing (n / R a multiple of 32), lane l adds the sample pairs
    2 (l + 32 c + j n / R) and the next, c outer, j inner; else samples
    l, l + 32, ... in order."""
    ws = x.shape[-1]
    x = np.concatenate([x, np.zeros((*x.shape[:-1], 2 * n + 64 - ws), F32)], axis=-1)
    lanes = np.zeros((*x.shape[:-1], 32), F32)
    plan = fk.radix_plan(n)
    l = np.arange(32)
    if plan and (n // plan[0]) % 32 == 0:
        r, nb = plan[0], n // plan[0]
        for c in range(nb // 32):
            for j in range(r):
                m = 2 * (l + 32 * c + j * nb)
                lanes += x[..., m]
                lanes += x[..., m + 1]
    else:
        for q in range(0, ws, 32):
            lanes += x[..., q + l]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., l ^ off]
    return lanes[..., 0]


def _frames(wave, ws, shift):
    t = num_frames(wave.shape[-1], ws, shift)
    return wave[..., np.arange(ws)[None, :] + shift * np.arange(t)[:, None]]


def emulate_fbank(wave, sample_rate, num_mel_bins, frame_length):
    """[B, N] float32 (x 2**15) -> [B, T, M]: the kernel's steps in numpy
    float32, the FFT and mel sum as emulated above."""
    ws, shift, padded = frame_params(sample_rate, frame_length, 10.0)
    x = _frames(wave, ws, shift)
    x = x - (_warp_sum(x, padded // 2) / F32(ws))[..., None]
    prev = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    y = _fma(F32(-0.97), prev, x) * povey_window(ws).astype(F32)
    y = np.concatenate([y, np.zeros((*y.shape[:-1], padded - ws), F32)], axis=-1)
    twp = fk.pass_twiddles(padded)
    pw = emulate_power(*emulate_fft(y[..., 0::2].copy(), y[..., 1::2].copy(), twp), twp)
    info, weights = fk.sparse_mel(fk.mel_t32(num_mel_bins, padded, sample_rate))
    mel = np.zeros((*pw.shape[:-1], num_mel_bins), F32)
    for m, (lo, cnt, off) in enumerate(info):
        for j in range(cnt):
            mel[..., m] = _fma(pw[..., lo + j], weights[off + j], mel[..., m])
    return np.log(np.maximum(mel, F32(fk._EPS)))


def fbank_float64(wave, sample_rate, num_mel_bins, frame_length):
    """The same function in float64 from the same float32 constants (window,
    mel^T, 0.97), by numpy's real FFT: the truth both float32 versions are
    held to."""
    ws, shift, padded = frame_params(sample_rate, frame_length, 10.0)
    x = _frames(wave.astype(np.float64), ws, shift)
    x = x - x.mean(-1, keepdims=True)
    prev = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    y = (x - np.float64(F32(0.97)) * prev) * povey_window(ws).astype(F32).astype(np.float64)
    spec = np.fft.rfft(y, n=padded, axis=-1)[..., : padded // 2]
    mel = (spec.real ** 2 + spec.imag ** 2) @ fk.mel_t32(num_mel_bins, padded,
                                                          sample_rate).astype(np.float64)
    return np.log(np.maximum(mel, fk._EPS))


@pytest.mark.parametrize("n", [2 ** k for k in range(10)])
def test_emulated_fft_matches_numpy(n):
    rng = np.random.default_rng(n)
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    twp = fk.pass_twiddles(2 * n)
    zr, zi = emulate_fft(z.real.astype(F32), z.imag.astype(F32), twp)
    want = np.fft.fft(z, axis=-1)
    scale = np.abs(want).max()
    assert np.abs(zr - want.real).max() <= 4e-7 * scale * max(1, math.log2(n))
    assert np.abs(zi - want.imag).max() <= 4e-7 * scale * max(1, math.log2(n))
    y = rng.standard_normal((3, 2 * n))
    pw = emulate_power(*emulate_fft(y[:, 0::2].astype(F32), y[:, 1::2].astype(F32), twp), twp)
    ref = np.abs(np.fft.rfft(y, axis=-1)[:, :n]) ** 2
    np.testing.assert_allclose(pw, ref, rtol=0, atol=2e-6 * ref.max() * max(1, math.log2(n)))


def _speech(n, sample_rate, seeds=(31, 32)):
    sr = int(sample_rate)
    wav = np.stack([synthetic_wav(s, n / sr + 0.1, sr)[:n] for s in seeds])
    return (wav * (1 << 15)).astype(np.float32)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("n", [8000, 7001])       # 7001: odd, so rows start unaligned
def test_fft_emulation_matches_pallas_and_float64(n, width):
    sr, bins, fl = WIDTHS[width]
    wave = _speech(n, sr)
    kw = dict(sample_rate=sr, num_mel_bins=bins, frame_length=fl)
    emu = emulate_fbank(wave, sr, bins, fl)
    pal = np.asarray(fbank_pallas(jnp.asarray(wave), dither=0.0, interpret=True, **kw))
    assert emu.shape == pal.shape
    np.testing.assert_allclose(emu, pal, **FBANK_TOL)
    truth = fbank_float64(wave, sr, bins, fl)
    plain = fk.fbank_plain(torch.from_numpy(wave), **kw).numpy()
    d_emu, d_plain = np.abs(emu - truth).max(), np.abs(plain - truth).max()
    assert d_emu <= 2 * d_plain, (d_emu, d_plain)


# ------------------------------------------------------------------- limits


def test_width_error():
    assert fk.width_error(1024, 1, 1) is None
    assert fk.width_error(400, 48, 1498) is None
    assert "1024" in fk.width_error(1025, 1, 1)
    assert fk.width_error(400, 0, 10) is not None
    assert fk.width_error(400, 2, 0) is not None
