"""Host-side processing stages of the training and evaluation data (the
port's own copy of the JAX package's ``data/processor.py``).

Each stage is ``stage(iterable, **knobs) -> iterator`` over sample dicts
(key, waveform, sample_rate, transcript, tokens, label, feat): parse_raw,
filter_data, resample, speed_perturb, tokenize, compute_fbank, compute_mfcc,
spec_aug, shuffle, sort_by_length, static / dynamic / bucket batching and padding.
``bucket_batch`` and ``padding`` give a small closed set of padded shapes
(length buckets x fixed rows per bucket). All randomness draws from an
explicit ``np.random.Generator``, so a seed gives the JAX package's batches
exactly. ``compute_fbank`` takes the host C++ runtime (``native``) where it
is available and the numpy ``fbank_numpy`` where it is not, by the JAX
package's rule and with its draws; ``compute_mfcc`` is numpy only, as there.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np

from ..ops.fbank import fbank_numpy, mfcc_numpy
from . import audio as audio_ops
from .tokenizer import Tokenizer

Sample = dict[str, Any]


def parse_raw(data: Iterable[Sample]) -> Iterator[Sample]:
    for sample in data:
        waveform, sr = audio_ops.load_audio(sample["wav_path"])
        yield dict(
            key=sample["key"],
            transcript=sample["transcript"],
            waveform=waveform,
            sample_rate=sr,
        )


def filter_data(
    data: Iterable[Sample],
    max_length: float = 1650,
    min_length: float = 10,
    token_max_length: int = 200,
    token_min_length: int = 1,
    min_output_input_ratio: float = 0.0005,
    max_output_input_ratio: float = 1.0,
) -> Iterator[Sample]:
    """Length and ratio filter (lengths in 10 ms frames)."""
    for sample in data:
        num_frames = len(sample["waveform"]) / sample["sample_rate"] * 100
        n_tok = len(sample["label"])
        if num_frames < min_length or num_frames > max_length:
            continue
        if n_tok < token_min_length or n_tok > token_max_length:
            continue
        ratio = n_tok / max(num_frames, 1e-9)
        if ratio < min_output_input_ratio or ratio > max_output_input_ratio:
            continue
        yield sample


def resample(data: Iterable[Sample], resample_rate: int = 16000) -> Iterator[Sample]:
    for sample in data:
        if sample["sample_rate"] != resample_rate:
            sample["waveform"] = audio_ops.resample(
                sample["waveform"], sample["sample_rate"], resample_rate
            )
            sample["sample_rate"] = resample_rate
        yield sample


def speed_perturb(
    data: Iterable[Sample],
    speeds: tuple[float, ...] = (0.9, 1.0, 1.1),
    rng: np.random.Generator | None = None,
) -> Iterator[Sample]:
    rng = rng or np.random.default_rng()
    for sample in data:
        speed = speeds[int(rng.integers(len(speeds)))]
        sample["waveform"] = audio_ops.speed_perturb(
            sample["waveform"], sample["sample_rate"], speed
        )
        yield sample


def tokenize(data: Iterable[Sample], tokenizer: Tokenizer) -> Iterator[Sample]:
    """Tokens and label ids of each transcript. A vocab that does not match
    the transcripts (wrong case, wrong file, pieces vs chars) maps nearly
    every token to <unk>, and training then learns <unk> sequences without
    an error anywhere: warn once when the early <unk> rate is implausible."""
    unk_id = tokenizer.vocab.get("<unk>") if hasattr(tokenizer, "vocab") else None
    seen = unks = 0
    warned = False
    for sample in data:
        tokens, label = tokenizer.encode(sample["transcript"])
        sample["tokens"] = tokens
        sample["label"] = label
        if unk_id is not None and not warned and seen < 2000:
            seen += len(label)
            unks += sum(1 for t in label if t == unk_id)
            if seen >= 200 and unks > 0.5 * seen:
                warned = True
                import warnings

                warnings.warn(
                    f"tokenizer mapped {unks}/{seen} tokens to <unk> — "
                    "the vocab almost certainly does not match the "
                    "transcripts (transcripts are uppercased; vocab "
                    "entries must be uppercase)",
                    RuntimeWarning,
                    stacklevel=2,
                )
        yield sample


def compute_fbank(
    data: Iterable[Sample],
    num_mel_bins: int = 80,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    dither: float = 0.0,
    rng: np.random.Generator | None = None,
) -> Iterator[Sample]:
    """Log-mel fbank of each waveform. With the host runtime (decided once
    per call) each utterance dithers from one seed drawn from ``rng``
    (none at dither 0); without it ``fbank_numpy`` draws its noise from
    ``rng``: the JAX package's two paths and their draws."""
    from . import native

    use_native = native.native_available()
    rng_native = rng or np.random.default_rng()
    for sample in data:
        wave = sample["waveform"] * (1 << 15)
        if use_native:
            feat = native.fbank(
                wave,
                sample_rate=sample["sample_rate"],
                num_mel_bins=num_mel_bins,
                frame_length=frame_length,
                frame_shift=frame_shift,
                dither=dither,
                seed=int(rng_native.integers(0, 2**63)) if dither else 0,
            )
        else:
            feat = fbank_numpy(
                wave,
                sample_rate=sample["sample_rate"],
                num_mel_bins=num_mel_bins,
                frame_length=frame_length,
                frame_shift=frame_shift,
                dither=dither,
                rng=rng,
            )
        yield dict(
            key=sample["key"],
            label=sample["label"],
            feat=feat,
            transcript=sample["transcript"],
            tokens=sample["tokens"],
        )


def compute_mfcc(
    data: Iterable[Sample],
    num_mel_bins: int = 23,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    dither: float = 0.0,
    num_ceps: int = 13,
    high_freq: float = 0.0,
    low_freq: float = 20.0,
    rng: np.random.Generator | None = None,
) -> Iterator[Sample]:
    """Kaldi-style MFCC of each waveform (``mfcc_numpy``)."""
    for sample in data:
        feat = mfcc_numpy(
            sample["waveform"] * (1 << 15),
            sample_rate=sample["sample_rate"],
            num_mel_bins=num_mel_bins,
            num_ceps=num_ceps,
            frame_length=frame_length,
            frame_shift=frame_shift,
            dither=dither,
            low_freq=low_freq,
            high_freq=high_freq,
            rng=rng,
        )
        yield dict(
            key=sample["key"],
            label=sample["label"],
            feat=feat,
            transcript=sample["transcript"],
            tokens=sample["tokens"],
        )


def spec_aug(
    data: Iterable[Sample],
    num_t_mask: int = 2,
    num_f_mask: int = 2,
    max_t: int = 50,
    max_f: int = 50,
    rng: np.random.Generator | None = None,
) -> Iterator[Sample]:
    """SpecAugment: zero ``num_t_mask`` time and ``num_f_mask`` frequency
    bands, each 1..max wide (inclusive bounds)."""
    rng = rng or np.random.default_rng()
    for sample in data:
        y = np.array(sample["feat"])
        max_frames, max_freq = y.shape
        for _ in range(num_t_mask):
            start = int(rng.integers(0, max_frames))
            length = int(rng.integers(1, max_t + 1))
            y[start : min(max_frames, start + length), :] = 0
        for _ in range(num_f_mask):
            start = int(rng.integers(0, max_freq))
            length = int(rng.integers(1, max_f + 1))
            y[:, start : min(max_freq, start + length)] = 0
        sample["feat"] = y
        yield sample


def shuffle(
    data: Iterable[Sample],
    shuffle_size: int = 10000,
    rng: np.random.Generator | None = None,
) -> Iterator[Sample]:
    rng = rng or np.random.default_rng()
    buf: list[Sample] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= shuffle_size:
            rng.shuffle(buf)
            yield from buf
            buf = []
    rng.shuffle(buf)
    yield from buf


def sort_by_length(data: Iterable[Sample], sort_size: int = 500) -> Iterator[Sample]:
    buf: list[Sample] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= sort_size:
            buf.sort(key=lambda s: s["feat"].shape[0])
            yield from buf
            buf = []
    buf.sort(key=lambda s: s["feat"].shape[0])
    yield from buf


def static_batch(data: Iterable[Sample], batch_size: int) -> Iterator[list[Sample]]:
    buf: list[Sample] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def dynamic_batch(
    data: Iterable[Sample], max_frames_in_batch: int = 8000
) -> Iterator[list[Sample]]:
    """Greedy batching under a budget of padded frames; variable shapes."""
    buf: list[Sample] = []
    longest = 0
    for sample in data:
        new_longest = max(longest, sample["feat"].shape[0])
        if new_longest * (len(buf) + 1) > max_frames_in_batch and buf:
            yield buf
            buf = [sample]
            longest = sample["feat"].shape[0]
        else:
            buf.append(sample)
            longest = new_longest
    if buf:
        yield buf


class PaddingStats:
    """Padded-vs-valid frame accounting for bucketed batching: efficiency =
    valid frames / the padded frames sent to the device (bucket T x rows,
    dummy rows included)."""

    def __init__(self) -> None:
        self.valid_frames = 0
        self.total_frames = 0
        self.valid_rows = 0
        self.total_rows = 0
        self.per_bucket: dict[int, list[int]] = {}

    def add(self, bucket_t: int, rows: int, lengths: list[int]) -> None:
        valid = sum(lengths)
        total = bucket_t * rows
        self.valid_frames += valid
        self.total_frames += total
        self.valid_rows += len(lengths)
        self.total_rows += rows
        b = self.per_bucket.setdefault(bucket_t, [0, 0])
        b[0] += valid
        b[1] += total

    @property
    def efficiency(self) -> float:
        return self.valid_frames / self.total_frames if self.total_frames else 1.0

    def summary(self) -> dict:
        return {
            "padding_efficiency": round(self.efficiency, 4),
            "padded_frame_waste": round(1.0 - self.efficiency, 4),
            "valid_frames": self.valid_frames,
            "total_frames": self.total_frames,
            "dummy_rows": self.total_rows - self.valid_rows,
            "per_bucket_efficiency": {
                t: round(v / tot, 4) if tot else 1.0
                for t, (v, tot) in sorted(self.per_bucket.items())
            },
        }


def bucket_batch(
    data: Iterable[Sample],
    bucket_boundaries: tuple[int, ...] = (256, 512, 768, 1024, 1280, 1650),
    max_frames_in_batch: int = 8000,
    min_rows: int = 1,
    stats: PaddingStats | None = None,
) -> Iterator[tuple[list[Sample], int, int]]:
    """Length-bucketed batching with a FIXED row count per bucket.

    Bucket i holds utterances with T <= boundary_i; its batch size is
    max_frames_in_batch // boundary_i. Yields (samples, pad_to_T, rows) so
    `padding` can produce one static shape per bucket. Incomplete final
    buckets are flushed short and padded with dummy rows downstream.
    `stats` (optional PaddingStats) accumulates padded-vs-valid frame counts.
    """
    rows = [max(max_frames_in_batch // b, min_rows) for b in bucket_boundaries]
    bufs: list[list[Sample]] = [[] for _ in bucket_boundaries]
    n_overflow = 0

    def emit(buf, bound, n_rows):
        if stats is not None:
            stats.add(bound, n_rows, [s["feat"].shape[0] for s in buf])
        return buf, bound, n_rows

    for sample in data:
        t = sample["feat"].shape[0]
        for i, bound in enumerate(bucket_boundaries):
            if t <= bound:
                bufs[i].append(sample)
                if len(bufs[i]) >= rows[i]:
                    yield emit(bufs[i], bound, rows[i])
                    bufs[i] = []
                break
        else:
            # longer than the last boundary (only with filter_data off):
            # never drop data, emit a singleton batch padded to the next
            # 128-frame multiple, and count it
            n_overflow += 1
            if n_overflow <= 5 or n_overflow % 100 == 0:
                import sys

                print(
                    f"[bucket_batch] utterance of {t} frames exceeds the "
                    f"last bucket boundary {bucket_boundaries[-1]} "
                    f"({n_overflow} so far); emitting a singleton batch",
                    file=sys.stderr,
                )
            yield emit([sample], -(-t // 128) * 128, 1)
    for i, buf in enumerate(bufs):
        if buf:
            yield emit(buf, bucket_boundaries[i], rows[i])


class Batch(dict):
    """Collated batch: keys, feats [B,T,F] f32, feat_lengths [B] i32,
    labels [B,U] i32, label_lengths [B] i32, transcripts."""


def padding(
    batches: Iterable,
    *,
    static_label_len: int | None = None,
    sort_desc: bool = True,
) -> Iterator[Batch]:
    """Collate: sort by length, longest first; pad feats and labels.

    Takes plain sample lists (static and dynamic batching) or (samples,
    pad_to, rows) triples from ``bucket_batch``, which pad time to the
    bucket edge and rows to the bucket size, with zero-length dummy rows.
    """
    for item in batches:
        if isinstance(item, tuple):
            samples, pad_to, rows = item
        else:
            samples, pad_to, rows = item, None, None
        if sort_desc:
            samples = sorted(samples, key=lambda s: -s["feat"].shape[0])
        bsz = len(samples)
        t_max = pad_to or max(s["feat"].shape[0] for s in samples)
        u_max = static_label_len or max(len(s["label"]) for s in samples)
        n_rows = rows or bsz
        fdim = samples[0]["feat"].shape[1]

        feats = np.zeros((n_rows, t_max, fdim), np.float32)
        labels = np.zeros((n_rows, u_max), np.int32)
        feat_lengths = np.zeros((n_rows,), np.int32)
        label_lengths = np.zeros((n_rows,), np.int32)
        keys, transcripts = [], []
        for i, s in enumerate(samples):
            t, u = s["feat"].shape[0], min(len(s["label"]), u_max)
            feats[i, :t] = s["feat"]
            labels[i, :u] = s["label"][:u]
            feat_lengths[i] = t
            label_lengths[i] = u
            keys.append(s["key"])
            transcripts.append(s["transcript"])
        yield Batch(
            keys=keys,
            feats=feats,
            feat_lengths=feat_lengths,
            labels=labels,
            label_lengths=label_lengths,
            transcripts=transcripts,
        )
