"""Dataset assembly: JSONL data lists, sharding, and the chain of processing
stages (the port's own copy of the JAX package's ``data/dataset.py``).

Randomness is an explicit epoch-seeded ``np.random.Generator``: every
shard draws the same shuffle permutation before taking its part, and a
seed gives the JAX package's batches exactly. The shard comes from the
``shard_id``/``num_shards`` arguments, else (0, 1). In a multi-process run
the trainer passes them (``train/loop.py``): the train list over the data
shards, which the ranks of one seq or pipe group share, and the dev and
test lists over every rank. JAX keys them on ``jax.process_index()``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

import numpy as np

from ..config import DataConfig
from . import processor as P
from .tokenizer import Tokenizer, load_vocab


def load_data_list(path: str) -> list[dict]:
    """data.list JSONL: one {key, wav_path, transcript} per line."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def shard_list(
    data: list, epoch: int, shard_id: int, num_shards: int, shuffle: bool = True
) -> list:
    """Epoch-seeded shuffle, then a round-robin shard."""
    idx = np.arange(len(data))
    if shuffle:
        np.random.default_rng(epoch if epoch >= 0 else 0).shuffle(idx)
    return [data[i] for i in idx[shard_id::num_shards]]


class AsrDataset:
    """Streaming dataset: iterating yields collated ``Batch`` dicts.

    mode "train" applies the configured augmentation, shuffling and
    batching; "dev"/"test" read their list without perturbation, in static
    batches (see ``eval_config``). ``eager=True`` makes every batch at
    init (epoch -1) and serves that list: ``len``, indexing and iteration;
    a lazy set refuses ``len`` and indexing with TypeError.
    """

    def __init__(
        self,
        cfg: DataConfig,
        mode: str = "train",
        *,
        tokenizer: Tokenizer | None = None,
        shard_id: int = 0,
        num_shards: int = 1,
        eager: bool = False,
    ):
        self.cfg = cfg
        self.mode = mode
        self.train = mode == "train"
        self.data_list = load_data_list(getattr(cfg, f"{mode}_data_list_path"))
        if self.train and cfg.extend_epochs > 0:
            for _ in range(cfg.extend_epochs):
                self.data_list = self.data_list + self.data_list
        self.tokenizer = tokenizer or Tokenizer(
            load_vocab(cfg.vocab_path),
            bpe_model=cfg.bpe_model,
            non_lang_syms=None if cfg.non_lang_syms is None else [cfg.non_lang_syms],
            split_with_space=cfg.split_with_space,
        )
        self.epoch = -1
        self.shard_id, self.num_shards = shard_id, num_shards
        # padded-vs-valid frames of bucket batching; the trainer logs it
        self.padding_stats = P.PaddingStats()
        self._eager_batches = list(self._pipeline()) if eager else None

    def set_epoch(self, epoch: int) -> None:
        """The epoch that seeds shuffling and augmentation. An eager set's
        batches are made once, so it raises there (the JAX package's is a
        silent no-op that keeps the first batches)."""
        if self._eager_batches is not None:
            raise RuntimeError("set_epoch on an eager AsrDataset: its batches were made at "
                               "init and do not change with the epoch")
        self.epoch = epoch

    def __len__(self) -> int:
        if self._eager_batches is None:
            raise TypeError("len() requires eager=True (a lazy dataset streams)")
        return len(self._eager_batches)

    def __getitem__(self, i: int) -> P.Batch:
        if self._eager_batches is None:
            raise TypeError("indexing requires eager=True (a lazy dataset streams)")
        return self._eager_batches[i]

    def __iter__(self) -> Iterator[P.Batch]:
        if self._eager_batches is not None:
            return iter(self._eager_batches)
        return self._pipeline()

    def _pipeline(self) -> Iterator[P.Batch]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (max(self.epoch, 0) * 7919 + self.shard_id) if self.train else 1234
        )
        data = shard_list(self.data_list, self.epoch, self.shard_id, self.num_shards,
                          shuffle=self.train and cfg.shuffle)

        it: Iterator = P.parse_raw(iter(data))
        it = P.tokenize(it, self.tokenizer)
        if cfg.filter_data and self.train:
            it = P.filter_data(
                it,
                max_length=cfg.max_length,
                min_length=cfg.min_length,
                token_max_length=cfg.token_max_length,
                token_min_length=cfg.token_min_length,
                min_output_input_ratio=cfg.min_output_input_ratio,
                max_output_input_ratio=cfg.max_output_input_ratio,
            )
        it = P.resample(it, resample_rate=cfg.resample_rate)
        if self.train and cfg.speed_perturb:
            it = P.speed_perturb(it, speeds=tuple(cfg.speeds), rng=rng)
        if cfg.feat_type == "fbank":
            it = P.compute_fbank(
                it,
                num_mel_bins=cfg.num_mel_bins,
                frame_length=cfg.frame_length,
                frame_shift=cfg.frame_shift,
                dither=cfg.dither if self.train else 0.0,
                rng=rng,
            )
        elif cfg.feat_type == "mfcc":
            it = P.compute_mfcc(
                it,
                num_mel_bins=cfg.num_mel_bins,
                frame_length=cfg.frame_length,
                frame_shift=cfg.frame_shift,
                dither=cfg.dither if self.train else 0.0,
                num_ceps=cfg.num_ceps,
                high_freq=cfg.high_freq,
                low_freq=cfg.low_freq,
                rng=rng,
            )
        else:
            raise ValueError(f"unknown feat_type {cfg.feat_type!r}")
        if self.train and cfg.spec_aug:
            it = P.spec_aug(it, num_t_mask=cfg.num_t_mask, num_f_mask=cfg.num_f_mask,
                            max_t=cfg.max_t, max_f=cfg.max_f, rng=rng)
        if self.train and cfg.shuffle:
            it = P.shuffle(it, shuffle_size=cfg.shuffle_size, rng=rng)
        if self.train and cfg.sort:
            it = P.sort_by_length(it, sort_size=cfg.sort_size)

        batch_type = cfg.batch_type if self.train else "static"
        if batch_type == "bucket":
            boundaries = tuple(cfg.bucket_boundaries)
            if self.train and self.num_shards > 1 and len(boundaries) > 1:
                # every shard must present the same batch shape at a step
                boundaries = (boundaries[-1],)
            batches = P.bucket_batch(it, bucket_boundaries=boundaries,
                                     max_frames_in_batch=cfg.max_frames_in_batch,
                                     stats=self.padding_stats)
            yield from P.padding(batches, static_label_len=cfg.max_label_len)
        elif batch_type == "dynamic":
            yield from P.padding(P.dynamic_batch(it, cfg.max_frames_in_batch))
        else:
            yield from P.padding(P.static_batch(it, cfg.batch_size))


def eval_config(cfg: DataConfig, batch_size: int = 4) -> DataConfig:
    """``cfg`` for dev and test sets: no shuffling, sorting, speed
    perturbation or SpecAugment; static batches of ``batch_size``."""
    return dataclasses.replace(
        cfg,
        sort=False,
        shuffle=False,
        speed_perturb=False,
        spec_aug=False,
        batch_type="static",
        batch_size=batch_size,
    )
