"""Streaming (chunked) greedy RNN-T decoding (JAX ``decode/streaming.py``).

  - ``streaming_greedy_search``: chunk-simulated streaming over whole
    utterances, batched: the JAX ``lax.scan`` over a static chunk grid
    becomes a Python loop of device work;
  - ``StreamingSession`` / ``new_session`` / ``session_accept_chunk``: live
    B=1 streams, an immutable state value that each chunk replaces.

The chunk window arithmetic (stride 4 chunk, window 4 (chunk - 1) + 7) is
``models.encoder.chunk_window_params``. The predictor state is carried
across chunks by default; ``reset_predictor_per_chunk=True`` restarts it
at every chunk, as the reference's streaming evaluation does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..device import resolve_device
from ..models import encoder as encoder_mod
from ..models.encoder import EncoderState
from ..models.layers import Params
from ..models.masks import subsampled_lengths
from .greedy import GreedyState, greedy_search_batch, init_greedy_state


def streaming_greedy_search(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    decoding_chunk_size: int,
    num_decoding_left_chunks: int = -1,
    max_cache_size: int = 512,
    n_steps: int = 64,
    max_hyp_len: int = 256,
    reset_predictor_per_chunk: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-simulated streaming decode of feats [B, T, F] with lengths
    [B], on the feats' device. ``decoding_chunk_size`` counts SUBSAMPLED
    frames; the cache holds ``decoding_chunk_size *
    num_decoding_left_chunks`` frames, or ``max_cache_size`` when the left
    chunks are unlimited (< 0). Returns (hyps [B, max_hyp_len], hyp_lens
    [B])."""
    stride, window, context = encoder_mod.chunk_window_params(decoding_chunk_size)
    bsz, t_total, _ = feats.shape
    if t_total < context:
        raise ValueError(f"utterance shorter than subsampling context ({context})")
    num_chunks = (t_total - context) // stride + 1
    pad_to = (num_chunks - 1) * stride + window
    if pad_to > t_total:
        feats = F.pad(feats, (0, 0, 0, pad_to - t_total))
    cache_size = (decoding_chunk_size * num_decoding_left_chunks
                  if num_decoding_left_chunks >= 0 else max_cache_size)
    dev = feats.device
    enc = encoder_mod.init_encoder_state(cfg, bsz, cache_size, device=dev)
    dec = init_greedy_state(p, cfg, bsz, dev)
    hyps = torch.full((bsz, max_hyp_len), cfg.blank_id, dtype=torch.int32, device=dev)
    hyp_len = torch.zeros(bsz, dtype=torch.int32, device=dev)
    out_lens_total = subsampled_lengths(feat_lengths.to(device=dev, dtype=torch.int32))
    for c in range(num_chunks):
        enc_out, enc = encoder_mod.encoder_forward_chunk(
            p["encoder"], feats[:, c * stride:c * stride + window], enc, cfg,
            cmvn=p.get("cmvn"))
        # frames of this chunk within each utterance
        valid = (out_lens_total - c * decoding_chunk_size).clamp(0, enc_out.shape[1])
        if reset_predictor_per_chunk:
            dec = init_greedy_state(p, cfg, bsz, dev)
        hyps, hyp_len, dec = greedy_search_batch(
            p, enc_out, valid, cfg, state=dec, n_steps=n_steps, max_hyp_len=max_hyp_len,
            hyps_init=hyps, hyp_len_init=hyp_len)
    return hyps, hyp_len


# ------------------------------------------------------------ live sessions


class StreamingSession(NamedTuple):
    """Immutable state of one live stream."""

    enc: EncoderState
    dec: GreedyState
    hyps: torch.Tensor      # [1, max_hyp_len]
    hyp_len: torch.Tensor   # [1]


def new_session(p: Params, cfg: ModelConfig, *, cache_size: int = 512,
                max_hyp_len: int = 1024, device=None) -> StreamingSession:
    """A fresh B=1 session on ``device`` (the card unless the CPU is
    asked for; ``p`` lies there)."""
    dev = resolve_device(device)
    return StreamingSession(
        enc=encoder_mod.init_encoder_state(cfg, 1, cache_size, device=dev),
        dec=init_greedy_state(p, cfg, 1, dev),
        hyps=torch.full((1, max_hyp_len), cfg.blank_id, dtype=torch.int32, device=dev),
        hyp_len=torch.zeros(1, dtype=torch.int32, device=dev),
    )


def session_accept_chunk(p: Params, session: StreamingSession, chunk_feats: torch.Tensor,
                         cfg: ModelConfig, *, n_steps: int = 64) -> StreamingSession:
    """One chunk of feature frames [1, Tc, F] (on the session's device)
    -> the next session: every subsampled frame of the chunk is decoded."""
    enc_out, enc = encoder_mod.encoder_forward_chunk(
        p["encoder"], chunk_feats, session.enc, cfg, cmvn=p.get("cmvn"))
    lens = torch.full((1,), enc_out.shape[1], dtype=torch.int32, device=enc_out.device)
    hyps, hyp_len, dec = greedy_search_batch(
        p, enc_out, lens, cfg, state=session.dec, n_steps=n_steps,
        max_hyp_len=session.hyps.shape[1], hyps_init=session.hyps,
        hyp_len_init=session.hyp_len)
    return StreamingSession(enc=enc, dec=dec, hyps=hyps, hyp_len=hyp_len)
