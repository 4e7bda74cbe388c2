"""Pad and attention masks for the full-utterance inference forward.

Counterpart of the JAX package's ``models/masks.py``. Only the
deterministic masks are here: full context, and a static chunk mask. The
dynamic-chunk training masks come with the training slice.
"""

from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """bool [B, max_len], True at t >= length (padding)."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] >= lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """bool [B, max_len], True where a frame is valid."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_chunk_mask(
    size: int, chunk_size: int, num_left_chunks: int = -1, device=None
) -> torch.Tensor:
    """Chunk-causal mask [size, size], True = may attend.

    Row i attends to columns [start, (i//chunk + 1) * chunk) with
    start = max((i//chunk - num_left_chunks) * chunk, 0), or 0 when
    num_left_chunks < 0.
    """
    row = torch.arange(size, device=device)[:, None]
    col = torch.arange(size, device=device)[None, :]
    row_chunk = row // chunk_size
    ending = (row_chunk + 1) * chunk_size
    if num_left_chunks < 0:
        start = torch.zeros_like(row_chunk)
    else:
        start = ((row_chunk - num_left_chunks) * chunk_size).clamp(min=0)
    return (col >= start) & (col < ending)


def make_attn_mask(
    pad_mask: torch.Tensor, *, static_chunk_size: int, num_decoding_left_chunks: int
) -> torch.Tensor:
    """[B, T, T] attention mask (True = attend) of an inference forward.

    Key-side padding, intersected with a static chunk mask when
    ``static_chunk_size > 0`` (the JAX ``make_attn_mask`` with dynamic
    chunking off, as it is in every deterministic forward).
    """
    bsz, max_len = pad_mask.shape
    valid = pad_mask[:, None, :]
    if static_chunk_size > 0:
        chunk = subsequent_chunk_mask(
            max_len, static_chunk_size, num_decoding_left_chunks, pad_mask.device
        )
        return valid & chunk[None, :, :]
    return valid.expand(bsz, max_len, max_len)


def subsampled_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Lengths through the x4 subsampler (two valid stride-2 k=3 convs)."""
    return torch.div(
        torch.div(lengths - 1, 2, rounding_mode="floor") - 1, 2, rounding_mode="floor"
    )
