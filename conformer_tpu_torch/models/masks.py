"""Pad and attention masks (JAX ``models/masks.py``): full context, a
static chunk mask, and the dynamic-chunk mask of training, whose chunk
size and left-chunk count are drawn on a host ``torch.Generator`` (a
device draw would need a host sync to build the mask); the attention
decoder's causal mask and its target helpers (``add_sos_eos``,
``reverse_sequence``).
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


def make_subsequent_mask(length: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask [length, length], True = may attend."""
    pos = torch.arange(length, device=device)
    return pos[None, :] <= pos[:, None]


def sample_dynamic_chunk(
    gen: torch.Generator, max_len: int, use_dynamic_left_chunk: bool
) -> tuple[int, int]:
    """(chunk_size, num_left_chunks) of one training batch, with the JAX
    distribution: draw ~ U[1, max_len); full context (chunk max_len, left
    -1) when draw > max_len // 2, else chunk = draw % 25 + 1 and, with
    dynamic left chunks, left ~ U[0, max_len - 1), otherwise -1."""
    draw = int(torch.randint(1, max(max_len, 2), (), generator=gen))
    left_draw = int(torch.randint(0, max(max_len - 1, 1), (), generator=gen))
    if draw > max_len // 2:
        return max_len, -1
    return draw % 25 + 1, left_draw if use_dynamic_left_chunk else -1


def make_attn_mask(
    pad_mask: torch.Tensor,
    *,
    static_chunk_size: int,
    num_decoding_left_chunks: int,
    dynamic_chunk: tuple[int, int] | None = None,
) -> torch.Tensor:
    """[B, T, T] attention mask (True = attend).

    Key-side padding, intersected with the chunk mask of ``dynamic_chunk``
    = (chunk_size, num_left_chunks) when given (a training forward, drawn
    by ``sample_dynamic_chunk``), else with a static chunk mask when
    ``static_chunk_size > 0``.
    """
    bsz, max_len = pad_mask.shape
    valid = pad_mask[:, None, :]
    if dynamic_chunk is not None:
        chunk = subsequent_chunk_mask(max_len, *dynamic_chunk, device=pad_mask.device)
        return valid & chunk[None, :, :]
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


def add_blank(targets: torch.Tensor, blank: int, ignore_id: int) -> torch.Tensor:
    """[B, U] -> [B, U+1]: prepend blank and replace ignore_id with blank."""
    out = torch.cat([torch.full_like(targets[:, :1], blank), targets], dim=1)
    return torch.where(out == ignore_id, blank, out)


def add_sos_eos(
    targets: torch.Tensor, lengths: torch.Tensor, sos: int, eos: int, ignore_id: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """targets [B, U] (padded with ignore_id), lengths [B] -> (ys_in [B, U+1]
    = [sos, y...] padded with eos, ys_out [B, U+1] = [y..., eos] padded
    with ignore_id)."""
    clean = torch.where(targets == ignore_id, 0, targets)
    pos = torch.arange(targets.shape[1] + 1, device=targets.device)[None, :]
    n = lengths[:, None]
    ys_in = torch.cat([torch.full_like(targets[:, :1], sos), clean], dim=1)
    ys_in = torch.where(pos <= n, ys_in, eos)
    ys_out = torch.cat([clean, torch.zeros_like(targets[:, :1])], dim=1)
    ys_out = torch.where(pos == n, eos, torch.where(pos < n, ys_out, ignore_id))
    return ys_in, ys_out


def reverse_sequence(targets: torch.Tensor, lengths: torch.Tensor,
                     ignore_id: int) -> torch.Tensor:
    """Each row's first ``lengths`` tokens reversed, the rest ignore_id."""
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    idx = (lengths[:, None] - 1 - pos).clamp(min=0).long()
    return torch.where(pos < lengths[:, None], torch.gather(targets, 1, idx), ignore_id)
