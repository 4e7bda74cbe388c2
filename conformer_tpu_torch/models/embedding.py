"""Sinusoidal position encodings (JAX ``models/embedding.py``): the
encoder's relative table, the absolute one (the attention decoder's and
the encoder's absolute mode), and the rows of any integer positions for
the reference-parity modes."""

from __future__ import annotations

import math

import torch


def rel_freqs(d_model: int, device=None) -> torch.Tensor:
    """The d_model/2 sinusoid angular frequencies omega_k, float32."""
    return torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )


def sinusoid_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Absolute table [max_len, d] of positions 0..max_len-1, sin at even
    dims and cos at odd dims."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    ang = pos[:, None] * rel_freqs(d_model, device)[None, :]
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def absolute_pos_embed(table: torch.Tensor, offset: int, size: int) -> torch.Tensor:
    """table[offset : offset + size], the offset clamped so that the slice
    fits, as ``lax.dynamic_slice`` clamps it."""
    start = max(0, min(int(offset), table.shape[0] - size))
    return table[start:start + size]


def abs_pos_vectors(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """pe(pos) rows [P, d_model] for integer positions [P], negative ones
    included (a stream's key positions before its first frame), sin at
    even dims and cos at odd dims, float32."""
    ang = positions.float()[:, None] * rel_freqs(d_model, positions.device)[None, :]
    pe = torch.zeros((positions.shape[0], d_model), dtype=torch.float32,
                     device=positions.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def signed_sinusoid_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Relative-distance table [2*max_len-1, d]; row r is distance
    max_len-1-r (row 0 the largest positive distance), sin at even dims and
    cos at odd dims."""
    dist = (max_len - 1) - torch.arange(
        2 * max_len - 1, dtype=torch.float32, device=device
    )
    ang = dist[:, None] * rel_freqs(d_model, device)[None, :]
    pe = torch.zeros((2 * max_len - 1, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def relative_pos_embed(table: torch.Tensor, q_len: int, k_len: int) -> torch.Tensor:
    """Rows of the signed table for (q_len, k_len) attention:
    [q_len + k_len - 1, d], distances k_len-1 .. -(q_len-1) descending."""
    max_len = (table.shape[0] + 1) // 2
    start = max_len - k_len
    return table[start:start + q_len + k_len - 1]
