"""Tie orders of the batched beams: the device searches (``beam_batched``,
``ctc_beam_batched``) hold dead slots at ``NEG_INF``, where they tie
exactly (``-1e30 + logp`` rounds back to -1e30 in float32), so the order
among ties decides which slot's tokens and predictor state are gathered.
JAX's ``lax.top_k`` puts the lower index first among equals and
``jnp.argsort`` is stable; ``torch.topk`` and the default
``torch.argsort`` promise no order for ties, so these helpers sort stably
instead.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest in descending order,
    ties by the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def argsort_desc(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argsort(-x)``: ascending in -x, stable."""
    return torch.argsort(-x, dim=dim, stable=True)


def gather_k(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the K axis: x [B, K, ...], idx [B, K'] -> [B, K', ...]."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.long().reshape(idx.shape + (1,) * (x.ndim - 2)).expand(shape))
