"""A fixed pool of B streaming slots stepped by one batched [B, Tc, F]
chunk step per tick (JAX ``decode/stream_batch.py``).

``EncoderState`` carries per-row ``attn_len`` and ``offset``, so streams
that joined at different times share one pool. A slot is freed and reused
by ``pool_reset_slots`` (zero its caches, restore the fresh decode state).
Inactive slots ride along in the batch: their compute is masked out of the
state, not out of the work, and every tick has the same shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import encoder as encoder_mod
from ..models.encoder import EncoderState
from ..models.layers import Params
from ..models.predictor import PredictorState
from .greedy import GreedyState, greedy_search_batch, init_greedy_state


class SessionPool(NamedTuple):
    """The state of B independent streams (slots) on one device."""

    enc: EncoderState       # per-row caches, attn_len and offset
    dec: GreedyState        # per-row predictor state and last token
    hyps: torch.Tensor      # [B, max_hyp_len] int32
    hyp_len: torch.Tensor   # [B] int32


def init_pool(p: Params, cfg: ModelConfig, n_slots: int, *, cache_size: int = 512,
              max_hyp_len: int = 1024, device=None) -> SessionPool:
    """A pool of fresh slots on ``device`` (the card unless the CPU is
    asked for; ``p`` lies there)."""
    dev = resolve_device(device)
    return SessionPool(
        enc=encoder_mod.init_encoder_state(cfg, n_slots, cache_size, device=dev),
        dec=init_greedy_state(p, cfg, n_slots, dev),
        hyps=torch.full((n_slots, max_hyp_len), cfg.blank_id, dtype=torch.int32, device=dev),
        hyp_len=torch.zeros(n_slots, dtype=torch.int32, device=dev),
    )


def _rows(sel: torch.Tensor, new: EncoderState, old: EncoderState) -> EncoderState:
    """Per slot, ``new``'s encoder state where ``sel`` [B] is True, else
    ``old``'s (the caches' batch axis is 1)."""
    def pick(a, b):
        shape = [1] * a.dim()
        shape[1 if a.dim() > 1 else 0] = -1
        return torch.where(sel.reshape(shape), a, b)

    return EncoderState(*(pick(a, b) for a, b in zip(new, old)))


def pool_reset_slots(pool: SessionPool, reset: torch.Tensor, fresh_dec: GreedyState,
                     blank_id: int) -> SessionPool:
    """The slots where ``reset`` [B] is True become fresh streams.
    ``fresh_dec`` is the B=1 fresh decode state (``init_greedy_state(p,
    cfg, 1)``), the same for every slot, so callers make it once."""
    r = reset
    enc = _rows(r, EncoderState(*(torch.zeros_like(t) for t in pool.enc)), pool.enc)
    d = pool.dec
    dec = GreedyState(
        last_token=torch.where(r, fresh_dec.last_token[0], d.last_token),
        # the predictor's h and c are [layers, B, H]
        pred_state=PredictorState(*(torch.where(r[None, :, None], f[:, 0:1], x)
                                    for f, x in zip(fresh_dec.pred_state, d.pred_state))),
        pred_proj=torch.where(r[:, None], fresh_dec.pred_proj[0:1], d.pred_proj),
    )
    return SessionPool(enc=enc, dec=dec,
                       hyps=torch.where(r[:, None], blank_id, pool.hyps),
                       hyp_len=torch.where(r, 0, pool.hyp_len))


def pool_step(p: Params, pool: SessionPool, chunk_feats: torch.Tensor, active: torch.Tensor,
              out_valid: torch.Tensor, cfg: ModelConfig, *, n_steps: int = 64) -> SessionPool:
    """One batched tick: encode a chunk and advance the greedy decode of
    the active slots; an inactive slot's state is carried through
    unchanged.

    chunk_feats [B, Tc_in, F] raw feature frames (the window of
    ``chunk_window_params``; zeros for inactive slots); active bool [B]:
    the slots that received a chunk; out_valid int32 [B]: each active
    slot's valid SUBSAMPLED output frames (the chunk size mid-stream,
    fewer for a padded final chunk)."""
    enc_out, new_enc = encoder_mod.encoder_forward_chunk(
        p["encoder"], chunk_feats, pool.enc, cfg, cmvn=p.get("cmvn"))
    lens = torch.where(active, out_valid.clamp(max=enc_out.shape[1]), 0)
    hyps, hyp_len, dec = greedy_search_batch(
        p, enc_out, lens, cfg, state=pool.dec, n_steps=n_steps,
        max_hyp_len=pool.hyps.shape[1], hyps_init=pool.hyps, hyp_len_init=pool.hyp_len)
    # the decode state of a row with lens 0 is already unchanged
    return SessionPool(enc=_rows(active, new_enc, pool.enc), dec=dec, hyps=hyps,
                       hyp_len=hyp_len)
