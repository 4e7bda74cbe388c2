"""Batched greedy RNN-T search (JAX ``decode/greedy.py``).

Semantics kept exactly from the JAX ``lax.while_loop`` version:
  - frame-synchronous: at frame t emit symbols until blank;
  - at most ``n_steps`` non-blank emissions per frame, the cap checked
    AFTER emitting (a frame can emit the token that reaches the cap and
    then advance);
  - the predictor steps only on non-blank emissions, carrying (h, c);
  - decoding starts from a blank token with a zero predictor state;
  - each iteration scores a WINDOW of ``window`` frames at the current
    predictor state and consumes its leading run of blank frames at once.

The while loop becomes a Python loop of device ops. Its body leaves a
finished row (t >= length) unchanged: ``emit`` is false, so t, the
hypothesis, its length and the predictor state hold. Iterations past the
JAX loop's end are therefore no-ops, and the host tests ``any(t < lens)``
only once every ``_SYNC_EVERY`` iterations instead of syncing on each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..models import layers, predictor
from ..models.layers import Params
from ..models.predictor import PredictorState

_SYNC_EVERY = 8


class GreedyState(NamedTuple):
    """Carry-over decode state (per batch row)."""

    last_token: torch.Tensor     # [B] int32, last emitted (or blank at start)
    pred_state: PredictorState   # committed predictor (h, c)
    pred_proj: torch.Tensor      # [B, J] pred_ffn(predictor_out) for last_token


def init_greedy_state(p: Params, cfg: ModelConfig, batch: int, device=None) -> GreedyState:
    tok = torch.full((batch,), cfg.blank_id, dtype=torch.int32, device=device)
    st0 = predictor.init_predictor_state(cfg, batch, device)
    out, st1 = predictor.predictor_step(p["predictor"], tok, st0, cfg)
    proj = layers.dense(p["joint"]["pred_ffn"], out)
    return GreedyState(last_token=tok, pred_state=st1, pred_proj=proj)


def greedy_search_batch(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_lens: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: GreedyState | None = None,
    n_steps: int = 64,
    max_hyp_len: int = 256,
    hyps_init: torch.Tensor | None = None,
    hyp_len_init: torch.Tensor | None = None,
    window: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, GreedyState]:
    """Greedy transducer decode of encoder_out [B, T, D] with lengths [B].

    Returns (hyps [B, max_hyp_len] int32 padded with blank, hyp_lens [B]
    int32, final GreedyState).
    """
    bsz, t_max, _ = encoder_out.shape
    dev = encoder_out.device
    lens = encoder_out_lens.to(device=dev, dtype=torch.int32)
    st = state if state is not None else init_greedy_state(p, cfg, bsz, dev)
    enc_proj = layers.dense(p["joint"]["enc_ffn"], encoder_out)          # [B, T, J]
    j = enc_proj.shape[-1]

    t = torch.zeros(bsz, dtype=torch.int32, device=dev)
    noblk = torch.zeros(bsz, dtype=torch.int32, device=dev)
    hyps = (
        hyps_init.clone() if hyps_init is not None
        else torch.full((bsz, max_hyp_len), cfg.blank_id, dtype=torch.int32, device=dev)
    )
    hyp_len = (
        hyp_len_init.clone() if hyp_len_init is not None
        else torch.zeros(bsz, dtype=torch.int32, device=dev)
    )
    last_token, pred_state, pred_proj = st
    w_idx = torch.arange(window, dtype=torch.int32, device=dev)
    slots = torch.arange(max_hyp_len, dtype=torch.int32, device=dev)

    while bool((t < lens).any()):
        for _ in range(_SYNC_EVERY):
            active = t < lens
            frame = t[:, None] + w_idx[None, :]                              # [B, W]
            idx = frame.clamp(max=t_max - 1).long()
            enc_win = torch.gather(enc_proj, 1, idx[:, :, None].expand(-1, -1, j))
            logits = layers.dense(
                p["joint"]["ffn_out"], torch.tanh(enc_win + pred_proj[:, None, :])
            )                                                                # [B, W, V]
            best_w = logits.argmax(dim=-1).to(torch.int32)
            blank_w = (best_w == cfg.blank_id) | (frame >= lens[:, None])
            # leading run of blanks: these frames advance without emitting
            nb_raw = torch.cumprod(blank_w.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
            frames_left = (lens - t).clamp(min=0)
            found = (nb_raw < window) & (nb_raw < frames_left)
            best = torch.gather(best_w, 1, nb_raw.clamp(max=window - 1)[:, None].long())[:, 0]

            emit = active & found & (hyp_len < max_hyp_len)
            # a fresh frame (blanks consumed) starts the per-frame count at 1
            new_noblk = torch.where(nb_raw > 0, 1, noblk + 1)
            hyps = torch.where(
                emit[:, None] & (slots[None, :] == hyp_len[:, None]), best[:, None], hyps
            )
            # skip one more frame if the emission hit the per-frame cap or
            # the hypothesis buffer is full
            skip_frame = (emit & (new_noblk >= n_steps)) | (
                active & found & (hyp_len >= max_hyp_len)
            )
            hyp_len = torch.where(emit, hyp_len + 1, hyp_len)

            tok = torch.where(emit, best, last_token)
            out, pred_state = predictor.predictor_step(
                p["predictor"], tok, pred_state, cfg, padding=(~emit).to(torch.int32)
            )
            proj = layers.dense(p["joint"]["pred_ffn"], out)
            pred_proj = torch.where(emit[:, None], proj, pred_proj)
            last_token = tok
            nb_skip = torch.minimum(nb_raw, frames_left)
            t = torch.where(active, t + nb_skip + skip_frame.to(torch.int32), t)
            noblk = torch.where(emit & (new_noblk < n_steps), new_noblk, 0)
    return hyps, hyp_len, GreedyState(last_token, pred_state, pred_proj)


def greedy_search(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    n_steps: int = 64,
    max_hyp_len: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-utterance greedy decode: encoder forward + greedy search."""
    from ..models import transducer

    enc_out, enc_lens = transducer.encode(p, feats, feat_lengths, cfg)
    hyps, lens, _ = greedy_search_batch(
        p, enc_out, enc_lens, cfg, n_steps=n_steps, max_hyp_len=max_hyp_len
    )
    return hyps, lens
