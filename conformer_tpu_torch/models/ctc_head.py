"""CTC head: projection to the vocabulary and its loss (JAX
``models/ctc_head.py``), with the reference's normalisation: the summed
per-sequence NLL divided by the padded label length ``labels.shape[1]``,
not by the batch size.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops.ctc import _extended_labels, ctc_loss_emit, ext_emissions
from . import layers
from .layers import Params


def ctc_logits(
    p: Params,
    encoder_out: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
) -> torch.Tensor:
    x = layers.dropout(gen, encoder_out, dropout_rate, deterministic)
    return layers.dense(p["ctc_lo"], x)


def ctc_head_loss(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_lens: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
    row_valid: torch.Tensor | None = None,
    model_shard=None,
) -> torch.Tensor:
    """sum over rows of the CTC NLL / U; rows where ``row_valid`` is False
    count 0. ``cfg.use_pallas_ctc`` takes the DP kernel
    (``ops/ctc_dp.py``), else the plain scan (``ops/ctc.py``), both on the
    extended labels' emissions [B, T, 2U+1]. ``model_shard``
    (``parallel/tensor.py``): ctc_lo holds this rank's vocabulary columns
    and the emissions come from the vocabulary-parallel log-softmax, the
    same on every rank, so the DP runs whole on each."""
    x = layers.dropout(gen, encoder_out, cfg.dropout, deterministic)
    ext = _extended_labels(labels.long(), cfg.blank_id)
    if model_shard is None:
        logits = layers.dense(p["ctc_lo"], x)
        emit = ext_emissions(torch.log_softmax(logits.float(), dim=-1), ext)
    else:
        logits = layers.dense(p["ctc_lo"], model_shard.copy_in(x))
        emit = model_shard.log_probs(logits, ext[:, None, :].expand(*x.shape[:2], -1))
    if cfg.use_pallas_ctc:
        from ..ops.ctc_dp import ctc_loss_dp_emit

        per_seq = ctc_loss_dp_emit(emit, encoder_out_lens, labels, label_lengths,
                                   blank=cfg.blank_id)
    else:
        per_seq = ctc_loss_emit(emit, encoder_out_lens, labels, label_lengths,
                                blank=cfg.blank_id)
    if row_valid is not None:
        per_seq = torch.where(row_valid, per_seq, 0.0)
    return per_seq.sum() / labels.shape[1]
