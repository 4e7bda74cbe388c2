"""CTC loss, plain PyTorch: the log-space alpha recursion over time (JAX
``ops/ctc.py``), with torch CTCLoss(reduction='none') semantics.

This is the oracle of the CTC DP kernel (``ops/ctc_dp.py``) and the path
the CTC head takes when ``use_pallas_ctc`` is off: one loop step per frame
over a [B, S] carry (S = 2U+1 interleaved-blank states), differentiable by
autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _extended_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, U] -> [B, 2U+1] interleaved with blanks: b l1 b l2 ... lU b."""
    bsz, u = labels.shape
    ext = torch.full((bsz, 2 * u + 1), blank, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def skip_allowed(ext: torch.Tensor, blank: int) -> torch.Tensor:
    """bool [B, S]: the s-2 -> s transition is allowed where ext[s] is not
    blank and differs from ext[s-2]."""
    prev2 = F.pad(ext, (2, 0), value=blank)[:, : ext.shape[1]]
    return (ext != blank) & (ext != prev2)


def ctc_loss(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """Per-sequence CTC NLL [B] (float32) from log_probs [B, T, V]; alpha
    freezes at t >= input_length."""
    ext = _extended_labels(labels.long(), blank)
    return ctc_loss_emit(ext_emissions(log_probs.float(), ext), input_lengths, labels,
                         label_lengths, blank)


def ext_emissions(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """log_probs [B, T, V] at the extended labels ext [B, S] -> [B, T, S]."""
    bsz, t_max, _ = log_probs.shape
    return log_probs.gather(2, ext[:, None, :].expand(bsz, t_max, ext.shape[1]))


def ctc_loss_emit(
    emit: torch.Tensor,
    input_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """``ctc_loss`` from the emissions of the extended labels, emit [B, T,
    2U+1] float32 (``ext_emissions``; under a model axis
    ``ModelShard.log_probs`` of the vocabulary shards)."""
    emit = emit.float()
    t_max, s_max = emit.shape[1], 2 * labels.shape[1] + 1
    ext = _extended_labels(labels.long(), blank)
    can_skip = skip_allowed(ext, blank)
    s_idx = torch.arange(s_max, device=emit.device)

    alpha = torch.where(s_idx[None, :] < 2, emit[:, 0, :], NEG_INF)
    alpha = torch.where((s_idx[None, :] == 1) & (label_lengths[:, None] == 0), NEG_INF, alpha)
    for t in range(1, t_max):
        from_prev = F.pad(alpha, (1, 0), value=NEG_INF)[:, :s_max]
        from_skip = torch.where(
            can_skip, F.pad(alpha, (2, 0), value=NEG_INF)[:, :s_max], NEG_INF
        )
        summed = torch.logaddexp(torch.logaddexp(alpha, from_prev), from_skip)
        new_alpha = (summed + emit[:, t, :]).clamp_min(NEG_INF)
        alpha = torch.where((t < input_lengths)[:, None], new_alpha, alpha)

    s_last = (2 * label_lengths).long()
    final_blank = alpha.gather(1, s_last[:, None])[:, 0]
    final_label = alpha.gather(1, (s_last - 1).clamp_min(0)[:, None])[:, 0]
    final_label = torch.where(label_lengths > 0, final_label, NEG_INF)
    return -torch.logaddexp(final_blank, final_label)


def ctc_loss_from_logits(
    logits: torch.Tensor,
    input_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """``ctc_loss`` of the float32 log-softmax of logits [B, T, V]."""
    return ctc_loss(torch.log_softmax(logits.float(), dim=-1), input_lengths, labels,
                    label_lengths, blank)
