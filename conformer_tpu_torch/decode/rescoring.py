"""Attention rescoring (JAX ``decode/rescoring.py``): the CTC prefix beam's
n-best re-scored by the attention decoder, L2R and, when present and
``reverse_weight`` > 0, R2L:

    score = decoder_log_prob + ctc_weight * ctc_prefix_log_prob.

The decoder scores all B*K (utterance, hypothesis) pairs in one batched
forward per direction. ``attention_rescoring_batch`` takes the n-best
from the device prefix beam (``decode/ctc_beam_batched.py``) and picks
the winners on the device; ``attention_rescoring`` is the host path, on
the host prefix beam. Both raise ValueError for params without a
``decoder``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..models import decoder as decoder_mod
from ..models import masks
from ..models.layers import Params
from .ctc_beam_batched import ctc_prefix_beam_decode_batch
from .ctc_decode import ctc_log_probs, ctc_prefix_beam_search

_NO_DECODER = "attention_rescoring needs an attention decoder head"


def batched_decoder_scores(
    dec_params: Params,
    memory: torch.Tensor,
    memory_mask: torch.Tensor,
    hyps: torch.Tensor,
    hyp_lens: torch.Tensor,
    cfg: ModelConfig,
    *,
    reverse: bool = False,
) -> torch.Tensor:
    """Sum of log P(hyp + eos | memory) per row: memory [N, T, D] (the
    utterance's rows tiled over its n-best), memory_mask [N, T] bool,
    hyps [N, U] (padding irrelevant), hyp_lens [N]; ``reverse`` scores
    each row's reversed hypothesis (the R2L decoder). -> [N] float32."""
    if reverse:
        hyps = masks.reverse_sequence(hyps, hyp_lens, cfg.ignore_id)
    ys_in, ys_out = masks.add_sos_eos(hyps, hyp_lens, cfg.sos_eos_id, cfg.sos_eos_id,
                                      cfg.ignore_id)
    logits = decoder_mod.transformer_decoder_forward(dec_params, memory, memory_mask, ys_in,
                                                     hyp_lens + 1, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.where(ys_out == cfg.ignore_id, 0, ys_out).long()
    pick = torch.gather(logp, 2, tgt[..., None])[..., 0]
    u1 = torch.arange(hyps.shape[1] + 1, device=hyps.device)
    valid = u1[None, :] <= hyp_lens[:, None]                    # the tokens and eos
    return torch.where(valid, pick, 0.0).sum(dim=-1)


def _decoder_scores(p: Params, memory, memory_mask, hyps, hyp_lens, cfg: ModelConfig):
    """The L2R scores, blended with the R2L ones by ``reverse_weight``."""
    scores = batched_decoder_scores(p["decoder"]["left_decoder"], memory, memory_mask, hyps,
                                    hyp_lens, cfg)
    right = p["decoder"].get("right_decoder")
    if right is not None and cfg.reverse_weight > 0:
        r_scores = batched_decoder_scores(right, memory, memory_mask, hyps, hyp_lens, cfg,
                                          reverse=True)
        scores = (1 - cfg.reverse_weight) * scores + cfg.reverse_weight * r_scores
    return scores


def _tiled_memory(encoder_out: torch.Tensor, encoder_out_lens: torch.Tensor, n: int):
    """Each utterance's memory and pad mask repeated for its n hypotheses."""
    t_max = encoder_out.shape[1]
    mask = torch.arange(t_max, device=encoder_out.device)[None, :] < encoder_out_lens[:, None]
    return encoder_out.repeat_interleave(n, dim=0), mask.repeat_interleave(n, dim=0)


@torch.inference_mode()
def attention_rescoring(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_lens: torch.Tensor,
    cfg: ModelConfig,
    *,
    beam_size: int = 8,
    ctc_weight: float = 0.5,
    max_hyp_len: int = 64,
) -> list[list[int]]:
    """The host path: the n-best of each utterance by the host prefix beam
    (float64), one batched decoder forward per direction, the winners on
    the host. Returns each utterance's tokens."""
    if "decoder" not in p:
        raise ValueError(_NO_DECODER)
    log_probs = ctc_log_probs(p, encoder_out).cpu().numpy()
    lens = encoder_out_lens.cpu().numpy()
    bsz, n = encoder_out.shape[0], beam_size
    hyps = np.zeros((bsz * n, max_hyp_len), np.int32)
    hyp_lens = np.zeros((bsz * n,), np.int32)
    ctc_scores = np.full((bsz, n), -np.inf, np.float64)
    for i in range(bsz):
        nbest = ctc_prefix_beam_search(log_probs[i], int(lens[i]), beam_size, cfg.blank_id)
        for j, (prefix, score) in enumerate(nbest[:n]):
            prefix = prefix[:max_hyp_len]
            hyps[i * n + j, :len(prefix)] = prefix
            hyp_lens[i * n + j] = len(prefix)
            ctc_scores[i, j] = score
    memory, memory_mask = _tiled_memory(encoder_out, encoder_out_lens, n)
    dev = encoder_out.device
    dec_scores = _decoder_scores(p, memory, memory_mask, torch.from_numpy(hyps).to(dev),
                                 torch.from_numpy(hyp_lens).to(dev), cfg)
    total = dec_scores.cpu().numpy().reshape(bsz, n) + ctc_weight * ctc_scores
    results = []
    for i in range(bsz):           # absent hypotheses (-inf) lose
        j = int(np.argmax(total[i]))
        results.append(list(map(int, hyps[i * n + j, :hyp_lens[i * n + j]])))
    return results


def attention_rescoring_batch(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_lens: torch.Tensor,
    cfg: ModelConfig,
    *,
    beam_size: int = 8,
    ctc_weight: float = 0.5,
    max_hyp_len: int = 64,
    top_c: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The device path: the n-best by the batched device prefix beam, the
    decoder's scores, the winner by argmax, with no host sync. Returns
    (hyps [B, max_hyp_len] blank-padded, lens [B])."""
    if "decoder" not in p:
        raise ValueError(_NO_DECODER)
    bsz, n = encoder_out.shape[0], beam_size
    toks, lens, ctc_scores = ctc_prefix_beam_decode_batch(
        p, encoder_out, encoder_out_lens, cfg, beam_size=n, max_hyp_len=max_hyp_len,
        top_c=top_c)                                               # [B, K, L], [B, K]
    memory, memory_mask = _tiled_memory(encoder_out, encoder_out_lens, n)
    dec_scores = _decoder_scores(p, memory, memory_mask, toks.reshape(bsz * n, max_hyp_len),
                                 lens.reshape(bsz * n), cfg).reshape(bsz, n)
    total = dec_scores + ctc_weight * ctc_scores
    # dead beam slots (ctc score ~ NEG_INF) never win, even at ctc_weight 0
    total = torch.where(ctc_scores < -1e29, -torch.inf, total)
    best = total.argmax(dim=1)                                     # the first maximum
    out_toks = torch.gather(toks, 1, best[:, None, None].expand(bsz, 1, max_hyp_len))[:, 0]
    return out_toks, torch.gather(lens, 1, best[:, None])[:, 0]
