"""CTC decoding (JAX ``decode/ctc_decode.py``): batched greedy search, and
the host prefix beam search (Hannun et al.) in float64 numpy, which is the
oracle of the batched device beam (``decode/ctc_beam_batched.py``) and of
the host rescoring path.

- ``ctc_greedy_search``: argmax -> collapse repeats -> drop blanks, the
  kept tokens compacted to the front by a stable sort, as JAX's
  ``jnp.argsort(..., stable=True)`` does.
- ``ctc_prefix_beam_search``: one utterance, (p_blank, p_nonblank) per
  prefix, per-frame top-k pruning by ``np.argpartition``.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from ..config import ModelConfig
from ..models import ctc_head
from ..models.layers import Params

_LOG_ZERO = -float("inf")


def ctc_log_probs(p: Params, encoder_out: torch.Tensor) -> torch.Tensor:
    """The CTC head's float32 log-softmax [B, T, V]."""
    return torch.log_softmax(ctc_head.ctc_logits(p["ctc"], encoder_out).float(), dim=-1)


def ctc_greedy_search(log_probs: torch.Tensor, lengths: torch.Tensor,
                      blank: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, V] log-probs -> (tokens [B, T] padded with blank, lens [B])."""
    t_max = log_probs.shape[1]
    best = log_probs.argmax(dim=-1).to(torch.int32)                  # first maximum
    t_idx = torch.arange(t_max, device=best.device)[None, :]
    valid = t_idx < lengths[:, None]
    prev = torch.nn.functional.pad(best, (1, 0), value=blank)[:, :t_max]
    keep = valid & (best != blank) & (best != prev)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    compacted = torch.gather(best, 1, order)
    out_lens = keep.sum(dim=1, dtype=torch.int32)
    return torch.where(t_idx < out_lens[:, None], compacted, blank), out_lens


def ctc_greedy_decode(p: Params, encoder_out: torch.Tensor, encoder_out_lens: torch.Tensor,
                      cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    return ctc_greedy_search(ctc_log_probs(p, encoder_out), encoder_out_lens, cfg.blank_id)


def _log_add(a: float, b: float) -> float:
    if a == _LOG_ZERO:
        return b
    if b == _LOG_ZERO:
        return a
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    length: int,
    beam_size: int = 8,
    blank: int = 0,
    top_k: int = 16,
) -> list[tuple[tuple[int, ...], float]]:
    """Prefix beam search over one utterance ([T, V] log-probs) -> the beam
    as [(prefix, log_prob)] best-first, log_prob merging both endings."""
    log_probs = np.asarray(log_probs, np.float64)
    beams: dict[tuple[int, ...], tuple[float, float]] = {(): (0.0, _LOG_ZERO)}
    k = min(top_k, log_probs.shape[1])
    for t in range(length):
        frame = log_probs[t]
        cand = (np.argpartition(frame, -k)[-k:] if k < log_probs.shape[1]
                else np.arange(log_probs.shape[1]))
        next_beams: dict[tuple[int, ...], list[float]] = defaultdict(
            lambda: [_LOG_ZERO, _LOG_ZERO])
        for prefix, (pb, pnb) in beams.items():
            p_total = _log_add(pb, pnb)
            last = prefix[-1] if prefix else None
            for v in cand:
                pv = float(frame[v])
                if v == blank:
                    nb = next_beams[prefix]
                    nb[0] = _log_add(nb[0], p_total + pv)
                elif v == last:
                    # a repeat extends the same prefix only through a blank gap
                    nb = next_beams[prefix]
                    nb[1] = _log_add(nb[1], pnb + pv)
                    ext = next_beams[prefix + (int(v),)]
                    ext[1] = _log_add(ext[1], pb + pv)
                else:
                    ext = next_beams[prefix + (int(v),)]
                    ext[1] = _log_add(ext[1], p_total + pv)
        scored = sorted(next_beams.items(), key=lambda kv: -_log_add(kv[1][0], kv[1][1]))
        beams = {key: (val[0], val[1]) for key, val in scored[:beam_size]}
    return [(prefix, _log_add(pb, pnb)) for prefix, (pb, pnb) in
            sorted(beams.items(), key=lambda kv: -_log_add(kv[1][0], kv[1][1]))]


def ctc_prefix_beam_decode(p: Params, encoder_out: torch.Tensor,
                           encoder_out_lens: torch.Tensor, cfg: ModelConfig,
                           beam_size: int = 8) -> list[list[int]]:
    """Device log-probs -> the host prefix beam per utterance -> top prefixes."""
    log_probs = ctc_log_probs(p, encoder_out).cpu().numpy()
    lens = encoder_out_lens.cpu().numpy()
    out = []
    for i in range(log_probs.shape[0]):
        beam = ctc_prefix_beam_search(log_probs[i], int(lens[i]), beam_size, cfg.blank_id)
        out.append(list(beam[0][0]) if beam else [])
    return out
