"""Batched CTC prefix beam search on the device (JAX
``decode/ctc_beam_batched.py``), the device counterpart of the host
``ctc_decode.ctc_prefix_beam_search``. A loop over frames, each frame:

  1. every surviving prefix takes its two "stay" transitions (blank keeps
     both endings; repeating the last label keeps the non-blank ending),
  2. the frame's top-C labels spawn K*C "extend" candidates, scored pb
     (a repeat across a blank gap) or pb + pnb (a new label),
  3. an extend whose labels already sit in a beam slot log-adds into that
     slot (Hannun's dict-keyed merge) instead of duplicating it: a [B, K,
     C, K] equality pass,
  4. top-K over the K + K*C pooled totals re-forms the beam.

All state has static shapes (tokens [B, K, L], (pb, pnb) [B, K]); dead
slots sit at ``NEG_INF``, and every top-K and argsort keeps JAX's tie
order (``decode/search.py``). With top_c = V the search is exact and
matches the host oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..models.layers import Params
from .ctc_decode import ctc_log_probs
from .search import NEG_INF, argsort_desc, gather_k, top_k


class CtcBeamState(NamedTuple):
    tokens: torch.Tensor   # [B, K, L] int32 (blank-padded)
    lengths: torch.Tensor  # [B, K] int32
    pb: torch.Tensor       # [B, K] log P(prefix, ends in blank)
    pnb: torch.Tensor      # [B, K] log P(prefix, ends in non-blank)


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b), NEG_INF where both are dead (below NEG_INF / 2)."""
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    return torch.where(hi > 0.5 * NEG_INF, hi + torch.log1p(torch.exp(lo - hi)), NEG_INF)


def _frame_step(state: CtcBeamState, frame: torch.Tensor, active: torch.Tensor, *,
                blank: int, c: int) -> CtcBeamState:
    """One frame of log-probs [B, V]; rows where ``active`` [B, 1] is false
    keep their state."""
    tokens, lens, pb, pnb = state
    bsz, k, el = tokens.shape
    dev = tokens.device
    pos = torch.arange(el, device=dev)
    slots = torch.arange(k, device=dev)
    ptot = _logaddexp(pb, pnb)

    # stay transitions
    pb_stay = ptot + frame[:, blank][:, None]
    last = torch.gather(tokens, 2, (lens - 1).clamp(min=0)[:, :, None].long())[:, :, 0]
    has_last = lens > 0
    last_lp = torch.gather(frame, 1, torch.where(has_last, last, 0).long())
    pnb_stay = torch.where(has_last, pnb + last_lp, NEG_INF)   # a repeat without a gap

    # extend candidates
    cv, ci = top_k(frame, c)                                    # [B, C]
    is_last = ci[:, None, :] == torch.where(has_last, last, -1)[:, :, None]
    ext = torch.where(is_last, pb[:, :, None], ptot[:, :, None]) + cv[:, None, :]
    ext = torch.where((ci == blank)[:, None, :], NEG_INF, ext)
    ext = torch.where((lens < el)[:, :, None], ext, NEG_INF)   # [B, K, C]

    # merge extends into existing slots: extend (k, c) forms prefix_k + ci;
    # if slot j already holds that label sequence, its mass log-adds into
    # j's pnb and the extend dies
    len_match = lens[:, None, :] == lens[:, :, None] + 1      # [B, Kext, Kstay]
    within = pos[None, None, None, :] < lens[:, :, None, None]
    tok_eq = torch.where(within, tokens[:, :, None, :] == tokens[:, None, :, :], True)
    prefix_eq = len_match & tok_eq.all(dim=-1)
    at_len = lens.clamp(0, el - 1)[:, :, None, None].long().expand(bsz, k, k, 1)
    tok_at_len = torch.gather(tokens[:, None].expand(bsz, k, k, el), 3, at_len)[..., 0]
    match = prefix_eq[:, :, None, :] & (tok_at_len[:, :, None, :] == ci[:, None, :, None])
    # each extend merges into at most one stay, the live copy first
    stay_key = torch.where(match, ptot[:, None, None, :], NEG_INF)
    j_sel = stay_key.argmax(dim=-1)                             # first maximum
    match = match & (slots == j_sel[..., None])
    merged_away = match.any(dim=-1)                             # [B, K, C]
    add_mass = torch.where(match, ext[..., None], NEG_INF).reshape(bsz, k * c, k)
    m = add_mass.max(dim=1).values                              # [B, Kstay]
    live = m > 0.5 * NEG_INF
    safe_m = torch.where(live, m, 0.0)
    pnb_add = torch.where(
        live, safe_m + torch.log(torch.exp(add_mass - safe_m[:, None, :]).sum(dim=1)), NEG_INF)
    pnb_stay = _logaddexp(pnb_stay, pnb_add)
    ext = torch.where(merged_away, NEG_INF, ext).reshape(bsz, k * c)

    # pool stays and extends, top-K
    pool = torch.cat([_logaddexp(pb_stay, pnb_stay), ext], dim=1)   # [B, K + K*C]
    _, top_idx = top_k(pool, k)
    from_ext = top_idx >= k
    stay_j = torch.where(from_ext, 0, top_idx)
    ext_flat = torch.where(from_ext, top_idx - k, 0)
    src = torch.where(from_ext, torch.div(ext_flat, c, rounding_mode="floor"), stay_j)
    new_tok = torch.gather(ci, 1, ext_flat % c)                 # [B, K]
    toks = gather_k(tokens, src)
    lens_src = gather_k(lens, src)
    write = from_ext[:, :, None] & (pos[None, None, :] == lens_src[:, :, None])
    toks = torch.where(write, new_tok[:, :, None].to(toks.dtype), toks)
    new_lens = lens_src + from_ext.to(torch.int32)
    new_pb = torch.where(from_ext, NEG_INF, gather_k(pb_stay, stay_j))
    new_pnb = torch.where(from_ext, torch.gather(ext, 1, ext_flat), gather_k(pnb_stay, stay_j))
    return CtcBeamState(
        tokens=torch.where(active[:, :, None], toks, tokens),
        lengths=torch.where(active, new_lens, lens),
        pb=torch.where(active, new_pb, pb),
        pnb=torch.where(active, new_pnb, pnb),
    )


def ctc_prefix_beam_batch(
    log_probs: torch.Tensor,
    lengths: torch.Tensor,
    *,
    beam_size: int = 8,
    blank: int = 0,
    max_hyp_len: int = 256,
    top_c: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """log_probs [B, T, V] (log-softmaxed), lengths [B] -> (tokens [B, K,
    max_hyp_len] blank-padded, lengths [B, K], scores [B, K] =
    logaddexp(pb, pnb)), best first along K. ``top_c``: labels per frame
    (V for the exact search). No host sync: the loop runs over T."""
    bsz, t_max, v = log_probs.shape
    k, dev = beam_size, log_probs.device
    first = torch.arange(k, device=dev)[None, :] == 0
    state = CtcBeamState(
        tokens=torch.full((bsz, k, max_hyp_len), blank, dtype=torch.int32, device=dev),
        lengths=torch.zeros((bsz, k), dtype=torch.int32, device=dev),
        # slot 0 = the empty prefix with certainty; the rest dead
        pb=torch.where(first, 0.0, NEG_INF).float().expand(bsz, k).contiguous(),
        pnb=torch.full((bsz, k), NEG_INF, device=dev),
    )
    lengths = lengths.to(dev)
    for t in range(t_max):
        state = _frame_step(state, log_probs[:, t], (t < lengths)[:, None], blank=blank,
                            c=min(top_c, v))
    scores = _logaddexp(state.pb, state.pnb)
    order = argsort_desc(scores, dim=1)
    return (gather_k(state.tokens, order), gather_k(state.lengths, order),
            torch.gather(scores, 1, order))


def ctc_prefix_beam_decode_batch(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_lens: torch.Tensor,
    cfg: ModelConfig,
    *,
    beam_size: int = 8,
    max_hyp_len: int = 256,
    top_c: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device n-best: encoder output -> (tokens [B, K, L], lens, scores)."""
    return ctc_prefix_beam_batch(
        ctc_log_probs(p, encoder_out), encoder_out_lens, beam_size=beam_size,
        blank=cfg.blank_id, max_hyp_len=max_hyp_len, top_c=top_c)
