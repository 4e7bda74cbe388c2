"""RNN-T beam search over one utterance on the host (JAX ``decode/beam.py``):
the frame-synchronous beam of Graves 2012 with prefix merging, one
hypothesis at a time through ``predictor_step`` and ``joint_step``. It
is the oracle of the batched device beam (``decode/beam_batched.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import ModelConfig
from ..models import joint as joint_mod
from ..models import predictor
from ..models.layers import Params
from ..models.predictor import PredictorState


def _log_add(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


@dataclass
class Hyp:
    tokens: tuple[int, ...]
    log_prob: float
    state: PredictorState
    pred_out: torch.Tensor  # [1, P] predictor output after the last token


@torch.inference_mode()
def rnnt_beam_search(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_len: int,
    cfg: ModelConfig,
    beam_size: int = 8,
    max_expansions: int = 3,
) -> list[tuple[list[int], float]]:
    """Beam search over encoder_out [T, D]: at each frame a hypothesis
    emits up to ``max_expansions`` non-blank labels before it must take
    blank; identical prefixes merge by log-sum-exp. Returns [(tokens,
    log_prob)] best first."""
    blank = cfg.blank_id
    dev = encoder_out.device
    out0, st1 = predictor.predictor_step(
        p["predictor"], torch.tensor([blank], dtype=torch.int32, device=dev),
        predictor.init_predictor_state(cfg, 1, dev), cfg)
    beams: list[Hyp] = [Hyp((), 0.0, st1, out0)]

    for t in range(encoder_out_len):
        enc_t = encoder_out[t:t + 1]                                    # [1, D]
        # A-list: hypotheses that may still emit at this frame; B-list: done
        a_list = beams
        b_list: dict[tuple[int, ...], Hyp] = {}
        for _ in range(max_expansions + 1):
            if not a_list:
                break
            next_a: dict[tuple[int, ...], Hyp] = {}
            for hyp in a_list:
                logits = joint_mod.joint_step(p["joint"], enc_t, hyp.pred_out)
                logp_np = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()[0]
                # blank: the hypothesis survives to the next frame unchanged
                b_lp = hyp.log_prob + float(logp_np[blank])
                cur = b_list.get(hyp.tokens)
                if cur is None:
                    b_list[hyp.tokens] = Hyp(hyp.tokens, b_lp, hyp.state, hyp.pred_out)
                else:
                    cur.log_prob = _log_add(cur.log_prob, b_lp)
                # the top non-blank extensions (the beam may exceed the vocabulary)
                n_top = min(beam_size, logp_np.shape[0])
                for v in np.argpartition(logp_np, -n_top)[-n_top:]:
                    v = int(v)
                    if v == blank:
                        continue
                    lp = hyp.log_prob + float(logp_np[v])
                    tokens = hyp.tokens + (v,)
                    existing = next_a.get(tokens)
                    if existing is not None:
                        existing.log_prob = _log_add(existing.log_prob, lp)
                        continue
                    out, st = predictor.predictor_step(
                        p["predictor"], torch.tensor([v], dtype=torch.int32, device=dev),
                        hyp.state, cfg)
                    next_a[tokens] = Hyp(tokens, lp, st, out)
            a_list = sorted(next_a.values(), key=lambda h: -h.log_prob)[:beam_size]
        beams = sorted(b_list.values(), key=lambda h: -h.log_prob)[:beam_size]
    return [(list(h.tokens), h.log_prob) for h in beams]


def rnnt_beam_decode(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_lens: torch.Tensor,
    cfg: ModelConfig,
    beam_size: int = 8,
) -> list[list[int]]:
    """Per-utterance host beam over a batch of encoder outputs -> the top
    hypothesis of each."""
    lens = encoder_out_lens.cpu().numpy()
    out = []
    for i in range(encoder_out.shape[0]):
        beam = rnnt_beam_search(p, encoder_out[i], int(lens[i]), cfg, beam_size)
        out.append(beam[0][0] if beam else [])
    return out
