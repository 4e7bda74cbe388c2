"""Batched RNN-T beam search on the device (JAX ``decode/beam_batched.py``).

A loop over frames (JAX's ``lax.scan``); per frame up to
``max_expansions`` non-blank expansion rounds, each one joint evaluation
[B, K, V] plus a top-K. Hypotheses that take blank are frozen into the
frame's survivor set; survivors seed the next frame. At the end of each
frame, hypotheses with identical label prefixes (different alignments of
the same labels) are merged by log-sum-exp, an O(K^2 L) elementwise pass
(``decode/beam.py`` is the per-hypothesis host oracle of the same
Graves-2012 rule).

All state has static shapes: tokens [B, K, L], the predictor's (h, c) per
hypothesis, log-probs [B, K]. Dead slots sit at ``NEG_INF``, where they
tie exactly, so every top-K and argsort keeps JAX's tie order
(``decode/search.py``).

With ``blank_skip_window`` the frames advance per row in a loop whose
condition (any row unfinished) is read on the host once per iteration
(JAX's ``lax.while_loop``); ``beam_search_batch.host_syncs`` counts those
reads. Without it the loop over frames needs no host sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import ModelConfig
from ..models import layers, predictor
from ..models.layers import Params
from ..models.predictor import PredictorState
from .search import NEG_INF, argsort_desc, gather_k, top_k


class BeamState(NamedTuple):
    tokens: torch.Tensor     # [B, K, L]
    lengths: torch.Tensor    # [B, K]
    log_probs: torch.Tensor  # [B, K]
    pred_h: torch.Tensor     # [Lp, B, K, H]
    pred_c: torch.Tensor     # [Lp, B, K, H]
    pred_proj: torch.Tensor  # [B, K, J]


def _gather_state(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """gather_k on the predictor state's K axis: x [Lp, B, K, H]."""
    return gather_k(x.movedim(0, 2), idx).movedim(2, 0)


def _select(cond: torch.Tensor, a: BeamState, b: BeamState) -> BeamState:
    """Per slot (cond [B, K]) or per row (cond [B, 1]): a where cond, else b."""
    def sel(x, y, lead=0):
        shape = (1,) * lead + cond.shape + (1,) * (x.ndim - lead - 2)
        return torch.where(cond.reshape(shape), x, y)

    return BeamState(
        tokens=sel(a.tokens, b.tokens), lengths=sel(a.lengths, b.lengths),
        log_probs=sel(a.log_probs, b.log_probs), pred_h=sel(a.pred_h, b.pred_h, 1),
        pred_c=sel(a.pred_c, b.pred_c, 1), pred_proj=sel(a.pred_proj, b.pred_proj))


def _pick(done: BeamState, a: BeamState, scores: torch.Tensor,
          top_idx: torch.Tensor) -> BeamState:
    """The survivors of a blank move: entry i of the top-K over [done
    (K), a + blank (K)] takes done's slot top_idx or a's slot top_idx - K."""
    k = done.log_probs.shape[1]
    from_new = top_idx >= k
    src = torch.where(from_new, top_idx - k, top_idx)
    d_idx, a_idx = torch.where(from_new, 0, src), torch.where(from_new, src, 0)

    def take(s: BeamState, idx):
        return BeamState(gather_k(s.tokens, idx), gather_k(s.lengths, idx), scores,
                         _gather_state(s.pred_h, idx), _gather_state(s.pred_c, idx),
                         gather_k(s.pred_proj, idx))

    return _select(from_new, take(a, a_idx), take(done, d_idx))


def _merge_duplicate_prefixes(state: BeamState) -> BeamState:
    """Log-sum-exp hypotheses with identical label prefixes.

    Two slots holding the same token sequence are different alignments of
    the same labels; their path probabilities add. The predictor state is
    a function of the tokens, so keeping the lowest-index slot's state is
    lossless. The other copies are killed (NEG_INF), not compacted: the
    slots are static, which narrows the effective beam for one frame.
    """
    _, k, max_len = state.tokens.shape
    pos = torch.arange(max_len, device=state.tokens.device)
    len_eq = state.lengths[:, :, None] == state.lengths[:, None, :]             # [B,K,K]
    within = pos[None, None, None, :] < state.lengths[:, :, None, None]
    tok_eq = torch.where(within, state.tokens[:, :, None, :] == state.tokens[:, None, :, :],
                         True)
    eq = len_eq & tok_eq.all(dim=-1)
    rep = eq.to(torch.int8).argmax(dim=-1)           # the first slot holding this prefix
    is_rep = rep == torch.arange(k, device=rep.device)[None, :]
    pooled = torch.logsumexp(torch.where(eq, state.log_probs[:, None, :], NEG_INF), dim=-1)
    return state._replace(log_probs=torch.where(is_rep, pooled, NEG_INF).to(state.log_probs.dtype))


def beam_search_batch(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_out_lens: torch.Tensor,
    cfg: ModelConfig,
    *,
    beam_size: int = 8,
    max_expansions: int = 2,
    max_hyp_len: int = 256,
    merge_prefixes: bool = True,
    blank_skip_window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam decode of encoder_out [B, T, D] with lengths [B].

    merge_prefixes: pool alignments of identical label sequences by
        log-sum-exp (Graves-2012 semantics); off, each slot is one
        alignment (a Viterbi-style beam).
    blank_skip_window: 0 = one full frame step per frame. > 0 = blank-run
        skipping: per row, a window of this many frames is scored with one
        joint evaluation, and the leading run of frames where every live
        slot's blank extension beats every live emission candidate is
        consumed as pure blank moves; only the first contested frame gets
        the expansion rounds. Without merging every slot is live once the
        beam has filled, and the skip is exact (it then also waits for
        that). With merging it is an approximation in two ways: the exact
        beam would refill dead (merged) slots with emission candidates the
        skip prunes, and during a skipped run a survivor's score is its
        own alignment's blank path only: the same-label mass that merging
        would pool into it from other alignments is left out, so the
        scores are Viterbi-like underestimates.
    Returns (tokens [B, K, max_hyp_len] blank-padded, lengths [B, K],
    log_probs [B, K]), best first along K.
    """
    bsz, t_max, _ = encoder_out.shape
    k, v, blank = beam_size, cfg.vocab_size, cfg.blank_id
    lp_layers, hd = cfg.predictor_num_layers, cfg.predictor_hidden_size
    dev = encoder_out.device
    lens = encoder_out_lens.to(device=dev, dtype=torch.int32)
    jp = p["joint"]
    enc_proj = layers.dense(jp["enc_ffn"], encoder_out)                    # [B, T, J]
    j_dim = enc_proj.shape[-1]
    pos = torch.arange(max_hyp_len, device=dev)

    # slot 0 is the empty hypothesis, the others dead
    tok0 = torch.full((bsz * k,), blank, dtype=torch.int32, device=dev)
    out0, st1 = predictor.predictor_step(
        p["predictor"], tok0, predictor.init_predictor_state(cfg, bsz * k, dev), cfg)
    init = BeamState(
        tokens=torch.full((bsz, k, max_hyp_len), blank, dtype=torch.int32, device=dev),
        lengths=torch.zeros((bsz, k), dtype=torch.int32, device=dev),
        log_probs=torch.where(torch.arange(k, device=dev)[None, :] == 0, 0.0, NEG_INF)
        .float().expand(bsz, k).contiguous(),
        pred_h=st1.h.reshape(lp_layers, bsz, k, hd),
        pred_c=st1.c.reshape(lp_layers, bsz, k, hd),
        pred_proj=layers.dense(jp["pred_ffn"], out0).reshape(bsz, k, j_dim),
    )

    def joint_logp(enc_t: torch.Tensor, pred_proj: torch.Tensor) -> torch.Tensor:
        """enc_t [..., 1, J] against pred_proj [B, (1,) K, J] -> log-probs [..., K, V]."""
        x = torch.tanh(enc_t + pred_proj)
        return torch.log_softmax(layers.dense(jp["ffn_out"], x).float(), dim=-1)

    def blank_move(done: BeamState, a: BeamState, blank_lp: torch.Tensor) -> BeamState:
        """Freeze a's hypotheses, extended by blank, into the done set."""
        scores, top_idx = top_k(torch.cat([done.log_probs, a.log_probs + blank_lp], dim=1), k)
        new_done = _pick(done, a, scores, top_idx)
        return _merge_duplicate_prefixes(new_done) if merge_prefixes else new_done

    def expand(a: BeamState, logp: torch.Tensor) -> BeamState:
        """The top-K non-blank extensions of a (top-K over K*V)."""
        nb_logp = logp.clone()
        nb_logp[:, :, blank] = NEG_INF
        can_grow = a.lengths < max_hyp_len
        exp_scores = torch.where(can_grow[:, :, None], a.log_probs[:, :, None] + nb_logp,
                                 NEG_INF).reshape(bsz, k * v)
        top_e, idx_e = top_k(exp_scores, k)
        src = torch.div(idx_e, v, rounding_mode="floor")
        new_tok = (idx_e % v).to(torch.int32)
        tokens, lengths = gather_k(a.tokens, src), gather_k(a.lengths, src)
        tokens = torch.where(pos[None, None, :] == lengths[:, :, None], new_tok[:, :, None],
                             tokens)
        h_g, c_g = _gather_state(a.pred_h, src), _gather_state(a.pred_c, src)
        out, st = predictor.predictor_step(
            p["predictor"], new_tok.reshape(-1),
            PredictorState(h=h_g.reshape(lp_layers, bsz * k, hd),
                           c=c_g.reshape(lp_layers, bsz * k, hd)), cfg)
        return BeamState(
            tokens=tokens, lengths=(lengths + 1).clamp(max=max_hyp_len), log_probs=top_e,
            pred_h=st.h.reshape(lp_layers, bsz, k, hd), pred_c=st.c.reshape(lp_layers, bsz, k, hd),
            pred_proj=layers.dense(jp["pred_ffn"], out).reshape(bsz, k, j_dim))

    def process_frame(state: BeamState, enc_t: torch.Tensor, active: torch.Tensor) -> BeamState:
        """One full beam frame: the expansion rounds, a forced blank, merging.
        enc_t [B, J] (rows may sit at different frames); rows where active
        [B, 1] is false keep their state."""
        done = state._replace(log_probs=torch.full((bsz, k), NEG_INF, device=dev))
        a = state
        for _ in range(max_expansions):
            logp = joint_logp(enc_t[:, None, :], a.pred_proj)                  # [B, K, V]
            done = blank_move(done, a, logp[:, :, blank])
            a = expand(a, logp)
        logp = joint_logp(enc_t[:, None, :], a.pred_proj)
        merged = blank_move(done, a, logp[:, :, blank])
        return _select(active, merged, state)

    if blank_skip_window > 0:
        final = _run_blank_skip(init, enc_proj, lens, joint_logp, process_frame, blank,
                                blank_skip_window, require_saturated=not merge_prefixes)
    else:
        final = init
        for t in range(t_max):
            final = process_frame(final, enc_proj[:, t], (t < lens)[:, None])
    order = argsort_desc(final.log_probs, dim=1)
    return (gather_k(final.tokens, order), gather_k(final.lengths, order),
            torch.gather(final.log_probs, 1, order))


beam_search_batch.host_syncs = 0


def _run_blank_skip(init: BeamState, enc_proj: torch.Tensor, lens: torch.Tensor,
                    joint_logp: Callable, process_frame: Callable, blank: int, w: int,
                    require_saturated: bool = False) -> BeamState:
    """The beam loop with blank-run skipping (the live-slot variant).

    Rows advance independently: each iteration scores a w-frame window with
    one joint evaluation (pred_proj is constant over a blank run, so the
    window's log-probs are exact), consumes the leading skippable run as
    pure blank moves, then runs the full frame on the first contested
    frame only. A frame is skippable for a row when the least live slot's
    blank extension beats the best live emission candidate; with
    ``require_saturated`` (no merging) every slot must also be live, and
    then the skip is exact.
    """
    bsz, t_max, j_dim = enc_proj.shape
    dev = enc_proj.device
    offs_w = torch.arange(w, device=dev)
    state = init
    row_t = torch.zeros(bsz, dtype=torch.int32, device=dev)
    while True:
        beam_search_batch.host_syncs += 1
        if not bool((row_t < lens).any()):
            break
        offs = row_t[:, None] + offs_w[None, :]                                 # [B, w]
        idx = offs.clamp(max=t_max - 1).long()
        enc_win = torch.gather(enc_proj, 1, idx[:, :, None].expand(bsz, w, j_dim))
        logp_win = joint_logp(enc_win[:, :, None, :], state.pred_proj[:, None])  # [B,w,K,V]
        blank_win = logp_win[..., blank]                                         # [B, w, K]
        nb = logp_win.clone()
        nb[..., blank] = NEG_INF
        maxnb_win = nb.max(dim=-1).values
        valid_f = offs < lens[:, None]

        lp = state.log_probs
        skipping = torch.ones(bsz, dtype=torch.bool, device=dev)
        n_skip = torch.zeros(bsz, dtype=torch.int32, device=dev)
        for f in range(w):
            live = lp > NEG_INF * 0.5
            b_ext = torch.where(live, lp + blank_win[:, f], torch.inf)
            e_cand = torch.where(live, lp + maxnb_win[:, f], -torch.inf)
            ok = (b_ext.min(dim=1).values > e_cand.max(dim=1).values) & valid_f[:, f] & skipping
            if require_saturated:
                ok = ok & live.all(dim=1)
            lp = torch.where(ok[:, None] & live, lp + blank_win[:, f], lp)
            skipping = ok
            n_skip = n_skip + ok.to(torch.int32)
        state = state._replace(log_probs=lp)

        # the full frame for each row's first contested frame (rows that
        # skipped the whole window, or are finished, sit it out)
        t_proc = row_t + n_skip
        process = (t_proc < lens) & (n_skip < w)
        enc_t = torch.gather(enc_proj, 1, t_proc.clamp(max=t_max - 1).long()[:, None, None]
                             .expand(bsz, 1, j_dim))[:, 0]
        state = process_frame(state, enc_t, process[:, None])
        # processed rows pass the contested frame; finished rows advance too
        row_t = t_proc + (process | (n_skip == 0)).to(torch.int32)
    return state
