"""Pruned RNN-T loss (k2 "fast_rnnt" style), PyTorch (JAX
``ops/rnnt_pruned.py``).

Two passes:
 1. the "simple" joint logits(t,u,v) = am(t,v) + lm(u,v): an auxiliary
    loss, and per-cell occupancies (the negated gradient of its detached
    NLL with respect to lp_blank) from which a monotone band s_begin[t] of
    width s_range is built;
 2. the full joint evaluated only on the band, [B, T, s_range, J] x [J, V],
    chunked over T and recomputed in the backward, then the lattice DP in
    band coordinates.

The simple pass and both lattice DPs go through the CUDA kernels
(``ops/simple_lattice.py``, ``ops/rnnt_lattice.py``) when asked; the band
joint and the band DP are plain PyTorch, as they are XLA code in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .rnnt import NEG_INF, _lattice_nll, joint_log_probs_chunk


def _simple_chunk(am_c, lm, lab, blank: int):
    logits = am_c[:, :, None, :].float() + lm[:, None, :, :].float()
    denom = torch.logsumexp(logits, dim=-1)
    b, tc, u1, _ = logits.shape
    emit = logits.gather(3, lab[:, None, :, None].expand(b, tc, u1, 1))[..., 0]
    return logits[..., blank] - denom, emit - denom


def simple_lattice_log_probs(am, lm, labels, blank: int = 0, t_chunk: int = 64):
    """(lp_blank, lp_emit) [B,T,U+1] of the simple joint am [B,T,V] +
    lm [B,U+1,V], chunked over T, each chunk recomputed in the backward."""
    lab = F.pad(labels, (0, 1), value=blank).long()
    outs = [checkpoint(_simple_chunk, am[:, t0:t0 + t_chunk], lm, lab, blank,
                       use_reentrant=False)
            for t0 in range(0, am.shape[1], t_chunk)]
    return torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs], dim=1)


def prune_bounds_from_occupancy(occupancy, t_lengths, u_lengths, s_range: int):
    """Monotone band starts s_begin [B, T] (int64) from occupancies
    [B, T, U+1]: 0 <= s_begin[t] <= U+1-s_range, non-decreasing by less
    than s_range per step, s_begin[0] = 0, and the terminal cell
    (t_len-1, u_len) inside the band and reachable."""
    bsz, t_max, u1 = occupancy.shape
    dev = occupancy.device
    hi = max(u1 - s_range, 0)
    max_step = max(s_range - 1, 1)
    t_lengths, u_lengths = t_lengths.long(), u_lengths.long()
    s_begin = (occupancy.argmax(dim=2) - s_range // 2).clamp(0, hi)
    term_lo = (u_lengths - s_range + 1).clamp_min(0)[:, None]
    t_idx = torch.arange(t_max, device=dev)[None, :]
    at_term = t_idx == (t_lengths - 1)[:, None]
    s_begin = torch.where(at_term, torch.maximum(s_begin, term_lo).clamp_max(hi), s_begin)
    s_begin[:, 0] = 0
    # forward: s[t] = clip(raw[t], s[t-1], s[t-1] + max_step)
    prev = torch.zeros(bsz, dtype=torch.long, device=dev)
    cols = []
    for t in range(t_max):
        prev = torch.clamp(s_begin[:, t], prev, prev + max_step)
        cols.append(prev)
    s_begin = torch.stack(cols, dim=1).clamp_max(hi)
    # backward: the terminal band contains u_len, and walking back from it
    # each earlier band lags by at most max_step: for t < t_len,
    # s[t] = max(s1[t], s[t+1] - max_step) = max over t <= t' < t_len of
    # s1[t'] - (t' - t) * max_step, i.e. a reversed running max of
    # s1[t] - t*max_step, plus t*max_step
    s1 = torch.where(at_term, torch.maximum(s_begin, term_lo).clamp_max(hi), s_begin)
    live = t_idx < t_lengths[:, None]
    y = torch.where(live, s1 - t_idx * max_step, torch.full_like(s1, -(1 << 40)))
    run = torch.flip(torch.cummax(torch.flip(y, [1]), dim=1).values, [1]) + t_idx * max_step
    s_begin = torch.where(live, torch.maximum(s1, run), s1)
    s_begin[:, 0] = 0
    return s_begin


def _gather_band(x, s_begin, s_range: int):
    """x [B, U1, ...] gathered to [B, T, S, ...] with u = s_begin[t] + s."""
    bsz, u1 = x.shape[0], x.shape[1]
    t_max = s_begin.shape[1]
    idx = (s_begin[:, :, None] + torch.arange(s_range, device=x.device)).clamp(0, u1 - 1)
    flat = x.reshape(bsz, u1, -1)
    g = flat.gather(1, idx.reshape(bsz, -1, 1).expand(-1, -1, flat.shape[2]))
    return g.reshape(bsz, t_max, s_range, *x.shape[2:])


def _band_scan(base, weights):
    """x[s] = logaddexp(base[s], x[s-1] + weights[s]) over the band's S
    positions, one step per position (S is small)."""
    cols = [base[:, 0]]
    for s in range(1, base.shape[1]):
        cols.append(torch.logaddexp(base[:, s], cols[-1] + weights[:, s]))
    return torch.stack(cols, dim=1)


def rnnt_loss_pruned(
    enc_proj, pred_proj, w_out, b_out, labels, s_begin, t_lengths, u_lengths,
    s_range: int, blank: int = 0, reduction: str = "none", t_chunk: int = 128,
    model_shard=None,
):
    """Transducer NLL over the pruned band: enc_proj [B,T,J], pred_proj
    [B,U+1,J], labels [B,U], s_begin [B,T] (``prune_bounds_from_occupancy``).
    ``model_shard``: w_out and b_out hold this rank's vocabulary columns;
    the band's picks come from the vocabulary-parallel log-softmax
    (``ops/rnnt.joint_log_probs_chunk``), the same on every rank."""
    bsz, t_max, _ = enc_proj.shape
    lab = F.pad(labels, (0, 1), value=blank)
    if model_shard is not None:
        enc_proj, pred_proj = model_shard.copy_in(enc_proj), model_shard.copy_in(pred_proj)
    pred_band = _gather_band(pred_proj, s_begin, s_range)              # [B,T,S,J]
    lab_band = _gather_band(lab[:, :, None], s_begin, s_range)[..., 0]  # [B,T,S]
    lpb, lpe = [], []
    for t0 in range(0, t_max, t_chunk):
        sl = slice(t0, t0 + t_chunk)
        b_c, e_c = checkpoint(joint_log_probs_chunk, enc_proj[:, sl], pred_band[:, sl], w_out,
                              b_out, lab_band[:, sl], blank, model_shard, use_reentrant=False)
        lpb.append(b_c)
        lpe.append(e_c)
    lp_blank, lp_emit = torch.cat(lpb, dim=1), torch.cat(lpe, dim=1)
    s_pos = torch.arange(s_range, device=enc_proj.device)
    u_idx = s_begin[:, :, None] + s_pos
    lp_emit = torch.where(u_idx <= u_lengths[:, None, None] - 1, lp_emit, NEG_INF)

    # ---- band-coordinate DP; alpha freezes at t >= t_len, so the final
    # alpha is the one at t_len - 1
    emit_in = F.pad(lp_emit, (1, 0), value=NEG_INF)[:, :, :s_range]
    base0 = torch.full((bsz, s_range), NEG_INF, device=enc_proj.device)
    base0[:, 0] = 0.0
    alpha = _band_scan(base0, emit_in[:, 0])
    shift = (s_pos + (s_begin[:, 1:] - s_begin[:, :-1])[..., None])    # [B,T-1,S]
    in_band = shift < s_range
    shift = shift.clamp_max(s_range - 1)
    blank_in = lp_blank[:, :-1].gather(2, shift)
    for t in range(1, t_max):
        base = torch.where(in_band[:, t - 1], alpha.gather(1, shift[:, t - 1]) + blank_in[:, t - 1],
                           NEG_INF)
        new_alpha = _band_scan(base, emit_in[:, t]).clamp_min(NEG_INF)
        alpha = torch.where((t < t_lengths)[:, None], new_alpha, alpha)
    last = (t_lengths.long() - 1)[:, None]
    s_fin = (u_lengths.long()[:, None] - s_begin.gather(1, last)).clamp(0, s_range - 1)
    b_fin = lp_blank.gather(1, last[:, :, None].expand(-1, -1, s_range))[:, 0].gather(1, s_fin)
    nll = -(alpha.gather(1, s_fin) + b_fin)[:, 0]
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def rnnt_loss_pruned_full(
    am, lm, enc_proj, pred_proj, w_out, b_out, labels, t_lengths, u_lengths,
    s_range: int = 5, blank: int = 0, lattice_impl: str = "plain",
    simple_impl: str = "plain", t_chunk: int = 128, model_shard=None,
):
    """(simple_nll [B], pruned_nll [B]), the two-pass recipe, and the band
    starts s_begin [B, T]. am/lm are the V-wide simple projections,
    enc_proj/pred_proj the J-wide joint projections. The occupancy is the
    negated gradient of the simple NLL of DETACHED log-probs with respect
    to lp_blank; the bounds take no gradient. ``simple_impl`` and
    ``lattice_impl`` are "kernel" or "plain". ``model_shard``: the band
    joint runs vocabulary-parallel (``rnnt_loss_pruned``); am and lm are
    replicated, so the simple pass runs whole on every rank."""
    if simple_impl == "kernel":
        from .simple_lattice import simple_lattice_log_probs_fused

        lp_blank_s, lp_emit_s = simple_lattice_log_probs_fused(am.float(), lm.float(), labels,
                                                               blank)
    else:
        lp_blank_s, lp_emit_s = simple_lattice_log_probs(am, lm, labels, blank)
    with torch.enable_grad():
        lpb_ng = lp_blank_s.detach().requires_grad_(True)
        occ_nll = _lattice_nll(lpb_ng, lp_emit_s.detach(), t_lengths, u_lengths, lattice_impl)
        (occ_grad,) = torch.autograd.grad(occ_nll.sum(), lpb_ng)
    simple_nll = _lattice_nll(lp_blank_s, lp_emit_s, t_lengths, u_lengths, lattice_impl)
    s_begin = prune_bounds_from_occupancy(-occ_grad, t_lengths, u_lengths, s_range)
    pruned_nll = rnnt_loss_pruned(
        enc_proj, pred_proj, w_out, b_out, labels, s_begin, t_lengths, u_lengths, s_range,
        blank, t_chunk=t_chunk, model_shard=model_shard,
    )
    return simple_nll, pruned_nll, s_begin
