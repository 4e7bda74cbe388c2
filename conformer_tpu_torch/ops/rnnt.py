"""Transducer (RNN-T) loss, plain PyTorch (JAX ``ops/rnnt.py``).

- ``rnnt_loss_from_log_probs``: the lattice DP as a loop over T with an
  [B, U+1] alpha row; the in-row recurrence is a first-order linear
  recurrence in the (logaddexp, +) semiring, solved by a log-depth scan
  (``_semiring_linear_scan``). Rows freeze at t >= t_len. It is the oracle
  of the DP kernel (``ops/rnnt_lattice.py``) and the path taken when
  ``use_pallas_rnnt`` is off.
- ``gather_lattice_log_probs``: (lp_blank, lp_emit) from joint logits.
- ``rnnt_lattice_log_probs_fused``: the full-lattice joint chunked over T
  and recomputed in the backward (``torch.utils.checkpoint``, as
  ``jax.checkpoint`` there), so [B, T, U+1, V] never exists at once.
- ``rnnt_loss_fused``: joint + DP, the transducer loss of the full lattice;
  ``joint_impl="kernel"`` takes the fused joint kernels
  (``ops/joint_lattice.py``, JAX's ``joint_impl="pallas"``) in place of
  the chunked joint.
- ``rnnt_loss``: the loss from whole joint logits [B, T, U+1, V].

Under a model axis (``model_shard``, ``parallel/tensor.py``) ``ffn_out``
holds this rank's vocabulary columns: the chunked joints take the blank
and label log-probs through the vocabulary-parallel log-softmax, the same
on every rank, so the DPs run whole on each; the joint kernels take the
whole W, gathered over "model", as GSPMD hands its custom call.

``lattice_impl="kernel"`` is JAX's ``"pallas"``: the DP kernel on CUDA
tensors, its plain version on CPU tensors; ``"plain"`` (JAX's ``"xla"``)
is the plain scan everywhere.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .joint_lattice import joint_lattice_log_probs

NEG_INF = -1e30


def _semiring_linear_scan(base: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Solve x[u] = logaddexp(base[u], x[u-1] + weights[u]) along the last
    axis (weights[..., 0] is ignored), by a Hillis-Steele scan over the
    composed maps f_u(x) = base_u (+) (weights_u (*) x)."""
    a = base
    w = torch.cat([torch.full_like(weights[..., :1], NEG_INF), weights[..., 1:]], dim=-1)
    n = a.shape[-1]
    k = 1
    while k < n:
        a_prev = F.pad(a[..., :-k], (k, 0), value=NEG_INF)
        w_prev = F.pad(w[..., :-k], (k, 0), value=0.0)
        a = torch.where(torch.arange(n, device=a.device) >= k,
                        torch.logaddexp(a, w + a_prev), a)
        w = w + w_prev
        k *= 2
    return a


def rnnt_loss_from_log_probs(
    lp_blank: torch.Tensor,
    lp_emit: torch.Tensor,
    t_lengths: torch.Tensor,
    u_lengths: torch.Tensor,
) -> torch.Tensor:
    """Transducer NLL [B] (float32) from lattice log-probs [B, T, U+1];
    lp_emit[..., u] is log p(label_{u+1} | t, u) (column U unused)."""
    lp_blank = lp_blank.float()
    lp_emit = lp_emit.float()
    bsz, t_max, u1 = lp_blank.shape
    u_idx = u_lengths.long()[:, None]
    emit_in = F.pad(lp_emit, (1, 0), value=NEG_INF)[:, :, :u1]

    base0 = torch.full((bsz, u1), NEG_INF, device=lp_blank.device)
    base0[:, 0] = 0.0
    alpha = _semiring_linear_scan(base0, emit_in[:, 0])
    final = torch.where(
        t_lengths == 1,
        alpha.gather(1, u_idx)[:, 0] + lp_blank[:, 0].gather(1, u_idx)[:, 0],
        NEG_INF,
    )
    for t in range(1, t_max):
        new_alpha = _semiring_linear_scan(alpha + lp_blank[:, t - 1], emit_in[:, t])
        alpha = torch.where((t < t_lengths)[:, None], new_alpha.clamp_min(NEG_INF), alpha)
        a_u = alpha.gather(1, u_idx)[:, 0]
        b_u = lp_blank[:, t].gather(1, u_idx)[:, 0]
        final = torch.where(t == t_lengths - 1, a_u + b_u, final)
    return -final


def gather_lattice_log_probs(logits: torch.Tensor, labels: torch.Tensor, blank: int):
    """Joint logits [B, T, U+1, V] and labels [B, U] -> (lp_blank, lp_emit)
    [B, T, U+1] float32; row U gathers blank."""
    logits = logits.float()
    denom = torch.logsumexp(logits, dim=-1)
    bsz, t_max, u1, _ = logits.shape
    lab = F.pad(labels, (0, 1), value=blank).long()
    emit = logits.gather(3, lab[:, None, :, None].expand(bsz, t_max, u1, 1))[..., 0]
    return logits[..., blank] - denom, emit - denom


def joint_log_probs_chunk(enc_c, pred, w_out, b_out, lab, blank: int, model_shard=None):
    """(lp_blank, lp_emit) of one chunk of the joint: enc_c [B,tc,J] against
    pred [B,(tc,)U1,J] (broadcast over t, or one row per t as in the band
    joint), logits = tanh(enc+pred) W + b. x and W take the activation
    dtype, the product's sums float32 (JAX's preferred_element_type: the
    operands are widened, and a product of two bf16 values is exact in
    float32), and the logsumexp and the picks are float32. ``lab`` is the
    label index per (b, t, u) or per (b, u). ``model_shard``: w_out and
    b_out hold this rank's vocabulary columns, enc_c and pred come through
    its ``copy_in``, and the picks are ``ModelShard.log_probs``."""
    pred = pred if pred.dim() == 4 else pred[:, None]
    x = torch.tanh(enc_c[:, :, None, :] + pred)
    logits = torch.matmul(x.float(), w_out.to(x.dtype).float()) + b_out.float()
    lab = lab if lab.dim() == 3 else lab[:, None, :].expand(logits.shape[:3])
    if model_shard is not None:
        lp = model_shard.log_probs(logits, torch.stack([torch.full_like(lab, blank), lab], -1))
        return lp[..., 0], lp[..., 1]
    denom = torch.logsumexp(logits, dim=-1)
    emit = logits.gather(3, lab[..., None].long())[..., 0]
    return logits[..., blank] - denom, emit - denom


def rnnt_lattice_log_probs_fused(
    enc_proj: torch.Tensor,
    pred_proj: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    labels: torch.Tensor,
    blank: int = 0,
    t_chunk: int = 32,
    model_shard=None,
):
    """(lp_blank, lp_emit) [B, T, U+1] of the full-lattice joint, chunk by
    chunk over T, each chunk recomputed in the backward: peak memory is
    O(B * t_chunk * (U+1) * V) (V/m under a model axis)."""
    lab = F.pad(labels, (0, 1), value=blank)
    if model_shard is not None:
        enc_proj, pred_proj = model_shard.copy_in(enc_proj), model_shard.copy_in(pred_proj)
    lpb, lpe = [], []
    for t0 in range(0, enc_proj.shape[1], t_chunk):
        b_c, e_c = checkpoint(joint_log_probs_chunk, enc_proj[:, t0:t0 + t_chunk], pred_proj,
                              w_out, b_out, lab, blank, model_shard, use_reentrant=False)
        lpb.append(b_c)
        lpe.append(e_c)
    return torch.cat(lpb, dim=1), torch.cat(lpe, dim=1)


def _reduce(nll: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def _lattice_nll(lp_blank, lp_emit, t_lengths, u_lengths, lattice_impl: str):
    """NLL [B] through the DP kernel (``lattice_impl="kernel"``) or the
    plain scan (``"plain"``)."""
    if lattice_impl == "kernel":
        from .rnnt_lattice import rnnt_lattice_nll

        return rnnt_lattice_nll(lp_blank, lp_emit, t_lengths, u_lengths)
    return rnnt_loss_from_log_probs(lp_blank, lp_emit, t_lengths, u_lengths)


def rnnt_loss_fused(
    enc_proj: torch.Tensor,
    pred_proj: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    labels: torch.Tensor,
    t_lengths: torch.Tensor,
    u_lengths: torch.Tensor,
    blank: int = 0,
    reduction: str = "mean",
    t_chunk: int = 32,
    lattice_impl: str = "plain",
    joint_impl: str = "plain",
    model_shard=None,
) -> torch.Tensor:
    """Transducer loss of the full lattice from the joint projections; the
    joint through the fused kernels (``joint_impl="kernel"``) or the
    chunked plain joint (``"plain"``). ``model_shard``: w_out and b_out
    hold this rank's vocabulary columns; the kernels get them gathered
    (backward: each rank keeps its columns of the gradient every rank
    computed alike), the plain joint runs vocabulary-parallel."""
    if joint_impl == "kernel":
        lab = F.pad(labels, (0, 1), value=blank)
        if model_shard is not None:
            w_out, b_out = model_shard.gather(w_out, 1), model_shard.gather(b_out, 0)
        lp_blank, lp_emit = joint_lattice_log_probs(enc_proj, pred_proj, w_out, b_out, lab, blank)
    elif joint_impl == "plain":
        lp_blank, lp_emit = rnnt_lattice_log_probs_fused(
            enc_proj, pred_proj, w_out, b_out, labels, blank, t_chunk, model_shard
        )
    else:
        raise ValueError(f"joint_impl {joint_impl!r}: 'kernel' or 'plain'")
    return _reduce(_lattice_nll(lp_blank, lp_emit, t_lengths, u_lengths, lattice_impl),
                   reduction)


def rnnt_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    t_lengths: torch.Tensor,
    u_lengths: torch.Tensor,
    blank: int = 0,
    reduction: str = "mean",
    lattice_impl: str = "plain",
) -> torch.Tensor:
    """Transducer loss from joint logits [B, T, U+1, V] (row u has consumed
    u labels) and labels [B, U], with torchaudio's ``rnnt_loss``
    semantics; ``reduction`` "mean", "sum" or "none"."""
    lp_blank, lp_emit = gather_lattice_log_probs(logits, labels, blank)
    return _reduce(_lattice_nll(lp_blank, lp_emit, t_lengths, u_lengths, lattice_impl),
                   reduction)
