"""CTC DP over extended labels: CUDA kernels, forward and backward, and their
plain versions.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/ctc_kernel.py``
(``_forward`` / ``_fwd_kernel``, ``_backward`` / ``_bwd_kernel``, wrapped
by ``ctc_loss_pallas``). The kernels are ``csrc/ctc_dp.cu``; its source
note gives the semantics, the bound and the design: the chain kernels up
to ``CHAIN_MAX_STATES`` states, the block path above (``route``).
``ctc_dp_fwd`` and ``ctc_dp_bwd`` launch them for CUDA tensors and take
``ctc_dp_plain_fwd``/``ctc_dp_plain_bwd`` only for CPU tensors; each counts
its launches in ``.launches``.

As in JAX, the [B,T,V] -> [B,T,S] selection of the extended labels'
emissions stays outside the kernel (``ctc_loss_dp``): a ``torch.gather``,
whose backward scatter-adds into [B,T,V] (the JAX kernel's one-hot matmul
at HIGHEST precision is the same exact gather).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .ctc import NEG_INF, _extended_labels, ext_emissions, skip_allowed


# the largest S the chain kernels take: 32 lanes x 4 warps x 4 states a
# lane (csrc/ctc_dp.cu CHAIN_WARPS, CHAIN_MAX_C)
CHAIN_MAX_STATES = 512


def route(s: int) -> str:
    """Which kernels run at S states, as the C entries choose: "chain" or
    "block"."""
    return "chain" if s <= CHAIN_MAX_STATES else "block"


def max_states() -> int:
    """The largest S the kernels take: the block path keeps two rows of S
    float32 in shared memory (csrc/ctc_dp.cu); JAX's kernel has no cap."""
    return cuda_build.SMEM_LIMIT // (2 * 4)


def ctc_dp_plain_fwd(emit, skip, t_lens, u_lens):
    """emit [B,T,S], skip [B,S] float32 (0 allowed / -1e30), lengths [B]
    -> (nll [B], alpha [B,T,S]) with the kernel's semantics."""
    bsz, t_max, s_max = emit.shape
    s_idx = torch.arange(s_max, device=emit.device)
    init = (s_idx[None, :] < 2) & ~((s_idx[None, :] == 1) & (u_lens[:, None] == 0))
    alpha = torch.where(init, emit[:, 0], NEG_INF)
    alphas = [alpha]
    for t in range(1, t_max):
        f1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :s_max]
        f2 = F.pad(alpha, (2, 0), value=NEG_INF)[:, :s_max] + skip
        upd = (torch.logaddexp(torch.logaddexp(alpha, f1), f2) + emit[:, t]).clamp_min(NEG_INF)
        alpha = torch.where((t < t_lens)[:, None], upd, alpha)
        alphas.append(alpha)
    s_last = (2 * u_lens).long()
    fb = alpha.gather(1, s_last[:, None])[:, 0]
    fl = alpha.gather(1, (s_last - 1).clamp_min(0)[:, None])[:, 0]
    fl = torch.where(u_lens > 0, fl, NEG_INF)
    return -torch.logaddexp(fb, fl), torch.stack(alphas, dim=1)


def ctc_dp_plain_bwd(emit, skip, alpha, t_lens, u_lens, nll, g):
    """The explicit beta pass: d(sum g*nll)/d emit [B,T,S], zero at t >= len.

    Each frame's state occupancies exp(alpha + beta - logZ) are divided by
    their sum, which is 1 in exact arithmetic (every path passes one state
    per frame t < len). In float32, with |logZ| in the thousands, the
    unnormalised occupancies carry a common error of ~1e-3 per frame; the
    normalised ones are as exact as autograd through the forward."""
    bsz, t_max, s_max = emit.shape
    s_idx = torch.arange(s_max, device=emit.device)[None, :]
    s_last = (2 * u_lens)[:, None]
    term = torch.where((s_idx == s_last) | ((s_idx == s_last - 1) & (u_lens[:, None] > 0)),
                       0.0, NEG_INF)
    logz = -nll[:, None]
    skip2 = F.pad(skip[:, 2:], (0, 2), value=NEG_INF)
    beta = torch.full((bsz, s_max), NEG_INF, device=emit.device)
    occ = torch.zeros_like(emit)
    for t in range(t_max - 1, -1, -1):
        bh = torch.where((t >= t_lens - 1)[:, None], term, beta)
        live = (t < t_lens)[:, None]
        occ[:, t] = torch.where(live, torch.exp(alpha[:, t] + bh - logz), 0.0)
        v = emit[:, t] + bh
        n1 = F.pad(v[:, 1:], (0, 1), value=NEG_INF)
        n2 = F.pad(v[:, 2:], (0, 2), value=NEG_INF) + skip2
        beta = torch.logaddexp(torch.logaddexp(v, n1), n2).clamp_min(NEG_INF)
    total = occ.sum(2, keepdim=True)
    return torch.where(total > 0, occ * (-g.view(-1, 1, 1) / total), 0.0)


def _check(name, tensors, lens):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in (*tensors, *lens)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors) or any(t.dtype != torch.int32 for t in lens):
        raise TypeError(f"{name}: float32 tensors and int32 lengths expected")
    if not all(t.is_contiguous() for t in (*tensors, *lens)):
        raise ValueError(f"{name}: inputs must be contiguous")


def _check_shape(name, emit):
    b, t, s = emit.shape
    if min(b, t, s) == 0:
        raise ValueError(f"{name}: empty shape {tuple(emit.shape)}")
    if s > max_states():
        raise ValueError(f"{name}: S = {s} extended labels need {8 * s} B of shared memory, "
                         f"more than a block has ({cuda_build.SMEM_LIMIT} B); at most "
                         f"{max_states()}")


def ctc_dp_fwd(emit, skip, t_lens, u_lens):
    """Kernel wrapper with the contract of ``ctc_dp_plain_fwd``: CPU
    tensors take the plain version, CUDA tensors launch the kernel or
    raise (float32 contiguous, int32 lengths, S <= ``max_states()``)."""
    if emit.device.type == "cpu":
        return ctc_dp_plain_fwd(emit, skip, t_lens, u_lens)
    _check("ctc_dp_fwd", (emit, skip), (t_lens, u_lens))
    b, t, s = emit.shape
    if skip.shape != (b, s) or t_lens.shape != (b,) or u_lens.shape != (b,):
        raise ValueError("ctc_dp_fwd: inconsistent shapes")
    _check_shape("ctc_dp_fwd", emit)
    nll = torch.empty((b,), dtype=torch.float32, device=emit.device)
    alpha = torch.empty_like(emit)
    fn = cuda_build.load_function("ctc_dp", "ctc_dp_fwd", n_ptrs=7, n_ints=3)
    P = cuda_build.ptr
    err = fn(P(emit), P(skip), P(t_lens), P(u_lens), P(nll), P(alpha),
             cuda_build.stream_ptr(emit), b, t, s)
    cuda_build.check(err, "ctc_dp_fwd")
    ctc_dp_fwd.launches += 1
    return nll, alpha


def ctc_dp_bwd(emit, skip, alpha, t_lens, u_lens, nll, g):
    """Kernel wrapper with the contract of ``ctc_dp_plain_bwd``."""
    if emit.device.type == "cpu":
        return ctc_dp_plain_bwd(emit, skip, alpha, t_lens, u_lens, nll, g)
    _check("ctc_dp_bwd", (emit, skip, alpha, nll, g), (t_lens, u_lens))
    b, t, s = emit.shape
    if alpha.shape != emit.shape or nll.shape != (b,) or g.shape != (b,):
        raise ValueError("ctc_dp_bwd: inconsistent shapes")
    _check_shape("ctc_dp_bwd", emit)
    g_emit = torch.empty_like(emit)
    fn = cuda_build.load_function("ctc_dp", "ctc_dp_bwd", n_ptrs=9, n_ints=3)
    P = cuda_build.ptr
    err = fn(P(emit), P(skip), P(alpha), P(t_lens), P(u_lens), P(nll), P(g), P(g_emit),
             cuda_build.stream_ptr(emit), b, t, s)
    cuda_build.check(err, "ctc_dp_bwd")
    ctc_dp_bwd.launches += 1
    return g_emit


ctc_dp_fwd.launches = 0
ctc_dp_bwd.launches = 0


class _CtcDp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emit, skip, t_lens, u_lens):
        nll, alpha = ctc_dp_fwd(emit, skip, t_lens, u_lens)
        ctx.save_for_backward(emit, skip, alpha, t_lens, u_lens, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        emit, skip, alpha, t_lens, u_lens, nll = ctx.saved_tensors
        g_emit = ctc_dp_bwd(emit, skip, alpha, t_lens, u_lens, nll, g.float().contiguous())
        return g_emit, None, None, None


def ctc_loss_dp(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """Per-sequence CTC NLL [B] through the DP kernel, with the contract of
    ``ops.ctc.ctc_loss`` (the JAX ``ctc_loss_pallas``)."""
    ext = _extended_labels(labels.long(), blank)
    return ctc_loss_dp_emit(ext_emissions(log_probs.float(), ext), input_lengths, labels,
                            label_lengths, blank)


def ctc_loss_dp_emit(
    emit: torch.Tensor,
    input_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """``ctc_loss_dp`` from the extended labels' emissions emit [B, T,
    2U+1] float32, as ``ops.ctc.ctc_loss_emit``."""
    ext = _extended_labels(labels.long(), blank)
    skip = torch.where(skip_allowed(ext, blank), 0.0, NEG_INF).float().contiguous()
    return _CtcDp.apply(emit.float().contiguous(), skip,
                        input_lengths.to(torch.int32).contiguous(),
                        label_lengths.to(torch.int32).contiguous())
