"""Transducer lattice DP: CUDA kernels, forward and backward, and their plain
versions.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/rnnt_kernel.py``
(``_forward`` / ``_fwd_kernel``, ``_backward`` / ``_bwd_kernel``, wrapped by
``rnnt_loss_from_log_probs_pallas``). The kernels are
``csrc/rnnt_lattice.cu``; its source note gives the semantics, the bound
and the design. ``rnnt_lattice_fwd``/``rnnt_lattice_bwd`` launch them for
CUDA tensors and take the plain versions only for CPU tensors; each counts
its launches in ``.launches``.

The plain versions walk the same anti-diagonal wavefront as the kernel
(cells past t_len are computed, not frozen as in the scan oracle
``ops.rnnt.rnnt_loss_from_log_probs``); the NLL and the gradients agree
either way, the saved alpha only on t < t_len.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build

NEG_INF = -1e30


def max_u1(t_max: int) -> int:
    """The largest U+1 both kernels take at ``t_max`` frames: above the
    one-warp kernels' U+1 <= 320 (or where their rings and row sums do not
    fit) the block path runs, whose backward keeps 2(U+1) + T float32 in
    shared memory, its forward 2(U+1) + 1 (csrc/rnnt_lattice.cu); JAX's
    kernel has no cap."""
    return (cuda_build.SMEM_LIMIT // 4 - max(t_max, 1)) // 2


def _check_shape(name, lp, n_extra):
    """Raise unless the lattice [B,T,U+1] is non-empty and the kernel's
    2(U+1) + ``n_extra`` floats of shared memory fit a block."""
    b, t, u1 = lp.shape
    if min(b, t, u1) == 0:
        raise ValueError(f"{name}: empty shape {tuple(lp.shape)}")
    need = 4 * (2 * u1 + n_extra)
    if need > cuda_build.SMEM_LIMIT:
        raise ValueError(f"{name}: U+1 = {u1} at T = {t} needs {need} B of shared memory, "
                         f"more than a block has ({cuda_build.SMEM_LIMIT} B)")


def _diagonal(d: int, t_max: int, u1: int, device):
    """Cells (d-u, u) of diagonal d: (t index clamped, u index, in-lattice)."""
    u = torch.arange(u1, device=device)
    t = d - u
    ok = (t >= 0) & (t < t_max)
    return t.clamp(0, t_max - 1), u, ok


def rnnt_lattice_plain_fwd(lp_blank, lp_emit, t_lens, u_lens):
    """lp_blank, lp_emit [B,T,U+1] float32, lengths [B] -> (nll [B],
    alpha [B,T,U+1])."""
    bsz, t_max, u1 = lp_blank.shape
    dev = lp_blank.device
    alpha_out = torch.full_like(lp_blank, NEG_INF)
    al = torch.full((bsz, u1), NEG_INF, device=dev)
    al[:, 0] = 0.0
    dterm = t_lens + u_lens - 1
    fin = torch.full((bsz,), NEG_INF, device=dev)
    for d in range(t_max + u1 - 1):
        t, u, ok = _diagonal(d, t_max, u1, dev)
        blank = torch.where(ok, lp_blank[:, t, u], NEG_INF)
        emit = torch.where(ok, lp_emit[:, t, u], NEG_INF)
        alpha_out[:, t[ok], u[ok]] = al[:, ok]
        cand = al + blank
        fin = torch.where(dterm == d, cand.gather(1, u_lens.long()[:, None])[:, 0], fin)
        left = F.pad(al + emit, (1, 0), value=NEG_INF)[:, :u1]
        al = torch.logaddexp(cand, left).clamp_min(NEG_INF)
    return -fin, alpha_out


def rnnt_lattice_plain_bwd(lp_blank, lp_emit, alpha, t_lens, u_lens, nll, g):
    """The explicit beta pass: (d(sum g*nll)/d lp_blank, .../d lp_emit).

    The occupancies exp(alpha + lp + beta - logZ) are normalised as the
    lattice guarantees in exact arithmetic: every path takes one blank out
    of each frame t < t_len and emits each label u < u_len once, so each
    such row of the blank occupancies and each such column of the emit
    occupancies sums to 1. In float32, with |logZ| in the thousands, the
    unnormalised occupancies carry a common error of ~1e-3 per row; the
    normalised ones are as exact as autograd through the forward."""
    bsz, t_max, u1 = lp_blank.shape
    dev = lp_blank.device
    logz = -nll[:, None]
    dterm = t_lens + u_lens - 1
    at_ul = torch.arange(u1, device=dev)[None, :] == u_lens[:, None]
    be = torch.full((bsz, u1), NEG_INF, device=dev)
    e_blank = torch.zeros_like(lp_blank)
    e_emit = torch.zeros_like(lp_emit)
    for d in range(t_max + u1 - 2, -1, -1):
        t, u, ok = _diagonal(d, t_max, u1, dev)
        blank = torch.where(ok, lp_blank[:, t, u], NEG_INF)
        emit = torch.where(ok, lp_emit[:, t, u], NEG_INF)
        a = torch.where(ok, alpha[:, t, u], NEG_INF)
        b1 = torch.where((dterm == d)[:, None] & at_ul, 0.0, be)
        b2 = F.pad(be[:, 1:], (0, 1), value=NEG_INF)
        e_blank[:, t[ok], u[ok]] = torch.exp(a + blank + b1 - logz)[:, ok]
        e_emit[:, t[ok], u[ok]] = torch.exp(a + emit + b2 - logz)[:, ok]
        be = torch.logaddexp(blank + b1, emit + b2).clamp_min(NEG_INF)
    return (_normalised(e_blank, 2, t_lens, g), _normalised(e_emit, 1, u_lens, g))


def _normalised(occ, dim, lens, g):
    """-g * occ / (its sum over ``dim``) along the other lattice axis, for
    indices below ``lens`` where the sum is positive; 0 elsewhere."""
    total = occ.sum(dim, keepdim=True)
    idx = torch.arange(occ.shape[3 - dim], device=occ.device).view(
        (1, -1, 1) if dim == 2 else (1, 1, -1))
    keep = (idx < lens.view(-1, 1, 1)) & (total > 0)
    return torch.where(keep, occ * (-g.view(-1, 1, 1) / total), 0.0)


def _check(name, tensors, lens):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in (*tensors, *lens)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors) or any(t.dtype != torch.int32 for t in lens):
        raise TypeError(f"{name}: float32 tensors and int32 lengths expected")
    if not all(t.is_contiguous() for t in (*tensors, *lens)):
        raise ValueError(f"{name}: inputs must be contiguous")


def rnnt_lattice_fwd(lp_blank, lp_emit, t_lens, u_lens):
    """Kernel wrapper with the contract of ``rnnt_lattice_plain_fwd``: CPU
    tensors take the plain version, CUDA tensors launch the kernel or raise
    (float32 contiguous, int32 lengths, U+1 within shared memory: ``max_u1``)."""
    if lp_blank.device.type == "cpu":
        return rnnt_lattice_plain_fwd(lp_blank, lp_emit, t_lens, u_lens)
    _check("rnnt_lattice_fwd", (lp_blank, lp_emit), (t_lens, u_lens))
    b, t, u1 = lp_blank.shape
    if lp_emit.shape != lp_blank.shape or t_lens.shape != (b,) or u_lens.shape != (b,):
        raise ValueError("rnnt_lattice_fwd: inconsistent shapes")
    _check_shape("rnnt_lattice_fwd", lp_blank, 1)
    nll = torch.empty((b,), dtype=torch.float32, device=lp_blank.device)
    alpha = torch.empty_like(lp_blank)
    fn = cuda_build.load_function("rnnt_lattice", "rnnt_lattice_fwd", n_ptrs=7, n_ints=3)
    P = cuda_build.ptr
    err = fn(P(lp_blank), P(lp_emit), P(t_lens), P(u_lens), P(nll), P(alpha),
             cuda_build.stream_ptr(lp_blank), b, t, u1)
    cuda_build.check(err, "rnnt_lattice_fwd")
    rnnt_lattice_fwd.launches += 1
    return nll, alpha


def rnnt_lattice_bwd(lp_blank, lp_emit, alpha, t_lens, u_lens, nll, g):
    """Kernel wrapper with the contract of ``rnnt_lattice_plain_bwd``."""
    if lp_blank.device.type == "cpu":
        return rnnt_lattice_plain_bwd(lp_blank, lp_emit, alpha, t_lens, u_lens, nll, g)
    _check("rnnt_lattice_bwd", (lp_blank, lp_emit, alpha, nll, g), (t_lens, u_lens))
    b, t, u1 = lp_blank.shape
    if alpha.shape != lp_blank.shape or nll.shape != (b,) or g.shape != (b,):
        raise ValueError("rnnt_lattice_bwd: inconsistent shapes")
    _check_shape("rnnt_lattice_bwd", lp_blank, t)
    g_blank = torch.empty_like(lp_blank)
    g_emit = torch.empty_like(lp_blank)
    fn = cuda_build.load_function("rnnt_lattice", "rnnt_lattice_bwd", n_ptrs=10, n_ints=3)
    P = cuda_build.ptr
    err = fn(P(lp_blank), P(lp_emit), P(alpha), P(t_lens), P(u_lens), P(nll), P(g),
             P(g_blank), P(g_emit), cuda_build.stream_ptr(lp_blank), b, t, u1)
    cuda_build.check(err, "rnnt_lattice_bwd")
    rnnt_lattice_bwd.launches += 1
    return g_blank, g_emit


rnnt_lattice_fwd.launches = 0
rnnt_lattice_bwd.launches = 0


class _RnntLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_blank, lp_emit, t_lens, u_lens):
        nll, alpha = rnnt_lattice_fwd(lp_blank, lp_emit, t_lens, u_lens)
        ctx.save_for_backward(lp_blank, lp_emit, alpha, t_lens, u_lens, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        lp_blank, lp_emit, alpha, t_lens, u_lens, nll = ctx.saved_tensors
        g_blank, g_emit = rnnt_lattice_bwd(lp_blank, lp_emit, alpha, t_lens, u_lens, nll,
                                           g.float().contiguous())
        return g_blank, g_emit, None, None


def rnnt_lattice_nll(lp_blank, lp_emit, t_lengths, u_lengths) -> torch.Tensor:
    """Transducer NLL [B] from lattice log-probs through the DP kernels,
    differentiable with respect to both log-prob tensors (the JAX
    ``rnnt_loss_from_log_probs_pallas``)."""
    return _RnntLattice.apply(
        lp_blank.float().contiguous(), lp_emit.float().contiguous(),
        t_lengths.to(torch.int32).contiguous(), u_lengths.to(torch.int32).contiguous(),
    )
