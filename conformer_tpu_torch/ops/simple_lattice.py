"""Simple-lattice scoring of the pruned RNN-T loss: CUDA kernels, forward and
backward, and their plain versions.

Replaces the Pallas TPU kernel
``conformer_tpu/ops/pallas/simple_lattice_kernel.py`` (``_forward`` /
``_fwd_kernel``, ``_backward`` / ``_bwd_kernel``, wrapped by
``simple_lattice_log_probs_pallas``). The kernels are
``csrc/simple_lattice.cu``; its source note gives the math, the bound and
the design. ``simple_lattice_fwd``/``simple_lattice_bwd`` launch them for
CUDA tensors and take the plain versions only for CPU tensors; each counts
its launches in ``.launches``. The plain versions are chunked over T, so
they build [B, t_chunk, U+1, V] at a time and never the whole lattice.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

_U_TILE = 128       # the forward kernel's u rows per block, at most
_MAX_U_TILES = 65535   # the forward's grid: one block row per u tile


def max_u1() -> int:
    """The largest U+1 both kernels take. Neither block's shape nor its
    shared memory depends on U (the forward tiles u by 128 rows, the
    backward runs one grid per chunk of 96), so the limit is the forward
    grid's third dimension, 65535 tiles; JAX's kernel has no cap."""
    return _MAX_U_TILES * _U_TILE


def _picks(am, lm, lab, blank):
    """(blank logit, label logit) [B,T,U+1]; a label outside [0, V) picks 0."""
    b, t, v = am.shape
    u1 = lm.shape[1]
    ok = (lab >= 0) & (lab < v)
    idx = torch.where(ok, lab, 0).long()
    bl = am[:, :, blank][:, :, None] + lm[:, :, blank][:, None, :]
    em = am.gather(2, idx[:, None, :].expand(b, t, u1)) + lm.gather(2, idx[:, :, None])[:, None, :, 0]
    return bl, torch.where(ok[:, None, :], em, 0.0)


def simple_lattice_plain_fwd(am, lm, lab, blank: int, t_chunk: int = 64):
    """am [B,T,V], lm [B,U+1,V] float32, lab [B,U+1] (blank at U) ->
    (lp_blank, lp_emit, logZ) [B,T,U+1] float32."""
    logz = torch.cat([
        torch.logsumexp(am[:, t0:t0 + t_chunk, None, :] + lm[:, None, :, :], dim=-1)
        for t0 in range(0, am.shape[1], t_chunk)
    ], dim=1)
    bl, em = _picks(am, lm, lab, blank)
    return bl - logz, em - logz, logz


def simple_lattice_plain_bwd(am, lm, lab, logz, g_blank, g_emit, blank: int,
                             t_chunk: int = 64):
    """(d am [B,T,V], d lm [B,U+1,V]) of sum(g_blank*lp_blank + g_emit*lp_emit),
    from the saved logZ, chunked over T."""
    b, t, v = am.shape
    u1 = lm.shape[1]
    ok = (lab >= 0) & (lab < v)
    idx = torch.where(ok, lab, 0).long()
    dam = torch.empty_like(am)
    dlm = torch.zeros_like(lm)
    for t0 in range(0, t, t_chunk):
        sl = slice(t0, t0 + t_chunk)
        gb, ge = g_blank[:, sl], g_emit[:, sl]
        p = torch.exp(am[:, sl, None, :] + lm[:, None, :, :] - logz[:, sl, :, None])
        dl = -(gb + ge)[..., None] * p
        dl[..., blank] += gb
        tc = gb.shape[1]
        dl.scatter_add_(3, idx[:, None, :, None].expand(b, tc, u1, 1),
                        torch.where(ok[:, None, :], ge, 0.0)[..., None])
        dam[:, sl] = dl.sum(dim=2)
        dlm += dl.sum(dim=1)
    return dam, dlm


def _check(name, tensors, lab):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in (*tensors, lab)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors) or lab.dtype != torch.int32:
        raise TypeError(f"{name}: float32 tensors and int32 labels expected")
    if not all(t.is_contiguous() for t in (*tensors, lab)):
        raise ValueError(f"{name}: inputs must be contiguous")


def _shape(name, am, lm, lab, blank):
    b, t, v = am.shape
    u1 = lm.shape[1]
    if lm.shape != (b, u1, v) or lab.shape != (b, u1):
        raise ValueError(f"{name}: inconsistent shapes")
    if u1 > max_u1() or min(b, t, u1, v) == 0 or not 0 <= blank < v:
        raise ValueError(f"{name}: am {tuple(am.shape)}, lm {tuple(lm.shape)} outside the kernel")
    return b, t, u1, v


def simple_lattice_fwd(am, lm, lab, blank: int):
    """Kernel wrapper with the contract of ``simple_lattice_plain_fwd``: CPU
    tensors take the plain version, CUDA tensors launch the kernel or raise
    (float32 contiguous, int32 labels, U+1 <= ``max_u1()``)."""
    if am.device.type == "cpu":
        return simple_lattice_plain_fwd(am, lm, lab, blank)
    _check("simple_lattice_fwd", (am, lm), lab)
    b, t, u1, v = _shape("simple_lattice_fwd", am, lm, lab, blank)
    lpb, lpe, logz = (torch.empty((b, t, u1), dtype=torch.float32, device=am.device)
                      for _ in range(3))
    fn = cuda_build.load_function("simple_lattice", "simple_lattice_fwd", n_ptrs=7, n_ints=5)
    P = cuda_build.ptr
    err = fn(P(am), P(lm), P(lab), P(lpb), P(lpe), P(logz), cuda_build.stream_ptr(am),
             b, t, u1, v, blank)
    cuda_build.check(err, "simple_lattice_fwd")
    simple_lattice_fwd.launches += 1
    return lpb, lpe, logz


def simple_lattice_bwd(am, lm, lab, logz, g_blank, g_emit, blank: int):
    """Kernel wrapper with the contract of ``simple_lattice_plain_bwd``; the
    sums into d lm and d am are taken in a fixed order (no atomics). Above
    U+1 = 96 the kernel runs as one grid per chunk of u; ``.launches``
    counts the grids, as the C entry reports them."""
    if am.device.type == "cpu":
        return simple_lattice_plain_bwd(am, lm, lab, logz, g_blank, g_emit, blank)
    _check("simple_lattice_bwd", (am, lm, logz, g_blank, g_emit), lab)
    b, t, u1, v = _shape("simple_lattice_bwd", am, lm, lab, blank)
    if any(x.shape != (b, t, u1) for x in (logz, g_blank, g_emit)):
        raise ValueError("simple_lattice_bwd: inconsistent shapes")
    dam = torch.empty_like(am)
    dlm = torch.empty_like(lm)
    fn = cuda_build.load_function("simple_lattice", "simple_lattice_bwd", n_ptrs=10, n_ints=5)
    P = cuda_build.ptr
    grids = ctypes.c_int(0)
    err = fn(P(am), P(lm), P(lab), P(logz), P(g_blank), P(g_emit), P(dam), P(dlm),
             ctypes.addressof(grids), cuda_build.stream_ptr(am), b, t, u1, v, blank)
    simple_lattice_bwd.launches += grids.value
    cuda_build.check(err, "simple_lattice_bwd")
    return dam, dlm


simple_lattice_fwd.launches = 0
simple_lattice_bwd.launches = 0


class _SimpleLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, am, lm, lab, blank):
        lpb, lpe, logz = simple_lattice_fwd(am, lm, lab, blank)
        ctx.save_for_backward(am, lm, lab, logz)
        ctx.blank = blank
        return lpb, lpe

    @staticmethod
    def backward(ctx, g_blank, g_emit):
        am, lm, lab, logz = ctx.saved_tensors
        dam, dlm = simple_lattice_bwd(am, lm, lab, logz, g_blank.float().contiguous(),
                                      g_emit.float().contiguous(), ctx.blank)
        return dam, dlm, None, None


def simple_lattice_log_probs_fused(am, lm, labels, blank: int = 0):
    """(lp_blank, lp_emit) [B,T,U+1] of the simple joint am[t]+lm[u] through
    the kernels, differentiable with respect to am and lm (the JAX
    ``simple_lattice_log_probs_pallas``). ``labels`` [B,U]; the row U+1
    gathers blank. The math is float32 whatever the inputs' dtype; autograd
    casts the gradients back through ``.float()``."""
    lab = F.pad(labels, (0, 1), value=blank).to(torch.int32).contiguous()
    return _SimpleLattice.apply(am.float().contiguous(), lm.float().contiguous(), lab, blank)
