"""Simple-lattice scoring of the pruned RNN-T loss: CUDA kernels, forward and
backward, and their plain versions.

Replaces the Pallas TPU kernel
``conformer_tpu/ops/pallas/simple_lattice_kernel.py`` (``_forward`` /
``_fwd_kernel``, ``_backward`` / ``_bwd_kernel``, wrapped by
``simple_lattice_log_probs_pallas``). The kernels are
``csrc/simple_lattice.cu``; its source note gives the math, the bound and
the design: float32 products of the factored logsumexp, with cells whose
factored sum underflows (``GUARD_LOG2``) computed exactly.
``simple_lattice_fwd``/``simple_lattice_bwd`` launch them for CUDA tensors
and take the plain versions only for CPU tensors; each counts its launches
in ``.launches`` and keeps, in ``.guarded``, a device tensor whose sum is
the number of guarded cells of its last call.

The plain versions are the direct logsumexp, chunked over T, so they build
[B, t_chunk, U+1, V] at a time and never the whole lattice.
``simple_lattice_factored_fwd``/``_bwd`` repeat the kernels' arithmetic
(maxima, exps, products, the guard) in plain PyTorch for the tests and the
smoke run; no model path calls them.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import cuda_build

_U_TILE = 72        # the forward kernel's u rows per block (its product's N)
_MAX_U_TILES = 65535   # the forward's grid: (u tile, V split) pairs
GUARD_LOG2 = -60.0  # a cell whose factored sum s is below 2^-60 is computed exactly
_GUARD_CELLS = 4096   # guarded cells per exact chunk of the factored versions


def max_u1() -> int:
    """The largest U+1 both kernels take. No block's shape or shared memory
    depends on U (the forward tiles u by 72 rows, the backward walks chunks
    of 72), so the limit is the forward grid's third dimension, 65535
    (u tile, V split) pairs at one split; JAX's kernel has no cap."""
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


def _sparse_terms(dam, dlm, lab, g_blank, g_emit, blank):
    """Adds the blank and label terms of the backward: d am[t, blank] +=
    sum_u g_b, d am[t, lab_u] += g_e[t, u], and their sums over t into d lm."""
    b, t, v = dam.shape
    u1 = dlm.shape[1]
    ok = (lab >= 0) & (lab < v)
    idx = torch.where(ok, lab, 0).long()
    ge = torch.where(ok[:, None, :], g_emit, 0.0)
    dam[:, :, blank] += g_blank.sum(2)
    dam.scatter_add_(2, idx[:, None, :].expand(b, t, u1), ge)
    dlm[:, :, blank] += g_blank.sum(1)
    dlm.scatter_add_(2, idx[:, :, None], ge.sum(1)[:, :, None])


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


def _maxima(am, lm):
    return am.amax(-1, keepdim=True), lm.amax(-1, keepdim=True)


def _guarded_rows(cells, am, lm, logz=None):
    """For guarded cells (index tensors b, t, u): their direct logsumexp over
    V, or, given logZ, their rows p = exp(am + lm - logZ) [n, V]; in chunks."""
    b, t, u = cells
    out = []
    for i in range(0, b.numel(), _GUARD_CELLS):
        sl = slice(i, i + _GUARD_CELLS)
        x = am[b[sl], t[sl]] + lm[b[sl], u[sl]]
        out.append(torch.logsumexp(x, -1) if logz is None
                   else torch.exp(x - logz[b[sl], t[sl], u[sl], None]))
    return torch.cat(out) if out else am.new_zeros((0,) if logz is None else (0, am.shape[2]))


def simple_lattice_factored_fwd(am, lm, lab, blank: int, guard: bool = True):
    """The forward kernels' arithmetic in plain PyTorch: row maxima, exps,
    one float32 product s = ea @ el^T, logZ = ma + ml + log s, and, with
    ``guard``, the direct logsumexp on cells with s < 2^GUARD_LOG2 (or not
    finite). Returns (lp_blank, lp_emit, logZ, guarded) with ``guarded``
    the bool mask [B,T,U+1] of the cells the guard took."""
    ma, ml = _maxima(am, lm)
    s = torch.matmul(torch.exp(am - ma), torch.exp(lm - ml).transpose(1, 2))
    logz = ma + ml.transpose(1, 2) + torch.log(s)
    guarded = ~(s >= 2.0 ** GUARD_LOG2)
    if guard:
        cells = guarded.nonzero(as_tuple=True)
        logz = logz.index_put(cells, _guarded_rows(cells, am, lm))
    bl, em = _picks(am, lm, lab, blank)
    return bl - logz, em - logz, logz, guarded


def simple_lattice_factored_bwd(am, lm, lab, logz, g_blank, g_emit, blank: int,
                                guard: bool = True):
    """The backward kernels' arithmetic in plain PyTorch: W = (g_b+g_e) *
    exp(ma + ml - logZ), 0 on guarded cells (log2 s = (logZ - ma - ml) *
    log2(e) < GUARD_LOG2), d am = -ea * (W @ el), d lm = -el * (W^T @ ea),
    the sparse blank and label terms, and the guarded cells' exact rows.
    Without ``guard`` every cell goes through the products. Returns
    (d am, d lm, guarded)."""
    ma, ml = _maxima(am, lm)
    d = logz - ma - ml.transpose(1, 2)
    guarded = ~(d * (1.0 / math.log(2.0)) >= GUARD_LOG2)
    g = g_blank + g_emit
    w = g * torch.exp(-d)
    if guard:
        w = torch.where(guarded, 0.0, w)
    ea, el = torch.exp(am - ma), torch.exp(lm - ml)
    dam = -ea * torch.matmul(w, el)
    dlm = -el * torch.matmul(w.transpose(1, 2), ea)
    _sparse_terms(dam, dlm, lab, g_blank, g_emit, blank)
    if guard:
        cells = guarded.nonzero(as_tuple=True)
        gp = -g[cells][:, None] * _guarded_rows(cells, am, lm, logz)
        dam.index_put_((cells[0], cells[1]), gp, accumulate=True)
        dlm.index_put_((cells[0], cells[2]), gp, accumulate=True)
    return dam, dlm, guarded


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
    tensors take the plain version, CUDA tensors launch the kernels or raise
    (float32 contiguous, int32 labels, U+1 <= ``max_u1()``). Two kernels a
    call (the split products, then their merge with the guard and picks)."""
    if am.device.type == "cpu":
        return simple_lattice_plain_fwd(am, lm, lab, blank)
    _check("simple_lattice_fwd", (am, lm), lab)
    b, t, u1, v = _shape("simple_lattice_fwd", am, lm, lab, blank)
    lpb, lpe, logz = (torch.empty((b, t, u1), dtype=torch.float32, device=am.device)
                      for _ in range(3))
    splits = cuda_build.load_function("simple_lattice", "simple_lattice_fwd_splits", n_ptrs=0,
                                      n_ints=4)(b, t, u1, v)
    work = torch.empty(splits * b * (t * u1 + t + u1), dtype=torch.float32, device=am.device)
    count = torch.empty(1, dtype=torch.int32, device=am.device)
    fn = cuda_build.load_function("simple_lattice", "simple_lattice_fwd", n_ptrs=10, n_ints=6)
    P = cuda_build.ptr
    launched = ctypes.c_int(0)
    err = fn(P(am), P(lm), P(lab), P(lpb), P(lpe), P(logz), P(work), P(count),
             ctypes.addressof(launched), cuda_build.stream_ptr(am), b, t, u1, v, blank, splits)
    simple_lattice_fwd.launches += launched.value
    cuda_build.check(err, "simple_lattice_fwd")
    simple_lattice_fwd.guarded = count
    return lpb, lpe, logz


def simple_lattice_bwd(am, lm, lab, logz, g_blank, g_emit, blank: int):
    """Kernel wrapper with the contract of ``simple_lattice_plain_bwd``; every
    sum is taken in a fixed order (no atomics). Four kernels a call: the row
    maxima, W and the sparse sums, the products, the guarded cells'
    exact rows; ``.launches`` counts them as the C entry reports them."""
    if am.device.type == "cpu":
        return simple_lattice_plain_bwd(am, lm, lab, logz, g_blank, g_emit, blank)
    _check("simple_lattice_bwd", (am, lm, logz, g_blank, g_emit), lab)
    b, t, u1, v = _shape("simple_lattice_bwd", am, lm, lab, blank)
    if any(x.shape != (b, t, u1) for x in (logz, g_blank, g_emit)):
        raise ValueError("simple_lattice_bwd: inconsistent shapes")
    dam = torch.empty_like(am)
    dlm = torch.empty_like(lm)
    u1p = -(-u1 // 4) * 4
    work = torch.empty(b * (t * u1p + 2 * t + 3 * u1), dtype=torch.float32, device=am.device)
    iwork = torch.empty(b * (t + u1), dtype=torch.int32, device=am.device)
    fn = cuda_build.load_function("simple_lattice", "simple_lattice_bwd", n_ptrs=12, n_ints=5)
    P = cuda_build.ptr
    launched = ctypes.c_int(0)
    err = fn(P(am), P(lm), P(lab), P(logz), P(g_blank), P(g_emit), P(dam), P(dlm), P(work),
             P(iwork), ctypes.addressof(launched), cuda_build.stream_ptr(am), b, t, u1, v, blank)
    simple_lattice_bwd.launches += launched.value
    cuda_build.check(err, "simple_lattice_bwd")
    simple_lattice_bwd.guarded = iwork[:b * t]
    return dam, dlm


simple_lattice_fwd.launches = 0
simple_lattice_bwd.launches = 0
simple_lattice_fwd.guarded = None
simple_lattice_bwd.guarded = None


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
