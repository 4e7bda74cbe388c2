"""Helpers of the port's loss tests (tests/test_torch_losses_*.py): the
tiny shapes, tolerances, input makers and comparisons they share. Not
collected by pytest (no test_ prefix)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conformer_tpu.ops import rnnt as j_rnnt
from conformer_tpu.ops import rnnt_pruned as j_pruned

TOL = dict(rtol=1e-4, atol=1e-4)
B, T, U, V = 3, 37, 6, 37
W = np.array([1.0, 0.5, 2.0], np.float32)       # non-uniform cotangents


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _lattice(seed):
    rng = np.random.default_rng(seed)
    sig = lambda x: np.log(1 / (1 + np.exp(-x)))  # noqa: E731
    lpb = sig(rng.standard_normal((B, T, U + 1))).astype(np.float32)
    lpe = sig(rng.standard_normal((B, T, U + 1))).astype(np.float32)
    return lpb, lpe


# (t_len, u_len) per row: full, ragged, and the edge rows t_len = 1 /
# u_len = 0 (a bucket-padding row has t_len 1 and u_len 0)
LENGTHS = {
    "ragged": ([37, 20, 30], [6, 2, 4]),
    "edges": ([37, 1, 1], [0, 0, 3]),
    "padding_row": ([12, 1, 37], [5, 0, 6]),
}

# the CUDA kernels' dispatch edges in U+1 (csrc/rnnt_lattice.cu): C =
# ceil((U+1)/32) cells a lane of the one-warp kernels, which take U+1 <= 320;
# the block path above. (T, U+1) per case; the rows: (T, U) (u_len = U),
# (1, 0) (t_len = 1, u_len = 0: a bucket-padding row) and a ragged one.
ONE_WARP_MAX_U1 = 320

WIDTHS = {"u1_32": (21, 32), "u1_33": (21, 33), "u1_65": (19, 65),
          "u1_past_one_warp": (9, ONE_WARP_MAX_U1 + 1), "u1_201": (13, 201)}


def _lattice_case(case):
    """(lp_blank, lp_emit, t_len, u_len) of a LENGTHS or WIDTHS case."""
    if case in LENGTHS:
        return (*_lattice(1), *(np.array(x, np.int32) for x in LENGTHS[case]))
    t, u1 = WIDTHS[case]
    rng = np.random.default_rng(u1)
    sig = lambda x: np.log(1 / (1 + np.exp(-x)))  # noqa: E731
    lpb, lpe = (sig(rng.standard_normal((3, t, u1))).astype(np.float32) for _ in range(2))
    return (lpb, lpe, np.array([t, 1, t - 3], np.int32),
            np.array([u1 - 1, 0, (u1 - 1) // 2], np.int32))


# The one-warp kernels' arithmetic (csrc/rnnt_lattice.cu): logaddexp as
# max + lg2(1 + ex2(-|a - b| log2 e)) ln 2 on the MUFU approximations, the
# occupancies as ex2(x log2 e). Their documented bounds (CUDA Math API:
# __logf, which is lg2.approx times ln 2, within 2^-21.41 absolute on [0.5,
# 2]; __expf, which is ex2.approx of x log2 e, within 2 + 1.173 |x| ulp)
# put the logaddexp's small term within LAE_ERR of the exact one (2^-21.41
# plus 2 ulp of y <= 1 plus the rounding of 1 + y) and an occupancy within
# (2 + 1.173 |x|) 2^-23 of it, relatively.
LAE_ERR = 6.6e-7


def _fast_torch(mode, seed=0):
    """``torch`` for ``ops/rnnt_lattice.py``'s plain versions with the
    kernels' arithmetic: each logaddexp's small term and each occupancy
    moved by their whole error bound, up ("high"), down ("low") or by a
    seeded uniform draw within it ("random")."""
    gen = torch.Generator().manual_seed(seed)

    def within(x, bound):
        if mode == "high":
            return bound
        if mode == "low":
            return -bound
        return (2 * torch.rand(x.shape, generator=gen) - 1) * bound

    class FastTorch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def logaddexp(a, b):
            small = torch.log1p(torch.exp(-(a - b).abs()))
            return torch.maximum(a, b) + (small + within(small, LAE_ERR))

        @staticmethod
        def exp(x):
            y = torch.exp(x)
            return y * (1 + within(y, (2 + 1.173 * x.abs()) * 2.0 ** -23))

    return FastTorch()


def _simple_inputs(seed, u=U):
    rng = np.random.default_rng(seed)
    am = (2 * rng.standard_normal((B, T, V))).astype(np.float32)
    lm = (2 * rng.standard_normal((B, u + 1, V))).astype(np.float32)
    labels = rng.integers(1, V, (B, u)).astype(np.int32)
    return am, lm, labels


def _sincos(lpb, lpe, mod):
    return mod.sum(mod.sin(lpb) + 0.5 * mod.cos(lpe))


def _long_label_inputs(seed=11, b=1, t=3, u=300, v=40):
    rng = np.random.default_rng(seed)
    am = (2 * rng.standard_normal((b, t, v))).astype(np.float32)
    lm = (2 * rng.standard_normal((b, u + 1, v))).astype(np.float32)
    return am, lm, rng.integers(1, v, (b, u)).astype(np.int32)


def _maxima_apart(seed):
    """am's maxima at v = 5 on the first half of t, lm's at v = 9 on the
    second half of u, each spike 200 nats high: on the cells where both
    meet, every term of the factored sum is ~e^-200 (0 in float32)."""
    am, lm, labels = _simple_inputs(seed)
    am[:, :T // 2, 5] += 200.0
    lm[:, (U + 1) // 2:, 9] += 200.0
    return am, lm, labels


FACTORED_CASES = {
    "random": lambda: _simple_inputs(4),
    "long_labels": _long_label_inputs,
    "maxima_apart": lambda: _maxima_apart(12),
}


def _off_or_nonfinite(got, want, tol=1e-2):
    got = _np(got)
    return not np.isfinite(got).all() or np.abs(got - _np(want)).max() > tol


def _ctc_inputs(seed, t_lens, u_lens, u=U, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, t, V)).astype(np.float32)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    labels = rng.integers(1, V, (B, u)).astype(np.int32)
    labels[0, 1] = labels[0, 0]                     # a repeat: no skip there
    labels[2, 3] = labels[2, 2]
    u_lens = np.asarray(u_lens, np.int32)
    labels = np.where(np.arange(u)[None, :] < u_lens[:, None], labels, 0).astype(np.int32)
    return lp, np.asarray(t_lens, np.int32), labels, u_lens


# (t_lens, u_lens[, U, T]): the rows t_len = 1 / u_len = 0 (a
# bucket-padding row) and u_len = U; and the CUDA kernels' dispatch edges in
# S = 2U+1 (csrc/ctc_dp.cu): the chain kernels on one warp (S = 31) and two
# (33), two and three (63 and 65 = 2 x 32 + 1)
CTC_LENGTHS = {
    "ragged": ([37, 30, 20], [6, 3, 5]),
    "edges": ([37, 1, 2], [6, 0, 1]),
    "s31": ([40, 1, 25], [15, 0, 8], 15, 40),
    "s33": ([40, 1, 30], [16, 0, 10], 16, 40),
    "s63": ([70, 1, 45], [31, 0, 20], 31, 70),
}


def _float64_grad(fn, *inputs):
    """Gradients of sum(fn(*inputs)) with float64 as the default dtype (the
    plain forwards allocate their carries in it)."""
    xs = [x.double().requires_grad_() for x in inputs]
    torch.set_default_dtype(torch.float64)
    try:
        out = fn(*xs)
    finally:
        torch.set_default_dtype(torch.float32)
    return torch.autograd.grad(out.sum(), xs)


def _pruned_inputs(seed):
    am, lm, labels = _simple_inputs(seed)
    rng = np.random.default_rng(seed + 1)
    j = 16
    enc = rng.standard_normal((B, T, j)).astype(np.float32)
    pred = rng.standard_normal((B, U + 1, j)).astype(np.float32)
    w = (0.3 * rng.standard_normal((j, V))).astype(np.float32)
    b = (0.1 * rng.standard_normal(V)).astype(np.float32)
    tl = np.array([37, 25, 1], np.int32)
    ul = np.array([6, 4, 0], np.int32)
    return am, lm, enc, pred, w, b, labels, tl, ul


def _j_s_begin(am, lm, labels, tl, ul, s_range):
    lpb, lpe = j_pruned.simple_lattice_log_probs(jnp.asarray(am), jnp.asarray(lm),
                                                 jnp.asarray(labels))
    occ = -jax.grad(lambda x: jnp.sum(j_rnnt.rnnt_loss_from_log_probs(
        x, lpe, jnp.asarray(tl), jnp.asarray(ul))))(lpb)
    return j_pruned.prune_bounds_from_occupancy(occ, jnp.asarray(tl), jnp.asarray(ul),
                                                s_range), occ

