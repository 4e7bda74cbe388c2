"""The port's loss kernels' plain versions and the losses around them,
against the JAX package: its Pallas kernels (interpret mode on the CPU)
and its XLA oracles, forward and ``jax.grad``.

Tiny shapes that no tile divides (B=3, T=37, U=6, V=37), float32 on both
sides, inputs from a seeded numpy generator. Tolerance 1e-4 abs and rel
unless a test says otherwise: both sides compute in float32 with sums in
different orders.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conformer_tpu.ops import ctc as j_ctc
from conformer_tpu.ops import rnnt as j_rnnt
from conformer_tpu.ops import rnnt_pruned as j_pruned
from conformer_tpu.ops.pallas import joint_kernel as jk
from conformer_tpu.ops.pallas.ctc_kernel import ctc_loss_pallas
from conformer_tpu.ops.pallas.rnnt_kernel import rnnt_loss_from_log_probs_pallas
from conformer_tpu.ops.pallas.simple_lattice_kernel import simple_lattice_log_probs_pallas
from conformer_tpu_torch.ops import ctc as p_ctc
from conformer_tpu_torch.ops import ctc_dp as p_ctc_dp
from conformer_tpu_torch.ops import fbank_kernel as p_fbank
from conformer_tpu_torch.ops import joint_lattice as p_joint
from conformer_tpu_torch.ops import rnnt as p_rnnt
from conformer_tpu_torch.ops import rnnt_lattice as p_lat
from conformer_tpu_torch.ops import rnnt_pruned as p_pruned
from conformer_tpu_torch.ops import simple_lattice as p_simple

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


# ------------------------------------------------------------ RNN-T lattice


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


@pytest.mark.parametrize("case", [*sorted(LENGTHS), *WIDTHS])
def test_rnnt_lattice_plain_matches_pallas_and_oracle(case):
    lpb, lpe, tl, ul = _lattice_case(case)
    args = (jnp.asarray(tl), jnp.asarray(ul))

    def j_loss(fn):
        return lambda a, b: jnp.sum(jnp.asarray(W) * fn(a, b, *args))

    pallas = lambda a, b, t, u: rnnt_loss_from_log_probs_pallas(a, b, t, u, interpret=True)  # noqa: E731
    j_nll = pallas(jnp.asarray(lpb), jnp.asarray(lpe), *args)
    j_g = jax.grad(j_loss(pallas), argnums=(0, 1))(jnp.asarray(lpb), jnp.asarray(lpe))
    o_nll = j_rnnt.rnnt_loss_from_log_probs(jnp.asarray(lpb), jnp.asarray(lpe), *args)
    o_g = jax.grad(j_loss(j_rnnt.rnnt_loss_from_log_probs), argnums=(0, 1))(
        jnp.asarray(lpb), jnp.asarray(lpe))
    _close(j_nll, o_nll)

    a, b = _t(lpb, True), _t(lpe, True)
    nll = p_lat.rnnt_lattice_nll(a, b, _t(tl), _t(ul))
    (nll * _t(W)).sum().backward()
    _close(nll, j_nll)
    _close(a.grad, j_g[0])
    _close(b.grad, j_g[1])
    _close(a.grad, o_g[0])
    _close(b.grad, o_g[1])
    if case == "edges" or case in WIDTHS:   # u_len = 0, t_len = 1: nll = -lp_blank[0, 0]
        assert float(nll[1].detach()) == pytest.approx(-lpb[1, 0, 0], abs=1e-6)


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


@pytest.mark.parametrize("mode", ["random", "high", "low"])
def test_rnnt_lattice_fast_arithmetic_matches_jax(mode):
    """The one-warp kernels' approximate logaddexp and exps, emulated step
    for step on the plain versions' wavefront (each result moved by its
    whole documented error bound, ``_fast_torch``), forward then backward
    from the emulated alpha and NLL, at |logZ| ~ 2700 (T=300, U=30,
    near-uniform log-probs, as on random weights at full width). The NLL
    against JAX's kernel (interpret mode) within ``chip_smoke.TOL
    ["float32"]`` (2e-4 abs and rel). The gradients: JAX's own float32
    gradients are 4.8e-4 (its kernel) and 7.0e-4 (its scan) from the
    float64 gradient at this logZ (unnormalised occupancies), so they are
    held to the float64 gradient of the plain forward within 2e-4 absolute,
    and no further from it than JAX's kernel. A bias the same at every step
    moves alpha + beta - logZ by nothing ("high", "low")."""
    rng = np.random.default_rng(17)
    b, t, u = 2, 300, 30
    lpb, lpe = ((-8.5 + 0.1 * rng.standard_normal((b, t, u + 1))).astype(np.float32)
                for _ in range(2))
    tl, ul = np.array([t, 200], np.int32), np.array([u, 15], np.int32)
    g = np.array([1.0, 0.5], np.float32)
    jargs = (jnp.asarray(tl), jnp.asarray(ul))
    pallas = functools.partial(rnnt_loss_from_log_probs_pallas, interpret=True)
    j_nll = pallas(jnp.asarray(lpb), jnp.asarray(lpe), *jargs)
    j_g = jax.grad(lambda x, y: jnp.sum(jnp.asarray(g) * pallas(x, y, *jargs)),
                   argnums=(0, 1))(jnp.asarray(lpb), jnp.asarray(lpe))
    assert float(jnp.min(j_nll)) > 1700
    args = (_t(lpb), _t(lpe), _t(tl), _t(ul))
    with mock.patch.object(p_lat, "torch", _fast_torch(mode)):
        nll, alpha = p_lat.rnnt_lattice_plain_fwd(*args)
        grads = p_lat.rnnt_lattice_plain_bwd(*args[:2], alpha, *args[2:], nll, _t(g))
    _close(nll, j_nll, rtol=2e-4, atol=2e-4)
    want = _float64_grad(lambda x, y: p_lat.rnnt_lattice_plain_fwd(
        x, y, args[2].long(), args[3].long())[0] * _t(g).double(), *args[:2])
    for got, exact, jax_g in zip(grads, want, j_g):
        err = float((got.double() - exact).abs().max())
        assert err <= 2e-4, err
        assert err <= float(np.abs(np.asarray(jax_g, np.float64) - exact.numpy()).max())


def test_rnnt_lattice_plain_bwd_matches_autograd_through_frozen_scan():
    """The plain forward computes the cells past t_len; the port's scan
    oracle freezes them. The NLL and the gradients agree either way, and
    the explicit beta pass equals autograd through the scan."""
    lpb, lpe = _lattice(2)
    tl, ul = (np.array(x, np.int32) for x in LENGTHS["ragged"])
    a, b = _t(lpb, True), _t(lpe, True)
    nll = p_rnnt.rnnt_loss_from_log_probs(a, b, _t(tl), _t(ul))
    (nll * _t(W)).sum().backward()
    nll_p, alpha = p_lat.rnnt_lattice_plain_fwd(_t(lpb), _t(lpe), _t(tl), _t(ul))
    gb, ge = p_lat.rnnt_lattice_plain_bwd(_t(lpb), _t(lpe), alpha, _t(tl), _t(ul), nll_p, _t(W))
    _close(nll_p, nll)
    _close(gb, a.grad)
    _close(ge, b.grad)
    for i, t_len in enumerate(tl):
        assert (gb[i, t_len:] == 0).all() and (ge[i, t_len:] == 0).all()


def test_semiring_scan_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((4, 13)).astype(np.float32)
    w = rng.standard_normal((4, 13)).astype(np.float32)
    _close(p_rnnt._semiring_linear_scan(_t(base), _t(w)),
           j_rnnt._semiring_linear_scan(jnp.asarray(base), jnp.asarray(w)))


# ------------------------------------------------------------ simple lattice


def _simple_inputs(seed, u=U):
    rng = np.random.default_rng(seed)
    am = (2 * rng.standard_normal((B, T, V))).astype(np.float32)
    lm = (2 * rng.standard_normal((B, u + 1, V))).astype(np.float32)
    labels = rng.integers(1, V, (B, u)).astype(np.int32)
    return am, lm, labels


def _sincos(lpb, lpe, mod):
    return mod.sum(mod.sin(lpb) + 0.5 * mod.cos(lpe))


def test_simple_lattice_plain_matches_pallas():
    am, lm, labels = _simple_inputs(4)

    def j_fn(a, m):
        return _sincos(*simple_lattice_log_probs_pallas(a, m, jnp.asarray(labels),
                                                        interpret=True), jnp)

    j_b, j_e = simple_lattice_log_probs_pallas(jnp.asarray(am), jnp.asarray(lm),
                                               jnp.asarray(labels), interpret=True)
    j_g = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(am), jnp.asarray(lm))
    ta, tm = _t(am, True), _t(lm, True)
    lpb, lpe = p_simple.simple_lattice_log_probs_fused(ta, tm, _t(labels))
    _sincos(lpb, lpe, torch).backward()
    _close(lpb, j_b)
    _close(lpe, j_e)
    _close(ta.grad, j_g[0])
    _close(tm.grad, j_g[1])


def test_simple_lattice_plain_at_long_labels_matches_pallas():
    """U+1 = 301, past the 72-row u tile of the forward kernel and the
    72-row u chunk of its backward (the wrappers take it: ``max_u1``), at a
    small T and V (B=1, T=3, V=40): forward and both gradients against
    JAX's kernel in interpret mode, 1e-4 abs and rel."""
    b, t, u, v = 1, 3, 300, 40
    rng = np.random.default_rng(11)
    am = (2 * rng.standard_normal((b, t, v))).astype(np.float32)
    lm = (2 * rng.standard_normal((b, u + 1, v))).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    assert p_simple.max_u1() >= u + 1

    def j_fn(a, m):
        return _sincos(*simple_lattice_log_probs_pallas(a, m, jnp.asarray(labels),
                                                        interpret=True), jnp)

    j_b, j_e = simple_lattice_log_probs_pallas(jnp.asarray(am), jnp.asarray(lm),
                                               jnp.asarray(labels), interpret=True)
    j_g = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(am), jnp.asarray(lm))
    ta, tm = _t(am, True), _t(lm, True)
    lpb, lpe = p_simple.simple_lattice_log_probs_fused(ta, tm, _t(labels))
    _sincos(lpb, lpe, torch).backward()
    _close(lpb, j_b)
    _close(lpe, j_e)
    _close(ta.grad, j_g[0])
    _close(tm.grad, j_g[1])


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


@pytest.mark.parametrize("case", sorted(FACTORED_CASES))
def test_simple_lattice_factored_matches_pallas(case):
    """The CUDA kernels' arithmetic (``simple_lattice_factored_fwd``/``_bwd``:
    maxima, exps, float32 products, the guard) against JAX's kernel in
    interpret mode, forward and both gradients (its VJP at random
    cotangents, from the factored logZ), 1e-4 abs and rel: the random
    inputs, U+1 = 301, and the maxima 200 nats apart on different v, where
    the guard must take cells and the factored form without it is off by
    more than 1e-2 or not finite. On the first two the guard takes none."""
    am, lm, labels = FACTORED_CASES[case]()
    b, t, u1 = am.shape[0], am.shape[1], lm.shape[1]
    rng = np.random.default_rng(21)
    gb, ge = (rng.standard_normal((b, t, u1)).astype(np.float32) for _ in range(2))
    (j_b, j_e), vjp = jax.vjp(
        lambda a, m: simple_lattice_log_probs_pallas(a, m, jnp.asarray(labels), interpret=True),
        jnp.asarray(am), jnp.asarray(lm))
    j_dam, j_dlm = vjp((jnp.asarray(gb), jnp.asarray(ge)))
    lab = F.pad(_t(labels), (0, 1)).to(torch.int32)
    lpb, lpe, logz, guarded = p_simple.simple_lattice_factored_fwd(_t(am), _t(lm), lab, 0)
    dam, dlm, g_bwd = p_simple.simple_lattice_factored_bwd(_t(am), _t(lm), lab, logz, _t(gb),
                                                           _t(ge), 0)
    _close(lpb, j_b)
    _close(lpe, j_e)
    _close(dam, j_dam)
    _close(dlm, j_dlm)
    assert torch.equal(guarded, g_bwd)
    if case != "maxima_apart":
        assert not guarded.any()
        return
    assert int(guarded.sum()) > 0
    _, _, z_raw, _ = p_simple.simple_lattice_factored_fwd(_t(am), _t(lm), lab, 0, guard=False)
    assert _off_or_nonfinite(z_raw[guarded], logz[guarded])
    dam_raw, dlm_raw, _ = p_simple.simple_lattice_factored_bwd(_t(am), _t(lm), lab, logz,
                                                               _t(gb), _t(ge), 0, guard=False)
    assert _off_or_nonfinite(dam_raw, j_dam) and _off_or_nonfinite(dlm_raw, j_dlm)


@pytest.mark.parametrize("scale", [1.0, 2.0, 4.0])
def test_simple_lattice_guard_idle_on_recipe_like_inputs(scale):
    """At the recipe's vocabulary (V = 5002) and random-normal am, lm of
    standard deviation 1-4 (2 is the smoke run's), the guard takes no cell,
    forward or backward, and the factored arithmetic matches the direct
    plain versions within 1e-4."""
    b, t, u, v = 2, 12, 8, 5002
    rng = np.random.default_rng(31)
    am = _t((scale * rng.standard_normal((b, t, v))).astype(np.float32))
    lm = _t((scale * rng.standard_normal((b, u + 1, v))).astype(np.float32))
    lab = F.pad(_t(rng.integers(1, v - 1, (b, u)).astype(np.int32)), (0, 1)).to(torch.int32)
    gb, ge = (_t(rng.standard_normal((b, t, u + 1)).astype(np.float32)) for _ in range(2))
    *fwd, guarded = p_simple.simple_lattice_factored_fwd(am, lm, lab, 0)
    *bwd, g_bwd = p_simple.simple_lattice_factored_bwd(am, lm, lab, fwd[2], gb, ge, 0)
    assert not guarded.any() and not g_bwd.any()
    for got, want in zip(fwd, p_simple.simple_lattice_plain_fwd(am, lm, lab, 0)):
        _close(got, want)
    for got, want in zip(bwd, p_simple.simple_lattice_plain_bwd(am, lm, lab, fwd[2], gb, ge, 0)):
        _close(got, want)


def test_simple_lattice_plain_matches_xla_oracle_and_logz():
    am, lm, labels = _simple_inputs(5)
    j_b, j_e = j_pruned.simple_lattice_log_probs(jnp.asarray(am), jnp.asarray(lm),
                                                 jnp.asarray(labels))
    lab = F.pad(_t(labels), (0, 1)).to(torch.int32)
    lpb, lpe, logz = p_simple.simple_lattice_plain_fwd(_t(am), _t(lm), lab, 0, t_chunk=8)
    _close(lpb, j_b)
    _close(lpe, j_e)
    want_z = np.log(np.exp(am[:, :, None, :].astype(np.float64) + lm[:, None]).sum(-1))
    _close(logz, want_z)
    # the port's chunked, checkpointed plain pass (the path with the flag off)
    ta, tm = _t(am, True), _t(lm, True)
    c_b, c_e = p_pruned.simple_lattice_log_probs(ta, tm, _t(labels), t_chunk=16)
    _close(c_b, j_b)
    _close(c_e, j_e)


def test_simple_lattice_plain_bwd_matches_autograd():
    am, lm, labels = _simple_inputs(6)
    lab = F.pad(_t(labels), (0, 1)).to(torch.int32)
    rng = np.random.default_rng(7)
    gb, ge = (_t(rng.standard_normal((B, T, U + 1)).astype(np.float32)) for _ in range(2))
    ta, tm = _t(am, True), _t(lm, True)
    lpb, lpe, logz = p_simple.simple_lattice_plain_fwd(ta, tm, lab, 0, t_chunk=8)
    ((lpb * gb).sum() + (lpe * ge).sum()).backward()
    dam, dlm = p_simple.simple_lattice_plain_bwd(_t(am), _t(lm), lab, logz.detach(), gb, ge, 0,
                                                 t_chunk=8)
    _close(dam, ta.grad)
    _close(dlm, tm.grad)


# ---------------------------------------------------------------------- CTC


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


@pytest.mark.parametrize("case", sorted(CTC_LENGTHS))
def test_ctc_dp_plain_matches_pallas_oracle_and_torch(case):
    lp, tl, labels, ul = _ctc_inputs(8, *CTC_LENGTHS[case])
    jargs = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ul))

    def j_fn(fn):
        return lambda x: jnp.sum(jnp.asarray(W) * fn(x, *jargs))

    pallas = lambda x, *a: ctc_loss_pallas(x, *a, interpret=True)  # noqa: E731
    j_nll = pallas(jnp.asarray(lp), *jargs)
    j_g = jax.grad(j_fn(pallas))(jnp.asarray(lp))
    o_nll = j_ctc.ctc_loss(jnp.asarray(lp), *jargs)
    o_g = jax.grad(j_fn(j_ctc.ctc_loss))(jnp.asarray(lp))

    x = _t(lp, True)
    nll = p_ctc_dp.ctc_loss_dp(x, _t(tl), _t(labels), _t(ul))
    (nll * _t(W)).sum().backward()
    _close(nll, j_nll)
    _close(nll, o_nll)
    _close(x.grad, j_g)
    _close(x.grad, o_g)
    for i, t_len in enumerate(tl):
        assert (x.grad[i, t_len:] == 0).all()
    # torch's CTC loss as a second oracle, value and gradient. Its backward
    # assumes log-softmax inputs, so both gradients are taken through one,
    # with respect to the logits
    grads = []
    for fn in (lambda y: p_ctc_dp.ctc_loss_dp(y, _t(tl), _t(labels), _t(ul)),
               lambda y: F.ctc_loss(y.transpose(0, 1), _t(labels).long(), _t(tl).long(),
                                    _t(ul).long(), blank=0, reduction="none")):
        z = _t(lp, True)
        out = fn(torch.log_softmax(z, dim=-1))
        (out * _t(W)).sum().backward()
        grads.append((out, z.grad))
    _close(grads[0][0], grads[1][0])
    _close(grads[0][1], grads[1][1])


def test_ctc_plain_scan_matches_jax_and_dp_bwd_matches_autograd():
    lp, tl, labels, ul = _ctc_inputs(9, *CTC_LENGTHS["ragged"])
    x = _t(lp, True)
    nll = p_ctc.ctc_loss(x, _t(tl), _t(labels), _t(ul))
    (nll * _t(W)).sum().backward()
    _close(nll, j_ctc.ctc_loss(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(labels),
                               jnp.asarray(ul)))
    ext = p_ctc._extended_labels(_t(labels).long(), 0)
    skip = torch.where(p_ctc.skip_allowed(ext, 0), 0.0, p_ctc.NEG_INF)
    emit = _t(lp).gather(2, ext[:, None, :].expand(B, T, ext.shape[1])).contiguous()
    nll_p, alpha = p_ctc_dp.ctc_dp_plain_fwd(emit, skip, _t(tl), _t(ul))
    g_emit = p_ctc_dp.ctc_dp_plain_bwd(emit, skip, alpha, _t(tl), _t(ul), nll_p, _t(W))
    grad = torch.zeros(B, T, V).scatter_add_(2, ext[:, None, :].expand(B, T, ext.shape[1]),
                                             g_emit)
    _close(nll_p, nll)
    _close(grad, x.grad)


def test_ctc_dp_route_is_a_function_of_s():
    """The C entries take the chain kernels up to 32 lanes x CHAIN_WARPS x
    CHAIN_MAX_C states and the block path above, by S alone;
    ``route`` mirrors that limit and the source's constants give it."""
    import re
    from pathlib import Path

    src = (Path(p_ctc_dp.__file__).resolve().parents[1] / "csrc" / "ctc_dp.cu").read_text()
    warps = int(re.search(r"constexpr int CHAIN_WARPS = (\d+);", src).group(1))
    max_c = int(re.search(r"constexpr int CHAIN_MAX_C = (\d+);", src).group(1))
    assert p_ctc_dp.CHAIN_MAX_STATES == 32 * warps * max_c
    s_max = p_ctc_dp.CHAIN_MAX_STATES
    assert [p_ctc_dp.route(s) for s in (1, 31, 33, 129, 401, s_max - 1, s_max, s_max + 1, 29056)] \
        == ["chain"] * 7 + ["block"] * 2


@pytest.mark.parametrize("mode", ["random", "high", "low"])
def test_ctc_dp_fast_arithmetic_matches_jax(mode):
    """The chain kernels' approximate logaddexp (two nested, in the plain
    version's order) and occupancy exps, emulated step for step on the plain
    versions (each result moved by its whole documented error bound,
    ``_fast_torch``), forward then backward from the emulated alpha and NLL,
    at |logZ| in the thousands (T=300, U=30, near-uniform log-probs of
    -8.5, as on random weights at full width). The NLL against JAX's kernel
    (interpret mode) within 2e-4 abs and rel; the gradient with respect to
    the log-probs within 2e-4 absolute of the float64 gradient of the plain
    forward, and no further from it than JAX's own kernel's."""
    rng = np.random.default_rng(19)
    b, t, u, v = 2, 300, 30, 40
    lp = (-8.5 + 0.1 * rng.standard_normal((b, t, v))).astype(np.float32)
    tl, ul = np.array([t, 200], np.int32), np.array([u, 15], np.int32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    labels = np.where(np.arange(u)[None, :] < ul[:, None], labels, 0).astype(np.int32)
    g = np.array([1.0, 0.5], np.float32)
    jargs = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ul))
    pallas = functools.partial(ctc_loss_pallas, interpret=True)
    j_nll = pallas(jnp.asarray(lp), *jargs)
    j_g = jax.grad(lambda x: jnp.sum(jnp.asarray(g) * pallas(x, *jargs)))(jnp.asarray(lp))
    assert float(jnp.min(j_nll)) > 1500
    ext = p_ctc._extended_labels(_t(labels).long(), 0)
    skip = torch.where(p_ctc.skip_allowed(ext, 0), 0.0, p_ctc.NEG_INF)
    idx = ext[:, None, :].expand(b, t, ext.shape[1])
    emit = _t(lp).gather(2, idx).contiguous()
    with mock.patch.object(p_ctc_dp, "torch", _fast_torch(mode)):
        nll, alpha = p_ctc_dp.ctc_dp_plain_fwd(emit, skip, _t(tl), _t(ul))
        g_emit = p_ctc_dp.ctc_dp_plain_bwd(emit, skip, alpha, _t(tl), _t(ul), nll, _t(g))
    _close(nll, j_nll, rtol=2e-4, atol=2e-4)
    got = torch.zeros(b, t, v, dtype=torch.float64).scatter_add_(2, idx, g_emit.double())
    (exact,) = _float64_grad(lambda y: p_ctc_dp.ctc_dp_plain_fwd(
        y.gather(2, idx), skip.double(), _t(tl).long(), _t(ul).long())[0] * _t(g).double(), _t(lp))
    err = float((got - exact).abs().max())
    assert err <= 2e-4, err
    assert err <= float(np.abs(np.asarray(j_g, np.float64) - exact.numpy()).max())


@pytest.mark.parametrize("dp,u", [("ctc", 400), ("rnnt", 600)])
def test_dp_plain_at_long_labels_matches_jax_oracle(dp, u):
    """Label lengths at which a launch of one thread per state runs out of
    registers (CTC above U ~ 330, the lattice above U ~ 500), which the DP
    kernels now walk with a block stride: CTC at U=400 (S=801; B=2, T=810,
    V=32) against the JAX ``ctc_loss`` scan, the transducer lattice at
    U=600 (B=2, T=40) against the JAX ``rnnt_loss_from_log_probs`` scan;
    NLL and gradients of sum(W * nll). Tolerance 1e-4 abs and rel as above (float32 on both
    sides, the NLL in the thousands, the gradients occupancies in [0, 1]),
    but for CTC's gradients: at T=810, JAX's float32 scan gradient is itself
    8.3e-4 off the float64 one, and the port's plain backward 1.4e-4, so
    they are held to 1e-3 of JAX's and 2e-4 of the float64 plain scan's."""
    rng = np.random.default_rng(11)
    w = W[:2]
    if dp == "ctc":
        t, v = 2 * u + 10, 32
        x = rng.standard_normal((2, t, v)).astype(np.float32)
        lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
        labels = rng.integers(1, v, (2, u)).astype(np.int32)
        tl, ul = np.array([t, t - 5], np.int32), np.array([u, u - 50], np.int32)
        labels = np.where(np.arange(u)[None, :] < ul[:, None], labels, 0).astype(np.int32)
        jargs = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ul))
        j_nll = j_ctc.ctc_loss(jnp.asarray(lp), *jargs)
        j_g = (jax.grad(lambda a: jnp.sum(jnp.asarray(w) * j_ctc.ctc_loss(a, *jargs)))(
            jnp.asarray(lp)),)
        leaves = [_t(lp, True)]
        nll = p_ctc_dp.ctc_loss_dp(*leaves, _t(tl), _t(labels), _t(ul))
        assert p_ctc_dp.max_states() >= 2 * u + 1
        # the limit the kernels have taken since they walk the states with a
        # block stride: no redesign may lower it
        assert p_ctc_dp.max_states() >= 29056
    else:
        t = 40
        sig = lambda z: np.log(1 / (1 + np.exp(-z)))  # noqa: E731
        lpb, lpe = (sig(rng.standard_normal((2, t, u + 1))).astype(np.float32)
                    for _ in range(2))
        tl, ul = np.array([t, t - 7], np.int32), np.array([u, u - 45], np.int32)
        jargs = (jnp.asarray(tl), jnp.asarray(ul))
        j_nll = j_rnnt.rnnt_loss_from_log_probs(jnp.asarray(lpb), jnp.asarray(lpe), *jargs)
        j_g = jax.grad(lambda a, b: jnp.sum(jnp.asarray(w) * j_rnnt.rnnt_loss_from_log_probs(
            a, b, *jargs)), argnums=(0, 1))(jnp.asarray(lpb), jnp.asarray(lpe))
        leaves = [_t(lpb, True), _t(lpe, True)]
        nll = p_lat.rnnt_lattice_nll(*leaves, _t(tl), _t(ul))
        assert p_lat.max_u1(t) >= u + 1
        # the limit the kernels have taken since they walk u with a block
        # stride: no redesign may lower it
        assert p_lat.max_u1(374) >= 28869
    (nll * _t(w)).sum().backward()
    _close(nll, j_nll)
    if dp == "ctc":
        _close(leaves[0].grad, j_g[0], atol=1e-3)
        g64, = _float64_grad(lambda a: _t(w).double() * p_ctc.ctc_loss(
            a, _t(tl), _t(labels), _t(ul)), _t(lp))
        _close(leaves[0].grad, g64, atol=2e-4)
    else:
        for leaf, want in zip(leaves, j_g):
            _close(leaf.grad, want)


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


@pytest.mark.parametrize("dp", ["rnnt", "ctc"])
def test_dp_bwd_occupancies_sum_to_one_at_large_logz(dp):
    """At |logZ| in the thousands (T=300, near-uniform log-probs, as on
    random weights at full width) the explicit beta pass divides each frame's
    (label's) occupancies by their sum: each sums to 1 within 1e-5, and the
    gradients agree with float64 autograd within 2.5e-4 absolute (max
    |gradient| 1; unnormalised, the blank gradients were 5.7e-4 off)."""
    rng = np.random.default_rng(13)
    b, t, u = 2, 300, 30
    tl, ul = torch.tensor([t, 200], dtype=torch.int32), torch.tensor([u, 15], dtype=torch.int32)
    g = torch.tensor([1.0, 0.5])
    live_t = (torch.arange(t)[None, :] < tl[:, None]).float()
    if dp == "rnnt":
        lpb, lpe = (torch.from_numpy(-8.5 + 0.1 * rng.standard_normal((b, t, u + 1))).float()
                    for _ in range(2))
        nll, alpha = p_lat.rnnt_lattice_plain_fwd(lpb, lpe, tl, ul)
        assert float(nll.min()) > 1700
        gb, ge = p_lat.rnnt_lattice_plain_bwd(lpb, lpe, alpha, tl, ul, nll, g)
        _close(-gb.sum(2) / g[:, None], live_t, atol=1e-5, rtol=0)
        live_u = (torch.arange(u + 1)[None, :] < ul[:, None]).float()
        _close(-ge.sum(1) / g[:, None], live_u, atol=1e-5, rtol=0)
        want = _float64_grad(lambda x, y: p_lat.rnnt_lattice_plain_fwd(
            x, y, tl.long(), ul.long())[0] * g.double(), lpb, lpe)
        _close(gb, want[0], atol=2.5e-4, rtol=0)
        _close(ge, want[1], atol=2.5e-4, rtol=0)
    else:
        x = 0.3 * rng.standard_normal((b, t, 40))
        lp = torch.from_numpy(x - np.log(np.exp(x).sum(-1, keepdims=True))).float()
        labels = torch.from_numpy(rng.integers(1, 40, (b, u)))
        labels = torch.where(torch.arange(u)[None, :] < ul[:, None].long(), labels, 0)
        ext = p_ctc._extended_labels(labels, 0)
        skip = torch.where(p_ctc.skip_allowed(ext, 0), 0.0, p_ctc.NEG_INF)
        idx = ext[:, None, :].expand(b, t, ext.shape[1])
        nll, alpha = p_ctc_dp.ctc_dp_plain_fwd(lp.gather(2, idx), skip, tl, ul)
        assert float(nll.min()) > 600
        g_emit = p_ctc_dp.ctc_dp_plain_bwd(lp.gather(2, idx), skip, alpha, tl, ul, nll, g)
        _close(-g_emit.sum(2) / g[:, None], live_t, atol=1e-5, rtol=0)
        (want,) = _float64_grad(lambda y: p_ctc_dp.ctc_dp_plain_fwd(
            y.gather(2, idx), skip.double(), tl.long(), ul.long())[0] * g.double(), lp)
        got = torch.zeros(b, t, 40).scatter_add_(2, idx, g_emit)
        _close(got, want, atol=2.5e-4, rtol=0)


# ------------------------------------------------------------------ wrappers


def test_wrappers_take_plain_on_cpu_and_count_no_launch():
    lpb, lpe = _lattice(10)
    tl, ul = (_t(np.array(x, np.int32)) for x in LENGTHS["ragged"])
    am, lm, labels = _simple_inputs(11)
    lab = F.pad(_t(labels), (0, 1)).to(torch.int32)
    lp, ctl, clab, cul = _ctc_inputs(12, *CTC_LENGTHS["ragged"])
    ext = p_ctc._extended_labels(_t(clab).long(), 0)
    skip = torch.where(p_ctc.skip_allowed(ext, 0), 0.0, p_ctc.NEG_INF)
    emit = _t(lp).gather(2, ext[:, None, :].expand(B, T, ext.shape[1])).contiguous()
    g = _t(W)
    _, _, enc, pred, w, b, _, _, _ = _pruned_inputs(13)
    wave = _t(np.sin(np.arange(4000, dtype=np.float32) / 7.0)[None] * 3000.0)
    wrappers = (p_simple.simple_lattice_fwd, p_simple.simple_lattice_bwd, p_lat.rnnt_lattice_fwd,
                p_lat.rnnt_lattice_bwd, p_ctc_dp.ctc_dp_fwd, p_ctc_dp.ctc_dp_bwd,
                p_joint.joint_lattice_fwd, p_joint.joint_lattice_bwd_xp,
                p_joint.joint_lattice_bwd_w, p_fbank.fbank_kernel)
    before = [w.launches for w in wrappers]

    s_out = p_simple.simple_lattice_fwd(_t(am), _t(lm), lab, 0)
    s_ref = p_simple.simple_lattice_plain_fwd(_t(am), _t(lm), lab, 0)
    gb, ge = torch.ones(B, T, U + 1), torch.full((B, T, U + 1), 0.5)
    s_bwd = p_simple.simple_lattice_bwd(_t(am), _t(lm), lab, s_ref[2], gb, ge, 0)
    s_bwd_ref = p_simple.simple_lattice_plain_bwd(_t(am), _t(lm), lab, s_ref[2], gb, ge, 0)
    r_out = p_lat.rnnt_lattice_fwd(_t(lpb), _t(lpe), tl, ul)
    r_ref = p_lat.rnnt_lattice_plain_fwd(_t(lpb), _t(lpe), tl, ul)
    r_args = (_t(lpb), _t(lpe), r_ref[1], tl, ul, r_ref[0], g)
    c_out = p_ctc_dp.ctc_dp_fwd(emit, skip, _t(ctl), _t(cul))
    c_ref = p_ctc_dp.ctc_dp_plain_fwd(emit, skip, _t(ctl), _t(cul))
    c_args = (emit, skip, c_ref[1], _t(ctl), _t(cul), c_ref[0], g)
    j_in = (_t(enc), _t(pred), _t(w), _t(b), lab)
    j_out = p_joint.joint_lattice_fwd(*j_in, 0)
    j_ref = p_joint.joint_lattice_plain_fwd(*j_in, 0)
    j_args = (*j_in, j_ref[2], gb, ge, 0)
    pairs = [(s_out, s_ref), (s_bwd, s_bwd_ref), (r_out, r_ref),
             (p_lat.rnnt_lattice_bwd(*r_args), p_lat.rnnt_lattice_plain_bwd(*r_args)),
             (c_out, c_ref), ((p_ctc_dp.ctc_dp_bwd(*c_args),), (p_ctc_dp.ctc_dp_plain_bwd(*c_args),)),
             (j_out, j_ref),
             (p_joint.joint_lattice_bwd_xp(*j_args), p_joint.joint_lattice_plain_bwd_xp(*j_args)),
             (p_joint.joint_lattice_bwd_w(*j_args), p_joint.joint_lattice_plain_bwd_w(*j_args)),
             ((p_fbank.fbank_kernel(wave, dither=1.0, seed=3),),
              (p_fbank.fbank_plain(wave, dither=1.0, seed=3),))]
    for got, want in pairs:
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert [w.launches for w in wrappers] == before


# -------------------------------------------------------------- pruned loss


def test_prune_bounds_match_jax_as_integers():
    rng = np.random.default_rng(13)
    u1 = 9
    occ = rng.random((6, T, u1)).astype(np.float32)
    occ[1, 5:20] = 0.0
    occ[1, 5:20, 8] = 1.0                           # an early jump to the top
    occ[4] = 0.0
    occ[4, :, 0] = 1.0                              # never moves: the terminal forces it
    tl = np.array([37, 30, 1, 2, 20, 37], np.int32)
    ul = np.array([8, 3, 0, 8, 8, 5], np.int32)
    for s_range in (2, 4, 5, 9):
        want = j_pruned.prune_bounds_from_occupancy(jnp.asarray(occ), jnp.asarray(tl),
                                                    jnp.asarray(ul), s_range)
        got = p_pruned.prune_bounds_from_occupancy(_t(occ), _t(tl), _t(ul), s_range)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_rnnt_loss_pruned_full_matches_jax(impl):
    s_range = 4
    am, lm, enc, pred, w, b, labels, tl, ul = _pruned_inputs(14)
    jimpl = "pallas" if impl == "kernel" else "xla"
    jx = [jnp.asarray(a) for a in (am, lm, enc, pred, w, b)]

    def j_fn(*xs):
        s, p = j_pruned.rnnt_loss_pruned_full(
            *xs, jnp.asarray(labels), jnp.asarray(tl), jnp.asarray(ul), s_range=s_range,
            lattice_impl=jimpl, simple_impl=jimpl, t_chunk=16)
        return jnp.sum(jnp.asarray(W) * (p + 0.5 * s)), (s, p)

    j_g, (j_s, j_p) = jax.grad(j_fn, argnums=tuple(range(6)), has_aux=True)(*jx)
    j_sb, j_occ = _j_s_begin(am, lm, labels, tl, ul, s_range)

    tx = [_t(a, True) for a in (am, lm, enc, pred, w, b)]
    s, p, s_begin = p_pruned.rnnt_loss_pruned_full(
        *tx, _t(labels), _t(tl), _t(ul), s_range=s_range, lattice_impl=impl,
        simple_impl=impl, t_chunk=16)
    (_t(W) * (p + 0.5 * s)).sum().backward()
    np.testing.assert_array_equal(s_begin.numpy(), np.asarray(j_sb))
    # the occupancies behind the band: exp(alpha + lp + beta - logZ) with
    # logZ ~ 200 here, so float32 leaves ~1e-5 of absolute noise (JAX's own
    # XLA and Pallas paths differ by 1.3e-5 on these inputs); an argmax
    # can flip only between cells closer than that
    with torch.no_grad():
        lpb, lpe = p_pruned.simple_lattice_log_probs(*(_t(a) for a in (am, lm, labels)))
    lpb.requires_grad_()
    (occ,) = torch.autograd.grad(p_rnnt._lattice_nll(lpb, lpe, _t(tl), _t(ul), impl).sum(), lpb)
    _close(-occ, j_occ, rtol=0)
    _close(s, j_s)
    _close(p, j_p)
    for got, want in zip(tx, j_g):
        _close(got.grad, want)


def test_rnnt_loss_pruned_given_bounds_and_full_band_equals_full_loss():
    """Fed JAX's own band starts, the band loss matches JAX's; with a band
    as wide as the lattice it equals the full-lattice loss."""
    am, lm, enc, pred, w, b, labels, tl, ul = _pruned_inputs(15)
    j_sb, _ = _j_s_begin(am, lm, labels, tl, ul, 3)
    jx = [jnp.asarray(a) for a in (enc, pred, w, b)]

    def j_fn(*xs):
        nll = j_pruned.rnnt_loss_pruned(*xs, jnp.asarray(labels), j_sb, jnp.asarray(tl),
                                        jnp.asarray(ul), 3, t_chunk=16)
        return jnp.sum(jnp.asarray(W) * nll), nll

    j_g, j_nll = jax.grad(j_fn, argnums=(0, 1, 2, 3), has_aux=True)(*jx)
    tx = [_t(a, True) for a in (enc, pred, w, b)]
    nll = p_pruned.rnnt_loss_pruned(*tx, _t(labels), _t(np.asarray(j_sb)).long(), _t(tl),
                                    _t(ul), 3, t_chunk=16)
    (_t(W) * nll).sum().backward()
    _close(nll, j_nll)
    for got, want in zip(tx, j_g):
        _close(got.grad, want)

    full = p_rnnt.rnnt_loss_fused(*(_t(a) for a in (enc, pred, w, b)), _t(labels), _t(tl),
                                  _t(ul), reduction="none", t_chunk=8)
    wide = p_pruned.rnnt_loss_pruned(*(_t(a) for a in (enc, pred, w, b)), _t(labels),
                                     torch.zeros(B, T, dtype=torch.long), _t(tl), _t(ul), U + 1)
    _close(wide, full)


@pytest.mark.parametrize("impl,joint", [("plain", "plain"), ("kernel", "plain"),
                                        ("plain", "kernel"), ("kernel", "kernel")],
                         ids=["plain", "kernel", "plain-joint_kernel", "kernel-joint_kernel"])
def test_rnnt_loss_fused_matches_jax(impl, joint):
    """The lattice DP (``impl``) and the joint (``joint``: the chunked plain
    joint, or the joint kernels' path, JAX's joint_impl="pallas" with its
    kernel in interpret mode at small tiles)."""
    _, _, enc, pred, w, b, labels, tl, ul = _pruned_inputs(16)
    jx = [jnp.asarray(a) for a in (enc, pred, w, b)]
    jimpl = "pallas" if impl == "kernel" else "xla"
    jjoint = "pallas" if joint == "kernel" else "xla"

    def j_fn(*xs):
        nll = j_rnnt.rnnt_loss_fused(*xs, jnp.asarray(labels), jnp.asarray(tl), jnp.asarray(ul),
                                     reduction="none", t_chunk=8, lattice_impl=jimpl,
                                     joint_impl=jjoint)
        return jnp.sum(jnp.asarray(W) * nll), nll

    small = functools.partial(jk.joint_lattice_log_probs_pallas, t_tile=8, v_tile=128,
                              v_tile_bwd=128, interpret=True)
    with mock.patch.object(jk, "joint_lattice_log_probs_pallas", small):
        j_g, j_nll = jax.grad(j_fn, argnums=(0, 1, 2, 3), has_aux=True)(*jx)
    tx = [_t(a, True) for a in (enc, pred, w, b)]
    nll = p_rnnt.rnnt_loss_fused(*tx, _t(labels), _t(tl), _t(ul), reduction="none", t_chunk=8,
                                 lattice_impl=impl, joint_impl=joint)
    (_t(W) * nll).sum().backward()
    _close(nll, j_nll)
    for got, want in zip(tx, j_g):
        _close(got.grad, want)


# ------------------------------------------------------- losses from logits


def test_ctc_loss_from_logits_matches_jax():
    rng = np.random.default_rng(21)
    logits = (3 * rng.standard_normal((3, 17, 11))).astype(np.float32)
    t_lens = np.array([17, 9, 1], np.int32)
    labels = rng.integers(1, 11, (3, 4)).astype(np.int32)
    u_lens = np.array([4, 2, 0], np.int32)
    want = j_ctc.ctc_loss_from_logits(*(jnp.asarray(a) for a in (logits, t_lens, labels, u_lens)))
    got = p_ctc.ctc_loss_from_logits(*(torch.from_numpy(a) for a in (logits, t_lens, labels,
                                                                      u_lens)))
    _close(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_rnnt_loss_from_logits_matches_jax(reduction, impl):
    """``lattice_impl="kernel"`` (JAX's "pallas", its kernel in interpret
    mode; the port's wrapper takes its plain version on the CPU) and
    "plain" (JAX's "xla"); logits [B, T, U+1, V]."""
    rng = np.random.default_rng(22)
    logits = (2 * rng.standard_normal((3, 7, 5, 9))).astype(np.float32)
    labels = rng.integers(1, 9, (3, 4)).astype(np.int32)
    t_lens = np.array([7, 4, 1], np.int32)
    u_lens = np.array([4, 1, 0], np.int32)
    j_impl = {"plain": "xla", "kernel": "pallas"}[impl]
    want = j_rnnt.rnnt_loss(*(jnp.asarray(a) for a in (logits, labels, t_lens, u_lens)),
                            reduction=reduction, lattice_impl=j_impl)
    x = _t(logits, grad=True)
    got = p_rnnt.rnnt_loss(x, *(torch.from_numpy(a) for a in (labels, t_lens, u_lens)),
                           reduction=reduction, lattice_impl=impl)
    _close(got, want)
    assert got.shape == tuple(np.shape(want))
    got.sum().backward()
    j_grad = jax.grad(lambda z: j_rnnt.rnnt_loss(
        z, *(jnp.asarray(a) for a in (labels, t_lens, u_lens)), reduction=reduction,
        lattice_impl=j_impl).sum())(jnp.asarray(logits))
    _close(x.grad, j_grad)
