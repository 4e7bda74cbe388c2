"""The port's loss tests, part one: the RNN-T lattice DP and the simple
lattice. Each kernel's plain version and the losses around it, against the
JAX package: its Pallas kernels (interpret mode on the CPU) and its XLA
oracles, forward and ``jax.grad``.

Tiny shapes that no tile divides (B=3, T=37, U=6, V=37), float32 on both
sides, inputs from a seeded numpy generator. Tolerance 1e-4 abs and rel
unless a test says otherwise: both sides compute in float32 with sums in
different orders. The loss tests are three files so that
``--dist loadfile`` spreads them over workers; their helpers are in
``tests/torch_losses_common.py``.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conformer_tpu.ops import rnnt as j_rnnt
from conformer_tpu.ops import rnnt_pruned as j_pruned
from conformer_tpu.ops.pallas.rnnt_kernel import rnnt_loss_from_log_probs_pallas
from conformer_tpu.ops.pallas.simple_lattice_kernel import simple_lattice_log_probs_pallas
from conformer_tpu_torch.ops import rnnt as p_rnnt
from conformer_tpu_torch.ops import rnnt_lattice as p_lat
from conformer_tpu_torch.ops import rnnt_pruned as p_pruned
from conformer_tpu_torch.ops import simple_lattice as p_simple

from torch_losses_common import (
    B, FACTORED_CASES, LENGTHS, T, U, W, WIDTHS, _close, _fast_torch, _float64_grad, _lattice,
    _lattice_case, _off_or_nonfinite, _simple_inputs, _sincos, _t,
)


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
