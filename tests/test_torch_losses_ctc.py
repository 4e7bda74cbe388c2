"""The port's loss tests, part two: the CTC DP, and both DPs at long labels
and at large log Z. Each kernel's plain version and the losses around it,
against the JAX package: its Pallas kernels (interpret mode on the CPU)
and its XLA oracles, forward and ``jax.grad``.

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

from conformer_tpu.ops import ctc as j_ctc
from conformer_tpu.ops import rnnt as j_rnnt
from conformer_tpu.ops.pallas.ctc_kernel import ctc_loss_pallas
from conformer_tpu_torch.ops import ctc as p_ctc
from conformer_tpu_torch.ops import ctc_dp as p_ctc_dp
from conformer_tpu_torch.ops import rnnt_lattice as p_lat

from torch_losses_common import (
    B, CTC_LENGTHS, T, V, W, _close, _ctc_inputs, _fast_torch, _float64_grad, _t,
)


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
