"""The port's loss tests, part three: the wrappers' CPU dispatch, the pruned
loss, the fused joint losses and the losses from logits. Each kernel's
plain version and the losses around it, against the JAX package: its
Pallas kernels (interpret mode on the CPU) and its XLA oracles, forward
and ``jax.grad``.

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
from conformer_tpu.ops import rnnt_pruned as j_pruned
from conformer_tpu.ops.pallas import joint_kernel as jk
from conformer_tpu_torch.ops import ctc as p_ctc
from conformer_tpu_torch.ops import ctc_dp as p_ctc_dp
from conformer_tpu_torch.ops import fbank_kernel as p_fbank
from conformer_tpu_torch.ops import joint_lattice as p_joint
from conformer_tpu_torch.ops import rnnt as p_rnnt
from conformer_tpu_torch.ops import rnnt_lattice as p_lat
from conformer_tpu_torch.ops import rnnt_pruned as p_pruned
from conformer_tpu_torch.ops import simple_lattice as p_simple

from torch_losses_common import (
    B, CTC_LENGTHS, LENGTHS, T, U, W, _close, _ctc_inputs, _j_s_begin, _lattice, _pruned_inputs,
    _simple_inputs, _t,
)


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
