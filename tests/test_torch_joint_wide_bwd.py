"""The wide joint backward's arithmetic (``csrc/joint_lattice.cu``, "wide
route": float32 at every J, bf16 J > 512) emulated on the CPU against JAX's
``joint_lattice_log_probs_pallas`` VJP (its Pallas kernels in interpret
mode, at small tiles), and ``route`` against the C source's constants.

The emulation follows the kernels step for step where their arithmetic
differs from the plain version: J zero-padded to a multiple of 128; in
float32 every operand split into tf32 hi and lo by ``cvt.rna`` rounding
(emulated on the int32 bits) and each product summed as hi*hi + hi*lo +
lo*hi in float32; in bf16 dl rounded to bf16 as the second products'
operand; dW summed over chunks of cells into partials split over cells,
the partials then summed in order; dbias summed per tile of cells before
any rounding, the tiles in order. Inputs from seeded numpy generators at B=2,
T'=8, U+1=5, V=130 (no multiple of 64), J 640, 896 and 1024, and float32's
J 512 (a shipped width: float32 has no narrow kernels).

Tolerances: float32 1e-4 abs and rel (both sides sum in float32 in other
orders; 3xTF32 keeps ~2^-22 of each term); bf16 2e-2 of each output's
max-abs, the rule of chip_smoke.py's phase 3 for the bf16 backward (the
kernels round dl to bf16, 2^-9 relative per term, which JAX's kernel
keeps in float32).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.ops.pallas import joint_kernel as jk
from conformer_tpu_torch.ops import joint_lattice as p_joint
from torch_joint_common import joint_inputs, product, split, tf32_rna

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_SHARE = 2e-2
CASES = [(j, dt) for j in (640, 896, 1024) for dt in ("float32", "bfloat16")] + [(512, "float32")]


def emulated_bwd(enc, pred, w, bias, lab, logz, g_b, g_e, blank, chunk, n_split, tile):
    """(d enc, d pred, dW, dbias) of the wide backward: dl from the logits
    product's epilogue, dX = dl W^T with dpre = dX (1 - x^2) summed over u
    and t, dW = x^T dl over ``chunk`` cells at a time into ``n_split``
    partials, dbias per ``tile`` cells."""
    f32 = enc.dtype == torch.float32
    bsz, t, j0 = enc.shape
    u1, v = pred.shape[1], w.shape[1]
    enc, pred, w = p_joint.pad_join(enc, pred, w)
    j = enc.shape[2]
    x = torch.tanh(enc[:, :, None, :] + pred[:, None, :, :]).to(enc.dtype).float().reshape(-1, j)
    wf = w.to(enc.dtype).float()
    m = x.shape[0]
    logits = product(x, wf, f32) + bias.float()
    lz, gb, ge = (a.reshape(m, 1) for a in (logz, g_b.float(), g_e.float()))
    dl = -(gb + ge) * torch.exp(logits - lz)
    dl[:, blank] += gb[:, 0]
    labm = lab[:, None, :].expand(bsz, t, u1).reshape(m).long()
    ok = (labm >= 0) & (labm < v)
    dl[torch.arange(m)[ok], labm[ok]] += ge[ok, 0]
    dlo = dl if f32 else dl.to(torch.bfloat16).float()      # the second products' operand
    if f32:
        xh, xl = split(x)
        xs = xh + xl                                        # the dpre epilogue's x
    else:
        xs = x
    dpre = (product(dlo, wf.T, f32) * (1.0 - xs * xs)).reshape(bsz, t, u1, j)
    d_enc, d_pred = dpre.sum(dim=2), dpre.sum(dim=1)
    part = torch.zeros((n_split, j, v))
    for row0 in range(0, m, chunk):
        rows = min(chunk, m - row0)
        k_split = -(-rows // n_split)
        for z in range(n_split):
            sl = slice(row0 + z * k_split, row0 + min(rows, (z + 1) * k_split))
            part[z] += product(x[sl].T, dlo[sl], f32)
    dw = part[0].clone()
    for z in range(1, n_split):
        dw += part[z]
    db = torch.zeros(v)
    for r0 in range(0, m, tile):
        db += dl[r0:r0 + tile].sum(dim=0)
    return d_enc[..., :j0], d_pred[..., :j0], dw[:j0], db


@pytest.mark.parametrize("j,dt", CASES)
def test_wide_bwd_arithmetic_matches_pallas(j, dt):
    """d enc, d pred, dW and dbias of the emulated wide backward (several
    chunks and splits of the cells) against JAX's kernel VJP; the route
    takes J on the wide backward."""
    dtype = getattr(torch, dt)
    assert p_joint.route(dtype, j, "bwd") == "wide"
    enc, pred, w, bias, lab, g_b, g_e = joint_inputs(j, j)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    jx = (jnp.asarray(enc, jdt), jnp.asarray(pred), jnp.asarray(w), jnp.asarray(bias))
    jlab = jnp.asarray(lab)
    _, vjp = jax.vjp(lambda *a: jk.joint_lattice_log_probs_pallas(
        *a, jlab, 0, t_tile=8, v_tile=128, interpret=True), *jx)
    want = vjp((jnp.asarray(g_b), jnp.asarray(g_e)))
    t, u1 = enc.shape[1], pred.shape[1]
    logz = jk._forward(*jx, jlab, 0, 8, 128, True)[2][-1][:, :t, :u1]

    tx = (torch.from_numpy(enc).to(dtype), torch.from_numpy(pred), torch.from_numpy(w),
          torch.from_numpy(bias), torch.from_numpy(lab))
    got = emulated_bwd(*tx, torch.from_numpy(np.array(logz, np.float32)),
                       torch.from_numpy(g_b), torch.from_numpy(g_e), 0, chunk=48, n_split=3,
                       tile=16)
    for name, g, wnt in zip(("d_enc", "d_pred", "d_w", "d_bias"), got, want):
        wn = np.asarray(jnp.asarray(wnt, jnp.float32))
        gn = g.numpy()
        if dt == "float32":
            np.testing.assert_allclose(gn, wn, **F32_TOL, err_msg=name)
        else:
            err = np.abs(gn - wn).max()
            assert err <= BF16_SHARE * np.abs(wn).max(), (name, err, np.abs(wn).max())


def test_tf32_rna_rounds_to_nearest_ties_away():
    """The emulated cvt.rna: 10 mantissa bits kept, nearest, ties away from
    zero in magnitude, both signs; hi + lo within 2^-22 of x."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4, -(one + ulp / 2), 0.0],
                     dtype=torch.float32)
    got = tf32_rna(x).tolist()
    assert got == [one + ulp, one, one + ulp, -(one + ulp), 0.0]
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(1000).astype(np.float32) * 10)
    hi, lo = split(y)
    assert torch.all((hi + lo - y).abs() <= y.abs() * 2.0 ** -21)


def test_joint_route_is_the_c_sources():
    """The C entries take the narrow kernels for bf16 enc up to
    NARROW_FWD_J_BF16 (the forward) and NARROW_BWD_J_BF16 (the backward),
    the wide route above and for float32 at every J; ``route`` mirrors
    those constants by dtype and direction, J padded to 128."""
    src = (Path(p_joint.__file__).resolve().parents[1] / "csrc" / "joint_lattice.cu").read_text()
    got = re.search(r"constexpr int NARROW_FWD_J_BF16 = (\d+), NARROW_BWD_J_BF16 = (\d+);", src)
    fwd, bwd = (int(g) for g in got.groups())
    assert "bool fwd_narrow(int J, bool is_bf16) { return is_bf16 && J <= NARROW_FWD_J_BF16; }" \
        in src
    assert "bool bwd_narrow(int J, bool is_bf16) { return is_bf16 && J <= NARROW_BWD_J_BF16; }" \
        in src
    assert p_joint.NARROW_J == {"fwd": {torch.bfloat16: fwd}, "bwd": {torch.bfloat16: bwd}}
    for direction, edge in (("fwd", fwd), ("bwd", bwd)):
        assert [p_joint.route(torch.bfloat16, j, direction) for j in (1, edge - 1, edge, edge + 1,
                                                                       edge + 128, 4096)] \
            == ["narrow"] * 3 + ["wide"] * 3
        assert {p_joint.route(torch.float32, j, direction) for j in (1, 320, 512, 640, 4096)} \
            == {"wide"}
    assert p_joint.route(torch.bfloat16, 640) == "narrow"          # the forward by default
    assert p_joint.route(torch.bfloat16, 640, "bwd") == "wide"     # Conformer-L's backward


@pytest.mark.parametrize("m,vp,elem", [(194480, 5056, 2), (194480, 5056, 8), (80, 192, 8),
                                       (97240, 5056, 8)])
def test_wide_chunks_fit_the_kernels(m, vp, elem):
    """Cells per chunk: a multiple of the kernels' 128-row tile, dl within
    the scratch cap, at most M rounded up; the dW product's splits give at
    least the target blocks."""
    c = p_joint._wide_chunk(m, vp, elem)
    assert c % 128 == 0 and c <= -(-m // 128) * 128
    assert c == 128 or c * vp * elem <= p_joint._WIDE_DL_BYTES
    for j, f32 in ((640, True), (1024, False), (896, False)):
        n = p_joint._wide_splits(j, vp, f32)
        tiles = (j // 128) * -(-vp // (128 if f32 else 256))
        assert n >= 1 and n * tiles >= p_joint._BWD_W_BLOCKS
