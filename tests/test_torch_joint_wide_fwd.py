"""The wide joint forward's arithmetic (``csrc/joint_lattice.cu``, "wide
route": float32 at every J, bf16 J > 640) emulated on the CPU against JAX's
``joint_kernel._forward`` (its Pallas kernel in interpret mode, at small
tiles).

The emulation follows the kernels step for step where their arithmetic
differs from the plain version: J zero-padded to a multiple of 128; in
float32 both operands of the logits product split into tf32 hi and lo by
``cvt.rna`` rounding (emulated on the int32 bits) and the product summed
as hi*hi + hi*lo + lo*hi in float32; the logsumexp taken per V tile of the
product (128 columns in float32, 256 in bf16: each tile's max and its sum
of exps about that max, columns past V left out) and the tiles' (max, sum)
partials folded into logZ in tile order; the blank and label logits picked
from the product. Inputs from seeded numpy generators at B=2, T'=8,
U+1=5, V=130 (no multiple of 128: the last tile is ragged), J 640, 896 and
1024, and float32's J 512 (a shipped width: float32 has no narrow
kernels); bf16 also at V=600 (three V tiles to fold).

Tolerances: float32 1e-4 abs and rel (both sides sum in float32 in other
orders; 3xTF32 keeps ~2^-22 of each term); bf16 2e-2 of each output's
max-abs (the rule of chip_smoke.py's phase 3 for bf16 outputs: x and W
are bf16 on both sides, and the two sides' float32 tanh may round x to
different bf16 neighbours).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.ops.pallas import joint_kernel as jk
from conformer_tpu_torch.ops import joint_lattice as p_joint
from torch_joint_common import joint_inputs, product

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_SHARE = 2e-2
CASES = ([(j, dt, 130) for j in (640, 896, 1024) for dt in ("float32", "bfloat16")]
         + [(512, "float32", 130), (1024, "bfloat16", 600)])


def emulated_fwd(enc, pred, w, bias, lab, blank):
    """(lp_blank, lp_emit, logZ) [B, T', U+1] of the wide forward: the
    logits product, per-V-tile (max, sum of exps) partials, folded in tile
    order; the tile count and width the wrapper gives the kernel."""
    f32 = enc.dtype == torch.float32
    bsz, t, _ = enc.shape
    u1, v = pred.shape[1], w.shape[1]
    enc, pred, w = p_joint.pad_join(enc, pred, w)
    j = enc.shape[2]
    x = torch.tanh(enc[:, :, None, :] + pred[:, None, :, :]).to(enc.dtype).float().reshape(-1, j)
    m = x.shape[0]
    logits = product(x, w.to(enc.dtype).float(), f32) + bias.float()
    vp = -(-v // p_joint._FWD_V_TILE) * p_joint._FWD_V_TILE
    n_tiles, bn = p_joint.fwd_tiles(vp, f32), 128 if f32 else 256
    pmax, psum = [], []
    for k in range(n_tiles):
        tile = logits[:, k * bn:min((k + 1) * bn, v)]
        assert tile.shape[1] > 0          # every tile holds a column below V
        mx = tile.max(dim=1).values
        pmax.append(mx)
        psum.append(torch.exp(tile - mx[:, None]).sum(dim=1))
    mx = torch.stack(pmax).max(dim=0).values
    s = torch.zeros(m)
    for k in range(n_tiles):
        s = s + psum[k] * torch.exp(pmax[k] - mx)
    logz = mx + torch.log(s)
    labm = lab[:, None, :].expand(bsz, t, u1).reshape(m).long()
    ok = (labm >= 0) & (labm < v)
    em = torch.where(ok, logits[torch.arange(m), torch.where(ok, labm, 0)], 0.0)
    return tuple(a.reshape(bsz, t, u1) for a in (logits[:, blank] - logz, em - logz, logz))


@pytest.mark.parametrize("j,dt,v", CASES)
def test_wide_fwd_arithmetic_matches_pallas(j, dt, v):
    """lp_blank, lp_emit and logZ of the emulated wide forward against JAX's
    kernel, over several V tiles in float32 and at V=600 in bf16; the route
    takes J on the wide forward but at bf16 J 640, which the narrow kernel
    keeps (its arithmetic is held here all the same: the wide C entry takes
    it, as the width timings run it)."""
    dtype = getattr(torch, dt)
    assert p_joint.route(dtype, j) == ("narrow" if (j, dt) == (640, "bfloat16") else "wide")
    enc, pred, w, bias, lab, _, _ = joint_inputs(j, j + v, v=v)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    jx = (jnp.asarray(enc, jdt), jnp.asarray(pred), jnp.asarray(w), jnp.asarray(bias))
    t, u1 = enc.shape[1], pred.shape[1]
    lpb, lpe, res = jk._forward(*jx, jnp.asarray(lab), 0, 8, 128, True)
    want = (lpb, lpe, res[-1][:, :t, :u1])

    tx = (torch.from_numpy(enc).to(dtype), torch.from_numpy(pred), torch.from_numpy(w),
          torch.from_numpy(bias), torch.from_numpy(lab))
    got = emulated_fwd(*tx, 0)
    for name, g, wnt in zip(("lp_blank", "lp_emit", "logZ"), got, want):
        wn = np.asarray(wnt, np.float32)
        gn = g.numpy()
        if dt == "float32":
            np.testing.assert_allclose(gn, wn, **F32_TOL, err_msg=name)
        else:
            err = np.abs(gn - wn).max()
            assert err <= BF16_SHARE * np.abs(wn).max(), (name, err, np.abs(wn).max())


def test_wide_fwd_fold_is_the_plain_logsumexp():
    """The tile fold is exact arithmetic of logsumexp: at float32 J 512 and
    V 5002 (40 tiles of 128), with logits tens of nats apart across tiles,
    the emulation's logZ equals the plain version's within float32 rounding;
    the wrapper's tile counts: 40 of 128 columns in float32, 20 of 256 in
    bf16 at Vp 5120."""
    rng = np.random.default_rng(11)
    enc, pred, w, bias, lab, _, _ = joint_inputs(512, 11, v=5002)
    bias = (bias + 30.0 * (rng.random(5002) < 0.01)).astype(np.float32)   # a few tiles lead
    tx = (torch.from_numpy(enc), torch.from_numpy(pred), torch.from_numpy(w),
          torch.from_numpy(bias), torch.from_numpy(lab))
    got = emulated_fwd(*tx, 0)
    want = p_joint.joint_lattice_plain_fwd(*tx, 0)
    for g, wn in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wn.numpy(), rtol=1e-5, atol=1e-4)
    assert p_joint.fwd_tiles(5120, True) == 40 and p_joint.fwd_tiles(5120, False) == 20
