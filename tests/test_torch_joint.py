"""The port's full-lattice joint and fbank kernels' plain versions, and what
this slice touches around them, against the JAX package on the CPU:

- ``ops/joint_lattice.py``: the plain forward against JAX's Pallas kernel
  ``joint_lattice_log_probs_pallas`` (interpret mode, t_tile 8, v_tile 128)
  and its XLA oracle ``rnnt_lattice_log_probs_fused``, the written-out
  backward against ``jax.vjp`` of the kernel;
- ``transducer_forward`` with the full-lattice loss and ``use_pallas_joint``;
- the bf16 joint of ``ops/rnnt.py`` (``joint_log_probs_chunk``: float32
  sums, as JAX's ``preferred_element_type``), full lattice and pruned band;
- ``train/flops.py`` against JAX's, exactly;
- ``ops/fbank_kernel.py``'s plain version against JAX's ``fbank_pallas``
  (interpret mode) and ``fbank_jax``, and its dither.

Inputs from seeded numpy generators; tolerances per test.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import transducer as j_tr
from conformer_tpu.ops import fbank as j_fbank
from conformer_tpu.ops import rnnt as j_rnnt
from conformer_tpu.ops import rnnt_pruned as j_pruned
from conformer_tpu.ops.pallas import joint_kernel as jk
from conformer_tpu.ops.pallas.fbank_kernel import fbank_pallas
from conformer_tpu.train import flops as j_flops
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.models import transducer as p_tr
from conformer_tpu_torch.ops import fbank_kernel as p_fbank
from conformer_tpu_torch.ops import joint_lattice as p_joint
from conformer_tpu_torch.ops import rnnt as p_rnnt
from conformer_tpu_torch.ops import rnnt_pruned as p_pruned
from conformer_tpu_torch.ops.fbank import fbank_numpy
from conformer_tpu_torch.params import from_jax_params
from conformer_tpu_torch.train import flops as p_flops
from conformer_tpu_torch.train.optimizer import leaf_paths

# (B, T, U, J, V): T and U+1 that the kernel's tiles (8 t, 128 u) divide
# and do not, V below and above one 128 tile, an utterance of one frame
# with no label, a J that the CUDA kernels take only after padding
SHAPES = {
    "divisible": (2, 16, 7, 16, 128),
    "ragged": (3, 13, 6, 8, 45),
    "edges": (2, 1, 0, 16, 130),
    "j40": (2, 9, 4, 40, 70),   # J a multiple of neither 16 nor 128 (the kernels pad it)
}
# bf16, plain version vs the TPU kernel: both round x and W to bf16 and sum
# in float32, so they differ only where XLA's and PyTorch's float32 tanh
# round a bf16 value the other way (one bf16 step of x moves a logit by
# ~|w| 2^-8)
BF16_FWD_TOL = dict(rtol=0, atol=2e-3)
# (enc dtype, pred dtype): float32; bf16 both; the model's mixed case (bf16
# enc, float32 pred: the sum in float32, x rounded to bf16)
DTYPES = {"float32": ("float32", "float32"), "bfloat16": ("bfloat16", "bfloat16"),
          "mixed": ("bfloat16", "float32")}


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _joint_inputs(case, seed=0):
    b, t, u, j, v = SHAPES[case]
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, j)).astype(np.float32)
    pred = rng.standard_normal((b, u + 1, j)).astype(np.float32)
    w = (0.3 * rng.standard_normal((j, v))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    return enc, pred, w, bias, labels


def _pallas(enc, pred, w, bias, lab):
    return jk.joint_lattice_log_probs_pallas(enc, pred, w, bias, lab, 0, t_tile=8, v_tile=128,
                                             interpret=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_joint_plain_fwd_matches_pallas_and_xla(case, dtype):
    """Against the TPU kernel, and against the XLA oracle where that rounds
    alike (in the mixed case the oracle keeps x in float32)."""
    enc, pred, w, bias, labels = _joint_inputs(case)
    lab = np.pad(labels, ((0, 0), (0, 1)))
    dts = DTYPES[dtype]
    jx = [jnp.asarray(a, d) for a, d in zip((enc, pred), dts)] + [jnp.asarray(w),
                                                                  jnp.asarray(bias)]
    want = _pallas(*jx, jnp.asarray(lab))
    # the TPU kernel's saved logZ (its forward's residuals, padded)
    logz = jk._forward(*jx, jnp.asarray(lab), 0, 8, 128, True)[2][-1][:, :enc.shape[1], :lab.shape[1]]
    oracle = j_rnnt.rnnt_lattice_log_probs_fused(*jx, jnp.asarray(labels), 0, t_chunk=8)
    tx = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip((enc, pred), dts)]
    got = p_joint.joint_lattice_plain_fwd(*tx, torch.from_numpy(w), torch.from_numpy(bias),
                                          torch.from_numpy(lab), 0)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_FWD_TOL
    for g, p, o in zip(got[:2], want, oracle):
        np.testing.assert_allclose(_np(g), _np(p), **tol)
        if dtype != "mixed":
            np.testing.assert_allclose(_np(g), _np(o), **tol)
    np.testing.assert_allclose(_np(got[2]), _np(logz), **tol)


@pytest.mark.parametrize("dtype", ["float32", "mixed"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_joint_plain_bwd_matches_pallas_vjp(case, dtype):
    """All four gradients of sum(g_b lp_blank + g_e lp_emit), 1e-4 (in the
    mixed case, x's bf16 rounding as BF16_FWD_TOL says, 2e-3, and d enc in
    bf16, one bf16 step)."""
    enc, pred, w, bias, labels = _joint_inputs(case, seed=1)
    lab = np.pad(labels, ((0, 0), (0, 1)))
    rng = np.random.default_rng(2)
    b, t, u = enc.shape[0], enc.shape[1], pred.shape[1]
    g_b, g_e = (rng.standard_normal((b, t, u)).astype(np.float32) for _ in range(2))
    dts = DTYPES[dtype]
    _, vjp = jax.vjp(lambda *a: _pallas(*a, jnp.asarray(lab)),
                     *(jnp.asarray(a, d) for a, d in zip((enc, pred), dts)),
                     jnp.asarray(w), jnp.asarray(bias))
    want = vjp((jnp.asarray(g_b), jnp.asarray(g_e)))
    tx = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip((enc, pred), dts)]
    tx += [torch.from_numpy(a) for a in (w, bias)]
    lab_t = torch.from_numpy(lab)
    _, _, logz = p_joint.joint_lattice_plain_fwd(*tx, lab_t, 0)
    args = (*tx, lab_t, logz, torch.from_numpy(g_b), torch.from_numpy(g_e), 0)
    got = (*p_joint.joint_lattice_plain_bwd_xp(*args), *p_joint.joint_lattice_plain_bwd_w(*args))
    got = (got[0].to(tx[0].dtype), *got[1:])               # JAX returns d enc in enc's dtype
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=1e-2, atol=2e-3)
    for name, g, wnt in zip(("d_enc", "d_pred", "d_w", "d_bias"), got, want):
        np.testing.assert_allclose(_np(g), _np(wnt), **tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "mixed"])
@pytest.mark.parametrize("j", [40, 320])
def test_pad_join_is_exact(j, dtype):
    """The CUDA wrappers zero-pad J to a multiple of 128 (``pad_join``): each
    plain version on padded inputs, sliced back, equals it on the unpadded
    ones, and the padded parts of d enc, d pred and dW are exactly 0. Equal
    up to the float32 summation order of the CPU's matrix product, which
    blocks a longer J otherwise (4.8e-6 at J = 320 here; bit for bit at
    J = 40): 1e-5 abs and rel."""
    rng = np.random.default_rng(7)
    b, t, u, v = 2, 5, 3, 37
    dts = DTYPES[dtype]
    enc, pred = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(getattr(torch, d))
                 for s, d in zip(((b, t, j), (b, u + 1, j)), dts))
    w = torch.from_numpy((0.3 * rng.standard_normal((j, v))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(v)).astype(np.float32))
    lab = torch.from_numpy(np.pad(rng.integers(1, v, (b, u)), ((0, 0), (0, 1))).astype(np.int32))
    g = [torch.from_numpy(rng.standard_normal((b, t, u + 1)).astype(np.float32)) for _ in range(2)]
    padded = p_joint.pad_join(enc, pred, w)
    jp = padded[0].shape[-1]
    assert jp % p_joint.J_TILE == 0 and jp - j < p_joint.J_TILE
    assert [x.dtype for x in padded] == [enc.dtype, pred.dtype, w.dtype]
    tol = dict(rtol=1e-5, atol=1e-5)
    want = p_joint.joint_lattice_plain_fwd(enc, pred, w, bias, lab, 0)
    got = p_joint.joint_lattice_plain_fwd(*padded, bias, lab, 0)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), wt.numpy(), **tol)
    args = (bias, lab, want[2], *g, 0)
    for fn in (p_joint.joint_lattice_plain_bwd_xp, p_joint.joint_lattice_plain_bwd_w):
        want_g = fn(enc, pred, w, *args)
        got_g = fn(*padded, *args)
        for name, gt, wt in zip(("first", "second"), got_g, want_g):
            if gt.shape == wt.shape:      # dbias: no J axis
                np.testing.assert_allclose(gt.numpy(), wt.numpy(), **tol, err_msg=name)
                continue
            axis = 0 if fn is p_joint.joint_lattice_plain_bwd_w else -1
            kept, rest = gt.split([j, jp - j], dim=axis)
            np.testing.assert_allclose(kept.numpy(), wt.numpy(), **tol, err_msg=name)
            assert not rest.any(), f"{fn.__name__} {name}: padded part not zero"


def _port_model(model_cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(model_cfg)}).model


def test_transducer_forward_full_lattice_joint_kernel_matches_jax():
    """use_pruned_loss False, use_pallas_joint True: losses and every
    gradient leaf against JAX (its joint kernel in interpret mode at small
    tiles), f32, 1e-4."""
    cfg = dataclasses.replace(tiny_test_config().model, use_pruned_loss=False,
                              use_pallas_joint=True)
    jp = j_tr.init_transducer(jax.random.PRNGKey(7), cfg)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((3, 45, cfg.input_dim)).astype(np.float32)
    feat_lens = np.array([45, 30, 0], np.int32)                 # row 2: bucket padding
    label_lens = np.array([4, 2, 0], np.int32)
    labels = rng.integers(1, cfg.vocab_size - 1, (3, 4)).astype(np.int32)
    labels = np.where(np.arange(4)[None, :] < label_lens[:, None], labels, 0).astype(np.int32)
    batch = (feats, feat_lens, labels, label_lens)

    def j_loss(p):
        out = j_tr.transducer_forward(p, *(jnp.asarray(a) for a in batch), cfg,
                                      deterministic=True)
        return out["loss"], out

    small = functools.partial(jk.joint_lattice_log_probs_pallas, t_tile=8, v_tile=128,
                              v_tile_bwd=128, interpret=True)
    with mock.patch.object(jk, "joint_lattice_log_probs_pallas", small):
        j_g, j_out = jax.jit(jax.grad(j_loss, has_aux=True))(jp)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    for leaf in dict(leaf_paths(pp)).values():
        leaf.requires_grad_(True)
    launches = p_joint.joint_lattice_fwd.launches
    out = p_tr.transducer_forward(pp, *(torch.from_numpy(a) for a in batch), _port_model(cfg),
                                  deterministic=True)
    out["loss"].backward()
    assert p_joint.joint_lattice_fwd.launches == launches        # the plain version on the CPU
    for k in ("loss", "loss_ctc", "loss_rnnt"):
        np.testing.assert_allclose(_np(out[k]), _np(j_out[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    want = dict(leaf_paths(from_jax_params(jax.tree.map(np.asarray, j_g), "cpu")))
    got = dict(leaf_paths(pp))
    assert set(got) == set(want)
    for k, leaf in got.items():
        np.testing.assert_allclose(_np(leaf.grad), _np(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


# ------------------------------------------------------ the bf16 joint repair

# The joint's logits keep float32 sums in bf16 (JAX: preferred_element_type
# float32). A product rounded to bf16 differs from JAX on these inputs
# (logits of a few units) by 2.4e-2 (full lattice) and 4.8e-2 in an NLL
# (band); float32 sums by 1.9e-6 and 0.
REPAIR_TOL = dict(rtol=0, atol=1e-3)


def _repair_inputs():
    rng = np.random.default_rng(3)
    b, t, u, j, v = 2, 20, 8, 128, 257
    enc = rng.standard_normal((b, t, j)).astype(np.float32)
    pred = rng.standard_normal((b, u + 1, j)).astype(np.float32)
    w = (0.3 * rng.standard_normal((j, v))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    return enc, pred, w, bias, labels, np.array([20, 13], np.int32), np.array([8, 5], np.int32)


def test_joint_chunk_bf16_keeps_float32_sums_like_jax():
    enc, pred, w, bias, labels, _, _ = _repair_inputs()
    want = j_rnnt.rnnt_lattice_log_probs_fused(
        jnp.asarray(enc, jnp.bfloat16), jnp.asarray(pred, jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(labels), 0, 8)
    got = p_rnnt.rnnt_lattice_log_probs_fused(
        torch.from_numpy(enc).bfloat16(), torch.from_numpy(pred).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(bias), torch.from_numpy(labels), 0, 8)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(wnt), **REPAIR_TOL)


def test_pruned_band_loss_bf16_matches_jax():
    enc, pred, w, bias, labels, tl, ul = _repair_inputs()
    rng = np.random.default_rng(4)
    s_begin = np.clip(np.cumsum(rng.integers(0, 2, (2, 20)), axis=1) - 1, 0, None)
    s_begin = np.minimum(s_begin, np.maximum(ul[:, None] - 2, 0)).astype(np.int64)
    want = j_pruned.rnnt_loss_pruned(
        jnp.asarray(enc, jnp.bfloat16), jnp.asarray(pred, jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(labels), jnp.asarray(s_begin, jnp.int32), jnp.asarray(tl),
        jnp.asarray(ul), 3, t_chunk=8)
    got = p_pruned.rnnt_loss_pruned(
        torch.from_numpy(enc).bfloat16(), torch.from_numpy(pred).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(bias), torch.from_numpy(labels), torch.from_numpy(s_begin),
        torch.from_numpy(tl), torch.from_numpy(ul), 3, t_chunk=8)
    np.testing.assert_allclose(_np(got), _np(want), **REPAIR_TOL)


# ------------------------------------------------------------------ flops


@pytest.mark.parametrize("pruned", [True, False])
@pytest.mark.parametrize("name", ["conformer_s", "conformer_m", "conformer_l"])
def test_flops_equal_jax(name, pruned):
    path = f"configs/{name}.json"
    jm = dataclasses.replace(JConfig.from_json_file(path).model, use_pruned_loss=pruned)
    pm = dataclasses.replace(PConfig.from_json_file(path).model, use_pruned_loss=pruned)
    for batch, frames, u in ((24, 1500, 64), (3, 417, 5)):
        assert p_flops.transducer_step_flops(pm, batch, frames, u) == \
            j_flops.transducer_step_flops(jm, batch, frames, u)
        assert p_flops.encoder_flops(pm, batch, frames) == j_flops.encoder_flops(jm, batch, frames)
    assert p_flops.subsampled_len(1500) == j_flops.subsampled_len(1500) == 374


# ------------------------------------------------------------------ fbank


def _tones(n=8000):
    t = np.arange(n) / 16000.0
    w = np.stack([0.4 * np.sin(2 * np.pi * 700 * t), 0.2 * np.sin(2 * np.pi * 2500 * t)])
    w[1] += 0.01 * np.random.default_rng(5).standard_normal(n)
    return (w * (1 << 15)).astype(np.float32)


# the DFT as products against the same cos / sin matrices, float32 sums in
# other orders; fbank_numpy (an FFT) within the JAX test's own tolerance
FBANK_TOL = dict(rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("n", [8000, 7000])     # 49 and 42 frames: 16 divides neither
def test_fbank_plain_matches_pallas_and_jax(n):
    wavs = _tones(n)
    got = p_fbank.fbank_kernel(torch.from_numpy(wavs)).numpy()       # CPU: the plain version
    pal = np.asarray(fbank_pallas(jnp.asarray(wavs), dither=0.0, interpret=True))
    assert got.shape == pal.shape == (2, 1 + (n - 400) // 160, 80)
    np.testing.assert_allclose(got, pal, **FBANK_TOL)
    np.testing.assert_allclose(got, np.asarray(j_fbank.fbank_jax(jnp.asarray(wavs))), **FBANK_TOL)
    host = np.stack([fbank_numpy(w) for w in wavs])
    np.testing.assert_allclose(got, host, rtol=1e-3, atol=0.15)


def test_fbank_dither_statistics_and_seed():
    """The dither's normals are standard (mean 0, sd 1 over 120,000 draws,
    sd of the mean 0.003); the same seed gives the same features, two seeds
    differ, and loud bins stay within 0.5 of the clean features (the TPU
    kernel's test, tests/test_pallas_fbank.py)."""
    z = p_fbank.dither_normal(3, 2, 150, 400, "cpu")
    assert abs(float(z.mean())) < 0.015 and abs(float(z.std()) - 1.0) < 0.015
    assert abs(float((z.abs() > 1.96).float().mean()) - 0.05) < 0.004
    wav = torch.from_numpy(_tones())
    clean = p_fbank.fbank_kernel(wav).numpy()
    a, a2, b = (p_fbank.fbank_kernel(wav, dither=1.0, seed=s).numpy() for s in (1, 1, 2))
    assert np.array_equal(a, a2)
    assert not np.allclose(a, b)
    loud = clean > clean.mean()
    np.testing.assert_allclose(a[loud], clean[loud], atol=0.5)
