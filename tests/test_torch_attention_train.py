"""The attention kernel's training side in the port against the JAX package
on the CPU: the dropout keep-mask hash, the forward with dropout, the
backward written out (``rel_attention_bwd_plain``) and through the
autograd Function, and ``mhsa`` on the kernel path in training.

The JAX side runs ``rel_flash_attention`` in interpret mode with 16-wide
tiles, as ``tests/test_pallas_attention.py`` does; the port's wrappers take
their plain versions on CPU tensors. Tolerances: the forward within 1e-5
and gradients within 1e-4 (float32; sums in another order); the hash bit
for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import attention as j_att
from conformer_tpu.ops.pallas.attention_kernel import _tile_keep_mask, rel_flash_attention
from conformer_tpu_torch.models import attention as p_att
from conformer_tpu_torch.ops import rel_attention as ra
from conformer_tpu_torch.params import from_jax_params

SCALE = 0.35


def _inputs(seed, b=2, h=2, t=37, dk=8, d=16, chunk=False):
    """q_u, ab, k, v, feats, mask, dO as numpy: ragged key lengths, a dead
    query row, a fully masked batch row when b > 2, optionally a dynamic
    chunk mask (chunk 4, 2 chunks of left context)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, t, dk)).astype(np.float32) for _ in range(4))
    ab = (0.3 * rng.standard_normal((b, h, t, d))).astype(np.float32)
    feats = rng.standard_normal((t, d)).astype(np.float32)
    lens = np.array([t, t - 15, 0][:b] + [t] * max(0, b - 3))
    pos = np.arange(t)
    mask = np.broadcast_to(pos[None, None, :] < lens[:, None, None], (b, t, t)).copy()
    if chunk:
        ci, cj = pos[:, None] // 4, pos[None, :] // 4
        mask &= (cj <= ci) & (cj >= ci - 2)
    mask[0, 3] = False
    return q, ab, k, v, feats, mask, g


def _jax_attention(q, ab, k, v, feats, mask, rate, seed):
    return rel_flash_attention(
        q, ab, k, v, jnp.asarray(feats), jnp.asarray(mask), scale=SCALE, dropout_rate=rate,
        dropout_seed=jnp.asarray([seed], jnp.int32) if rate else None, interpret=True,
        tile_q=16, tile_k=16)


@pytest.mark.parametrize("seed,q0,k0,rate", [
    (7, 0, 0, 0.1), (7, 320, 128, 0.2), (2**31 - 2, 16, 48, 0.1), (0, 96, 0, 0.5),
    (123456789, 320, 128, 0.75),
])
def test_tile_keep_mask_matches_jax(seed, q0, k0, rate):
    b, h, n_h = 3, 2, 4
    want = _tile_keep_mask(jnp.int32(seed), jnp.int32(b), jnp.int32(h), jnp.int32(q0),
                           jnp.int32(k0), n_h, (16, 24), rate)
    got = ra.tile_keep_mask(torch.tensor([seed], dtype=torch.int32), torch.tensor(b * n_h + h),
                            torch.arange(q0, q0 + 16)[:, None], torch.arange(k0, k0 + 24)[None, :],
                            rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = ra.keep_mask(torch.tensor([seed], dtype=torch.int32), 4, n_h, q0 + 16, k0 + 24, rate,
                        "cpu")
    np.testing.assert_array_equal(full[b, h, q0:, k0:].numpy(), np.asarray(want))


def test_keep_share_and_rate_bounds():
    keep = ra.keep_mask(torch.tensor([99], dtype=torch.int32), 8, 4, 128, 128, 0.1, "cpu")
    assert abs(keep.float().mean().item() - 0.9) < 0.002       # sd 0.0002
    assert bool(ra.keep_mask(7, 1, 1, 8, 8, 0.0, "cpu").all())
    with pytest.raises(ValueError):
        ra.keep_threshold(1.0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_forward_with_dropout_matches_jax(rate):
    q, ab, k, v, feats, mask, _ = _inputs(0, b=3)
    want = _jax_attention(q, ab, k, v, feats, mask, rate, 1234)
    out, lse = ra.rel_attention(*map(torch.from_numpy, (q, ab, k, v, feats, mask)),
                                scale=SCALE, dropout_rate=rate,
                                seed=torch.tensor([1234], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (out[2] == 0).all() and (lse[2] == ra.LSE_BIG).all()     # fully masked row
    if rate == 0.0:
        ref, _ = ra.rel_attention_plain(*map(torch.from_numpy, (q, ab, k, v, feats, mask)),
                                        scale=SCALE)
        assert torch.equal(out, ref)


@pytest.mark.parametrize(
    "chunk,dk,d,t",
    [(False, 8, 16, 37), (True, 8, 16, 37), (True, 36, 144, 21), (False, 64, 512, 21)],
    ids=["False", "True", "conformer_s-dk36-D144", "conformer_l-dk64-D512"])
def test_backward_matches_jax_grad(chunk, dk, d, t):
    """dQu, dAB, dK, dV of the written-out backward and of the autograd
    Function against jax.grad, dropout 0.1, ragged T, a fully masked row,
    with and without a dynamic-chunk mask; at a tiny width and at
    Conformer-S's and Conformer-L's head widths (dk=36, D=144; dk=64,
    D=512)."""
    q, ab, k, v, feats, mask, g = _inputs(1, b=3, t=t, dk=dk, d=d, chunk=chunk)
    rate, seed = 0.1, 4321

    def loss(q, ab, k, v):
        return jnp.sum(_jax_attention(q, ab, k, v, feats, mask, rate, seed) * g)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(q, ab, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, ab, k, v)]
    seed_t = torch.tensor([seed], dtype=torch.int32)
    fm = (torch.from_numpy(feats), torch.from_numpy(mask))
    out = ra.rel_flash_attention(*leaves, *fm, scale=SCALE, dropout_rate=rate, seed=seed_t)
    (out * torch.from_numpy(g)).sum().backward()
    _, lse = ra.rel_attention_plain(*[x.detach() for x in leaves], *fm, scale=SCALE,
                                    dropout_rate=rate, seed=seed_t)
    delta = (torch.from_numpy(g) * out.detach()).sum(-1)
    plain = ra.rel_attention_bwd_plain(*[x.detach() for x in leaves], *fm, seed_t,
                                       torch.from_numpy(g), lse, delta, scale=SCALE,
                                       dropout_rate=rate)
    for leaf, p_grad, w in zip(leaves, plain, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(p_grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dk,d,h", [(64, 256, 4), (64, 512, 8), (36, 144, 4)],
                         ids=["conformer_m", "conformer_l", "conformer_s"])
def test_bf16_operand_rounding_within_card_tolerance(dk, d, h):
    """The bf16 kernels round float32 intermediates to bf16 where they
    become tensor-core operands: the dropped probabilities pd before P.V
    (forward) and before dV (backward), and dS before dQu, dAB and dK.
    Rounding the float32 plain version at those points, on bf16 inputs of
    the smoke's training distribution (T=374, dropout 0.1), keeps every
    output within chip_smoke's TOL["bfloat16"] (abs + rel) of the unrounded
    one: the card's tolerance covers the rounding. Scores, the softmax
    statistics and every sum stay float32, as in the kernels."""
    rng = np.random.default_rng(17)
    b, t, rate, scale = 2, 374, 0.1, 1 / 8

    def bf(x):
        return x.to(torch.bfloat16).float()

    q, k, v, g = (bf(torch.from_numpy(rng.standard_normal((b, h, t, dk)).astype(np.float32)))
                  for _ in range(4))
    ab = bf(torch.from_numpy((0.2 * rng.standard_normal((b, h, t, d))).astype(np.float32)))
    feats = bf(torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)))
    lens = torch.tensor([t, t - 11])
    mask = (torch.arange(t)[None, None, :] < lens[:, None, None]).expand(b, t, t).clone()
    mask[0, t // 2] = False
    seed = torch.tensor([20240917], dtype=torch.int32)
    kw = dict(scale=scale, dropout_rate=rate)
    out, lse = ra.rel_attention_plain(q, ab, k, v, feats, mask, seed=seed, **kw)
    delta = (g * out).sum(-1)
    want_bwd = ra.rel_attention_bwd_plain(q, ab, k, v, feats, mask, seed, g, lse, delta, **kw)

    m4 = mask[:, None]
    s = (q @ k.transpose(-1, -2) + ab @ feats.T) * scale
    s = torch.where(m4, s, torch.full_like(s, ra.NEG_INF))
    p = torch.where(m4, torch.exp(s - s.amax(-1, keepdim=True)), torch.zeros_like(s))
    keep = ra.keep_mask(seed, b, h, t, t, rate, "cpu")
    inv = 1.0 / (1.0 - rate)
    pd = torch.where(keep, p * inv, torch.zeros_like(p))
    out_r = (bf(pd) @ v) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    p = torch.where(m4, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.where(keep, (g @ v.transpose(-1, -2)) * inv, torch.zeros_like(s))
    ds = bf(p * (dp - delta[..., None]) * scale)
    pd = bf(torch.where(keep, p * inv, torch.zeros_like(p)))
    got_bwd = (ds @ k, ds @ feats, ds.transpose(-1, -2) @ q, pd.transpose(-1, -2) @ g)

    tol = chip_smoke.TOL["bfloat16"]
    for name, got, want in zip(("out", "dQu", "dAB", "dK", "dV"), (out_r, *got_bwd),
                               (out, *want_bwd)):
        err, ok = chip_smoke.max_err(got, want, tol)
        assert ok, f"{name}: max abs err {err:.3g} beyond {tol} abs + rel"


def test_wrappers_take_plain_on_cpu_and_count_no_launch():
    q, ab, k, v, feats, mask, g = map(torch.from_numpy, _inputs(2))
    before = (ra.rel_attention.launches, ra.rel_attention_bwd_dq.launches,
              ra.rel_attention_bwd_dkv.launches)
    seed = torch.tensor([5], dtype=torch.int32)
    out, lse = ra.rel_attention(q, ab, k, v, feats, mask, scale=SCALE, dropout_rate=0.1,
                                seed=seed)
    delta = (g * out).sum(-1)
    args = (q, ab, k, v, feats, mask, seed, g, lse, delta)
    dq = ra.rel_attention_bwd_dq(*args, scale=SCALE, dropout_rate=0.1)
    dkv = ra.rel_attention_bwd_dkv(*args, scale=SCALE, dropout_rate=0.1)
    plain = ra.rel_attention_bwd_plain(*args, scale=SCALE, dropout_rate=0.1)
    for got, want in zip((*dq, *dkv), plain):
        assert torch.equal(got, want)
    assert (ra.rel_attention.launches, ra.rel_attention_bwd_dq.launches,
            ra.rel_attention_bwd_dkv.launches) == before
    with pytest.raises(ValueError):
        ra.rel_flash_attention(q, ab, k, v, feats, mask, scale=SCALE, dropout_rate=0.1)


# ---------------------------------------------------------------- mhsa


def _mhsa_setup(seed=3, b=2, t=21):
    cfg = tiny_test_config().model
    jp = j_att.init_mhsa(jax.random.PRNGKey(seed), cfg.encoder_dim, cfg.num_heads, True)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, cfg.encoder_dim)).astype(np.float32)
    pad = np.arange(t)[None, :] < np.array([t, t - 6])[:, None]
    mask = (pad[:, None, :] & pad[:, :, None]) | np.eye(t, dtype=bool)[None]
    return cfg, jp, x, mask, np.arange(t)


def test_mhsa_kernel_path_training_matches_jax_at_rate_zero():
    """Gradients of the kernel path in training (deterministic=False) at
    attention dropout 0, against JAX's, which takes its kernel there too."""
    cfg, jp, x, mask, pos = _mhsa_setup()
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def j_loss(p, x):
        out, _ = j_att.mhsa(p, x, x, jnp.asarray(mask), num_heads=cfg.num_heads,
                            rel_positions=(jnp.asarray(pos), jnp.asarray(pos)), dropout_rate=0.0,
                            rng=jax.random.PRNGKey(0), deterministic=False, use_pallas=True)
        return jnp.sum(out * g)

    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(jp, x)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    for leaf in jax.tree.leaves(pp):
        leaf.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    tpos = torch.from_numpy(pos)
    out, _ = p_att.mhsa(pp, xt, xt, torch.from_numpy(mask), num_heads=cfg.num_heads,
                     rel_positions=(tpos, tpos), use_pallas=True, dropout_rate=0.0,
                     gen=torch.Generator().manual_seed(0), deterministic=False)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-4)
    for name, sub in pp.items():
        for key, leaf in (sub.items() if isinstance(sub, dict) else [("", sub)]):
            want = j_gp[name][key] if key else j_gp[name]
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name}.{key}")


def test_mhsa_kernel_path_dropout_draws_from_the_generator():
    """At rate 0.3: the same generator state gives the same output, another
    state another; the seed is the generator's next int32 draw, and its
    keep-mask keeps 70 % of the probabilities."""
    cfg, jp, x, mask, pos = _mhsa_setup(t=48)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    xt, tpos, tmask = torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(mask)

    def run(gen):
        return p_att.mhsa(pp, xt, xt, tmask, num_heads=cfg.num_heads, rel_positions=(tpos, tpos),
                          use_pallas=True, dropout_rate=0.3, gen=gen, deterministic=False)[0]

    a = run(torch.Generator().manual_seed(11))
    b = run(torch.Generator().manual_seed(11))
    c = run(torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    det, _ = p_att.mhsa(pp, xt, xt, tmask, num_heads=cfg.num_heads, rel_positions=(tpos, tpos),
                     use_pallas=True, dropout_rate=0.3, deterministic=True)
    assert not torch.allclose(a, det)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(11),
                         dtype=torch.int32)
    keep = ra.keep_mask(seed, 2, cfg.num_heads, 48, 48, 0.3, "cpu")
    assert abs(keep.float().mean().item() - 0.7) < 0.01         # 18432 draws: sd 0.0034
    with pytest.raises(ValueError):
        run(None)


def test_encoder_training_through_the_kernel_path_runs():
    """A training forward and backward of the tiny encoder with the
    attention flag on (dropout live) gives finite gradients for every
    attention weight."""
    from conformer_tpu_torch.config import Config as PConfig
    from conformer_tpu_torch.models import encoder as p_enc
    from conformer_tpu_torch.train.optimizer import leaf_paths

    cfg = dataclasses.replace(tiny_test_config().model, use_pallas_attention=True,
                              rel_mode="decomposed")
    pcfg = PConfig.from_dict({"model": dataclasses.asdict(cfg)}).model
    params = p_enc.init_encoder(torch.Generator().manual_seed(0), pcfg)
    attn = leaf_paths(params["layers"]["self_attn"])
    for _, leaf in attn:
        leaf.requires_grad_()
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 80)).astype(
        np.float32))
    out, _ = p_enc.encoder_forward(params, feats, torch.tensor([64, 40]), pcfg,
                                   gen=torch.Generator().manual_seed(0), deterministic=False)
    out.float().sum().backward()
    for k, leaf in attn:
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), k
        assert leaf.grad.abs().max() > 0, k
