"""Per-layer remat of the port's encoder (``cfg.remat``,
``models/encoder._checkpointed``) against JAX's ``jax.checkpoint`` of the
layer scan, and against the port without remat, at tiny width in float32.

Deterministic: loss and gradients match JAX's ``jax.grad`` with remat
within the tolerance of JAX's own remat test
(``tests/test_round2_fixes.py::TestRemat``, rtol 1e-5, atol 1e-6). With
dropout the draws cannot match ``jax.random``: remat and no-remat in the
port are held to each other from the same seed (the recompute must draw
the first run's masks and the attention kernel's seed), within 1e-6 of
each gradient's max-abs, and the generator must end where it ends
without remat. The trainer from ``configs/conformer_l.json`` (remat on)
takes steps at tiny width on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import transducer as j_tr
from conformer_tpu.train import loop as j_loop
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.config import tiny_test_config as p_tiny_test_config
from conformer_tpu_torch.models import transducer as p_tr
from conformer_tpu_torch.params import from_jax_params, tree_map
from conformer_tpu_torch.train import loop as p_loop
from conformer_tpu_torch.train.optimizer import is_trainable, leaf_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMAT_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_round2_fixes.py::TestRemat


def _port_model(model_cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(model_cfg)}).model


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 67, cfg.input_dim)).astype(np.float32)
    feat_lens = np.array([67, 41, 30], np.int32)
    labels = rng.integers(1, cfg.vocab_size - 1, (3, 5)).astype(np.int32)
    label_lens = np.array([5, 3, 4], np.int32)
    labels = np.where(np.arange(5)[None, :] < label_lens[:, None], labels, 0).astype(np.int32)
    return feats, feat_lens, labels, label_lens


def _port_grads(p, batch, cfg, **kw):
    """(loss, {path: grad}) of the port's transducer_forward."""
    tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
    leaves = leaf_paths(tree)
    out = p_tr.transducer_forward(tree, *(torch.from_numpy(a) for a in batch), cfg, **kw)
    trainable = [(k, v) for k, v in leaves if is_trainable(k)]
    grads = torch.autograd.grad(out["loss"], [v for _, v in trainable], allow_unused=True)
    return out["loss"].detach(), {k: torch.zeros_like(v) if g is None else g
                                  for (k, v), g in zip(trainable, grads)}


def test_remat_grads_match_jax_remat():
    cfg = dataclasses.replace(tiny_test_config().model, remat=True)
    jp = j_tr.init_transducer(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg)
    jb = [jnp.asarray(a) for a in batch]

    def j_loss(p):
        return j_tr.transducer_forward(p, *jb, cfg, deterministic=True)["loss"]

    want_loss, j_g = jax.jit(jax.value_and_grad(j_loss))(jp)
    want = dict(leaf_paths(_to_torch(j_g)))
    loss, got = _port_grads(_to_torch(jp), batch, _port_model(cfg), deterministic=True)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **REMAT_TOL)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **REMAT_TOL)


@pytest.mark.parametrize("kernel", [False, True])
def test_remat_dropout_draws_the_same_masks(kernel):
    """Dropout 0.1 everywhere, the attention kernel path (its plain version
    on the CPU, the keep-mask hashed from a seed drawn in the layer) or
    the plain attention: remat equals no remat from the same generator
    state, and the generator ends in the same state."""
    base = dataclasses.replace(tiny_test_config().model, dropout=0.1, attention_dropout=0.1,
                               use_pallas_attention=kernel)
    jp = j_tr.init_transducer(jax.random.PRNGKey(1), base)
    p = _to_torch(jp)
    batch = _batch(base, seed=6)
    runs = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(11)
        loss, grads = _port_grads(p, batch, _port_model(dataclasses.replace(base, remat=remat)),
                                  gen=gen, deterministic=False)
        runs[remat] = (loss, grads, gen.get_state())
    (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
    assert torch.equal(s0, s1)
    assert abs(float(l0 - l1)) <= 1e-6 * abs(float(l0))
    for k, g in g0.items():
        assert float((g1[k] - g).abs().max()) <= 1e-6 * max(float(g.abs().max()), 1e-30), k
    _, g_det = _port_grads(p, batch, _port_model(base), deterministic=True)
    live = [k for k in g0 if not torch.allclose(g0[k], g_det[k], rtol=1e-3, atol=1e-6)]
    assert len(live) > len(g0) // 2          # dropout was live


def _conformer_l_tiny(remat: bool):
    """configs/conformer_l.json (remat on, pruned loss, RNN-T and CTC kernel
    flags, dynamic chunks, dropout 0.1) at tiny widths in float32."""
    cfg = PConfig.from_json_file(os.path.join(REPO, "configs", "conformer_l.json"))
    assert cfg.model.remat and cfg.train.remat
    cfg.model = dataclasses.replace(
        cfg.model, vocab_size=64, sos_eos_id=63, encoder_dim=64, encoder_num_layers=2,
        num_heads=4, hidden_dim=128, kernel_size=7, predictor_embed_size=32,
        predictor_hidden_size=32, predictor_dim=32, join_dim=64, compute_dtype="float32",
        remat=remat)
    cfg.train.remat = remat
    cfg.data = dataclasses.replace(cfg.data, cmvn_path="", vocab_path="", bpe_model=None)
    return cfg


def test_conformer_l_trainer_steps_with_remat(tmp_path):
    steps = {}
    for remat in (True, False):
        cfg = _conformer_l_tiny(remat)
        cfg.train.checkpoint_dir = str(tmp_path / str(remat))
        trainer = p_loop.Trainer(cfg, device="cpu")
        assert trainer.cfg.model.remat is remat
        res = []
        for s in range(2):
            mbs = []
            for i in range(cfg.train.accum_grad):
                f, fl, lab, ll = _batch(cfg.model, seed=100 * s + i)
                mbs.append({"feats": f, "feat_lengths": fl, "labels": lab, "label_lengths": ll})
            res.append(trainer.train_step(mbs))
        assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in res)
        steps[remat] = (res, dict(leaf_paths(trainer.params)), trainer.gen.get_state())
    (r1, p1, s1), (r0, p0, s0) = steps[True], steps[False]
    assert torch.equal(s1, s0)
    assert [r["loss"] for r in r1] == pytest.approx([r["loss"] for r in r0], rel=1e-6)
    for k in p0:
        np.testing.assert_allclose(p1[k].detach().numpy(), p0[k].detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_remat_mirrors_into_model_and_train_state(tmp_path):
    """train.remat reaches model.remat at Trainer build time, as JAX's
    Trainer does it (tests/test_round2_fixes.py); make_train_state holds
    what JAX's holds."""
    cfg = PConfig.from_dict(dataclasses.asdict(p_tiny_test_config()))
    cfg.train.remat = True
    cfg.train.checkpoint_dir = str(tmp_path)
    assert p_loop.Trainer(cfg, device="cpu").cfg.model.remat is True
    want = j_loop.make_train_state({"w": jnp.ones(2)}, {"count": jnp.zeros(())}, step=3)
    got = p_loop.make_train_state({"w": torch.ones(2)}, {"count": torch.zeros(())}, step=3)
    assert set(got) == set(want) and got["step"] == int(want["step"]) == 3
    assert got["params"]["w"].tolist() == np.asarray(want["params"]["w"]).tolist()
