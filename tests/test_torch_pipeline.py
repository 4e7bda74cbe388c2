"""The port's GPipe encoder (``parallel/pipeline.py``) against JAX's
``encoder_forward_pipelined`` on its 8 virtual CPU devices, at the shapes
of tests/test_pipeline.py (4 layers, B = 8, T = 64) and (data, pipe,
microbatches) = (1, 4, 4) and (2, 2, 2), remat on; and ``Trainer`` with
``mesh_pipe=2`` against the one-process trainer on the joined batch,
through checkpoints both ways.

One set of 4 processes runs every case (a module fixture); the JAX side
runs here meanwhile. Each rank returns the gradients as its stage holds
them, and the tests assemble them by the module's rule: a stage's own
layers, the embedding's from stage 0 (zero elsewhere), the final norm's
from the last stage (the same on every stage, taken once), summed over
the data shards. The loss is sum(mask * out * R) for a fixed random R.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.models.encoder import init_encoder
from conformer_tpu.models.transducer import init_transducer
from conformer_tpu.parallel.pipeline import (encoder_forward_pipelined, make_pipeline_mesh,
                                             shard_stacked_layers)
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.train import checkpoint as p_ckpt
from conformer_tpu_torch.train.checkpoint import save_params_npz
from conformer_tpu_torch.train.loop import Trainer
from conformer_tpu_torch.train.optimizer import leaf_paths

from torch_mp_worker import join, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
MESHES = [(1, 4, 4), (2, 2, 2)]          # (data, pipe, microbatches)
LENS = [64, 50, 33, 64, 20, 64, 47, 12]


def _tree(jtree):
    return jax.tree.map(np.asarray, jtree)


def _json(obj):
    return json.loads(json.dumps(obj, default=list))


def step_config(ckpt_dir: str) -> PConfig:
    """tiny_test_config with 4 layers and no dropout."""
    cfg = PConfig.from_dict(_json(dataclasses.asdict(tiny_test_config())))
    m = cfg.model
    m.encoder_num_layers = 4
    m.dropout = m.attention_dropout = m.pos_enc_dropout = 0.0
    m.predictor_embed_dropout = m.predictor_dropout = 0.0
    cfg.train.checkpoint_dir = ckpt_dir
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    mcfg = dataclasses.replace(tiny_test_config().model, encoder_num_layers=4, remat=True)
    enc_p = init_encoder(jax.random.PRNGKey(0), mcfg)
    save_params_npz(str(d / "enc.npz"), {"encoder": _tree(enc_p)})
    rs = np.random.RandomState(1)
    batch = {"feats": rs.randn(8, 64, mcfg.input_dim).astype(np.float32),
             "lens": np.asarray(LENS, np.int32),
             "probe": rs.randn(8, 15, mcfg.encoder_dim).astype(np.float32)}
    np.savez(d / "b.npz", **batch)

    # the trainer: a one-process step on the joined 8-row batch, then its
    # checkpoint, which the pipeline trainer restores and steps from
    cfg1 = step_config(str(d / "one"))
    jp = _tree(init_transducer(jax.random.PRNGKey(3), cfg1.model))
    save_params_npz(str(d / "full.npz"), jp)
    step_b = {"feats": rs.randn(8, 64, cfg1.model.input_dim).astype(np.float32),
              "feat_lengths": np.asarray(LENS, np.int32),
              "labels": rs.randint(1, cfg1.model.vocab_size - 2, (8, 6)).astype(np.int32),
              "label_lengths": np.array([6, 5, 3, 6, 2, 6, 4, 1], np.int32)}
    np.savez(d / "step.npz", **step_b)
    one = Trainer(cfg1, params=jp, device="cpu")
    g1, m1, _ = one.step_grads([step_b])
    one.train_step([step_b])
    ckpt_in = one.save()
    cfgp = step_config(str(d / "piped"))
    cfgp.train.mesh_pipe, cfgp.train.pipeline_microbatches = 2, 2
    rows = {str(r): list(range(4 * (r // 2), 4 * (r // 2) + 4)) for r in range(4)}
    cases = [{"kind": "pipe", "name": f"pipe{dd}{pp}{m}", "model": _json(dataclasses.asdict(mcfg)),
              "data": dd, "pipe": pp, "m": m, "params": str(d / "enc.npz"),
              "batch": str(d / "b.npz")} for dd, pp, m in MESHES]
    cases.append({"kind": "trainer_grads", "name": "step",
                  "config": _json(dataclasses.asdict(cfgp)), "params": str(d / "full.npz"),
                  "batch": str(d / "step.npz"), "rows": rows, "ckpt_in": ckpt_in})
    procs = launch(REPO, 4, cases, str(d))

    # the JAX side, while the ranks run
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_res = {}
    for dd, pp, m in MESHES:
        mesh = make_pipeline_mesh(dd, pp)
        sharded = dict(enc_p, layers=shard_stacked_layers(enc_p["layers"], mesh))

        def fwd(p, b, mesh=mesh, m=m):
            return encoder_forward_pipelined(p, b["feats"], b["lens"], mcfg, mesh,
                                             num_microbatches=m)

        def probe_loss(p, b, fwd=fwd):
            out, mask = fwd(p, b)
            return jnp.sum(jnp.where(mask[..., None], out, 0.0) * b["probe"])

        out, mask = jax.jit(fwd)(sharded, jb)
        grads = jax.jit(jax.grad(probe_loss))(sharded, jb)
        jax_res[(dd, pp, m)] = {"out": np.asarray(out), "mask": np.asarray(mask),
                                "grads": dict(leaf_paths(_tree(grads)))}
    one_loss = float(m1[0])
    # the one-process trainer from the same checkpoint, one more step, and
    # that step's gradients
    cont = Trainer(cfg1, device="cpu")
    cont.restore(ckpt_in)
    cont_grads = cont.step_grads([step_b])[0]
    cont.train_step([step_b])
    failed = join(procs, TIMEOUT)
    assert not failed, "\n".join(failed)
    return {"dir": d, "jax": jax_res, "one_grads": g1, "one_loss": one_loss, "cont": cont,
            "cont_grads": cont_grads,
            "cfg1": cfg1, "ckpt_in": ckpt_in}


def _ranks(runs, name):
    return [np.load(runs["dir"] / f"{name}.rank{r}.npz") for r in range(4)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_forward_matches_jax(runs, mesh):
    """Every stage returns its data shard's output, JAX's within 2e-5."""
    data, pipe, m = mesh
    want = runs["jax"][mesh]
    rows = 8 // data
    for res in _ranks(runs, f"pipe{data}{pipe}{m}"):
        dc = int(res["coords"][0])
        np.testing.assert_allclose(res["out"], want["out"][dc * rows:(dc + 1) * rows],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(res["mask"], want["mask"][dc * rows:(dc + 1) * rows])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_gradients_match_jax(runs, mesh):
    """Each stage's layers, the embedding's (stage 0 only) and the final
    norm's (the same on every stage), summed over the data shards, equal
    JAX's gradients leaf for leaf; remat on in both."""
    data, pipe, m = mesh
    ranks = _ranks(runs, f"pipe{data}{pipe}{m}")
    at = {tuple(int(c) for c in r["coords"]): r for r in ranks}
    want = runs["jax"][mesh]["grads"]
    assert {k[2:] for k in ranks[0].files if k.startswith("g:")} == {
        k for k in want if "pos_table" not in k}
    for k, w in want.items():
        if "pos_table" in k:
            continue
        key = f"g:{k}"
        if k.startswith("layers."):
            got = np.concatenate([sum(at[(dd, s)][key] for dd in range(data))
                                  for s in range(pipe)])
        elif k.startswith("embed."):
            got = sum(at[(dd, 0)][key] for dd in range(data))
            for dd in range(data):
                for s in range(1, pipe):
                    assert not at[(dd, s)][key].any(), k
        else:
            got = sum(at[(dd, pipe - 1)][key] for dd in range(data))
            for dd in range(data):
                for s in range(pipe - 1):
                    np.testing.assert_allclose(at[(dd, s)][key], at[(dd, pipe - 1)][key],
                                               rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got, w, rtol=5e-4, atol=5e-5, err_msg=k)


def test_trainer_step_with_mesh_pipe(runs):
    """``Trainer`` at data 2 x pipe 2 (``train.mesh_pipe=2``, 2
    microbatches): the step's loss, reduced gradients and global norm equal
    the one-process trainer's on the joined batch."""
    ranks = _ranks(runs, "step")
    np.testing.assert_allclose(ranks[0]["metrics"][0], runs["one_loss"], rtol=2e-5)
    want = runs["one_grads"]
    floor = 1e-6 * max(float(g.abs().max()) for g in want.values())
    norm = 0.0
    for k, w in want.items():
        w = w.numpy()
        norm += float(np.square(w.astype(np.float64)).sum())
        key = f"g:{k}"
        if "encoder.layers." in k:              # stage s = rank s of data shard 0
            got = np.concatenate([ranks[0][key], ranks[1][key]])
            np.testing.assert_array_equal(ranks[0][key], ranks[2][key])
        else:
            got = ranks[0][key]
            for other in ranks[1:]:
                np.testing.assert_array_equal(got, other[key], err_msg=k)
        np.testing.assert_allclose(got, w, rtol=5e-4, atol=floor, err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r["norm"], np.sqrt(norm), rtol=1e-5)


def test_pipeline_checkpoints_both_ways(runs):
    """The pipeline trainer restored a one-process checkpoint (its stage's
    slice), stepped and saved from rank 0 only; that checkpoint is the
    one-process layout and restores in one process bit for bit, equal to
    the one-process trainer's same step."""
    ranks = _ranks(runs, "step")
    path = str(ranks[0]["ckpt"])
    assert path and all(str(r["ckpt"]) == "" for r in ranks[1:])
    saved = p_ckpt.restore_checkpoint(path)
    one = Trainer(runs["cfg1"], device="cpu")
    one.restore(path)
    assert one.step == saved["step"] == 2 and one.opt_state.count == 2
    for k, v in leaf_paths(one.params):
        assert torch.equal(v.detach(), dict(leaf_paths(saved["params"]))[k]), k
    for k in one.opt_state.mu:
        assert torch.equal(one.opt_state.mu[k], saved["opt_state"]["mu"][k]), k
        assert torch.equal(one.opt_state.nu[k], saved["opt_state"]["nu"][k]), k
    # each stage held its slice of the stack
    for r, res in enumerate(ranks):
        s = r % 2
        for key in res.files:
            if key.startswith("stage_norm_ff:"):
                full = saved["params"]["encoder"]["layers"]["norm_ff"][key.split(":")[1]]
                np.testing.assert_array_equal(res[key], full[2 * s:2 * s + 2].numpy())
    # the same step in one process. Adam's normalised step magnifies a
    # gradient's rounding where that gradient is small, so the update is
    # held in two parts, each leaf whole: the moments against the
    # one-process step's, within what the gradient tolerance of
    # test_trainer_step_with_mesh_pipe (rtol 5e-4, 1e-6 of the largest
    # gradient) lets through to them; and every parameter against Adam's
    # update of the step-1 parameters, computed here from the
    # checkpoint's own moments, to float32 rounding
    t = runs["cfg1"].train
    b1, b2 = t.adam_b1, t.adam_b2
    lr = runs["cont"].lr_schedule(1)
    one = runs["cont"].opt_state
    before = dict(leaf_paths(p_ckpt.restore_checkpoint(runs["ckpt_in"])["params"]))
    after = dict(leaf_paths(saved["params"]))
    grads = {k: g.numpy() for k, g in runs["cont_grads"].items()}
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    assert set(grads) == set(saved["opt_state"]["mu"])
    for k, g in grads.items():
        mu, nu = saved["opt_state"]["mu"][k], saved["opt_state"]["nu"][k]
        dg = 5e-4 * np.abs(g) + floor
        mu_err = np.abs(mu.numpy() - one.mu[k].numpy())
        nu_err = np.abs(nu.numpy() - one.nu[k].numpy())
        assert np.all(mu_err <= (1 - b1) * dg + 1e-6 * np.abs(mu.numpy())), k
        assert np.all(nu_err <= (1 - b2) * (2 * np.abs(g) + dg) * dg
                      + 1e-6 * np.abs(nu.numpy())), k
        step = (mu / (1 - b1 ** 2)) / (torch.sqrt(nu / (1 - b2 ** 2)) + t.adam_eps)
        want = before[k] - lr * (step + t.weight_decay * before[k])
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k].numpy(), want.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r["restored_step_loss"], ranks[0]["restored_step_loss"])
