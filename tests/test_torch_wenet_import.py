"""The reference / WeNet state-dict import of the port
(``train/checkpoint.import_torch_checkpoint``) against JAX's, on the CPU at
tiny width. The reference checkout is absent, so each state dict is built
in the test in the reference's key layout from a JAX init tree
(``chip_smoke.reference_state_dict``, the inverse of the import: with
BatchNorm running statistics, ``linear_pos``, ``pos_bias_u/v`` and a
2-layer LSTM), saved with ``torch.save`` as a plain ``.pt`` and as a
Lightning-style ``.ckpt``, and imported onto another init by both
packages: the trees are equal leaf for leaf and equal the source tree.
Then the encoder on the imported tree (``ref_batch`` + BatchNorm) against
JAX's, within 1e-5; the runner's ``.pt`` route, ``Trainer
.load_torch_checkpoint`` and ``main --eval --wenet_ckpt_path``.
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import encoder as j_enc
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.train import checkpoint as j_ckpt
from conformer_tpu_torch import main as p_main
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.data.synthetic import write_corpus
from conformer_tpu_torch.models import encoder as p_enc
from conformer_tpu_torch.params import from_jax_params
from conformer_tpu_torch.serve.runner import ModelRunner
from conformer_tpu_torch.train import checkpoint as p_ckpt
from conformer_tpu_torch.train.loop import Trainer
from conformer_tpu_torch.train.optimizer import leaf_paths

MODEL = dataclasses.replace(tiny_test_config().model, rel_mode="ref_batch",
                            conv_norm="batch_norm", predictor_num_layers=2)


def _port(model_cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(model_cfg)}).model


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def _source_tree(seed=0):
    """A JAX init tree with BatchNorm running statistics off the identity."""
    jp = j_init(jax.random.PRNGKey(seed), MODEL)
    norm = jp["encoder"]["layers"]["conv_module"]["norm"]
    rng = np.random.default_rng(seed)
    norm["mean"] = jnp.asarray(0.3 * rng.standard_normal(norm["mean"].shape), jnp.float32)
    norm["var"] = jnp.asarray(rng.uniform(0.5, 2.0, norm["var"].shape), jnp.float32)
    return jp


def _save(sd: dict, path, lightning: bool) -> str:
    obj = ({"state_dict": {f"model.{k}": v for k, v in sd.items()}, "epoch": 3,
            "hyper_parameters": {"lr": 1e-3}} if lightning else sd)
    torch.save(obj, path)
    return str(path)


@pytest.fixture(scope="module")
def source():
    jp = _source_tree()
    return jp, chip_smoke.reference_state_dict(_to_torch(jp), MODEL)


def _assert_trees_equal(got: dict, want: dict):
    got, want = dict(leaf_paths(got)), dict(leaf_paths(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("kind", ["pt", "ckpt"])
def test_import_matches_jax_and_source(source, kind, tmp_path):
    jp, sd = source
    assert {"encoder.encoders.1.conv_module.norm.running_var",
            "encoder.encoders.0.self_attn.linear_pos.weight",
            "encoder.encoders.0.self_attn.pos_bias_u",
            "predictor.rnn.weight_hh_l1"} <= set(sd)
    path = _save(sd, tmp_path / f"model.{kind}", lightning=kind == "ckpt")
    target = j_init(jax.random.PRNGKey(1), MODEL)
    want = j_ckpt.import_torch_checkpoint(path, target, MODEL)
    got = p_ckpt.import_torch_checkpoint(path, _to_torch(target), _port(MODEL))
    _assert_trees_equal(got, _to_torch(want))
    _assert_trees_equal(got, _to_torch(jp))


def test_missing_keys_match_jax(source, tmp_path, capsys):
    """Without the predictor both print JAX's message with the same keys
    and leave the predictor at the target's values."""
    _, sd = source
    path = _save({k: v for k, v in sd.items() if not k.startswith("predictor.")},
                 tmp_path / "no_pred.pt", lightning=False)
    target = j_init(jax.random.PRNGKey(1), MODEL)
    want = j_ckpt.import_torch_checkpoint(path, target, MODEL)
    j_msg = capsys.readouterr().out
    got = p_ckpt.import_torch_checkpoint(path, _to_torch(target), _port(MODEL))
    p_msg = capsys.readouterr().out
    assert "predictor.projection.weight" in j_msg and p_msg == j_msg
    _assert_trees_equal(got, _to_torch(want))
    _assert_trees_equal(got["predictor"], _to_torch(target["predictor"]))


def test_encoder_on_imported_tree_matches_jax(source, tmp_path):
    _, sd = source
    path = _save(sd, tmp_path / "model.pt", lightning=False)
    target = j_init(jax.random.PRNGKey(2), MODEL)
    j_tree = j_ckpt.import_torch_checkpoint(path, target, MODEL)
    p_tree = p_ckpt.import_torch_checkpoint(path, _to_torch(target), _port(MODEL))
    feats = np.random.default_rng(3).standard_normal((2, 53, 80)).astype(np.float32)
    lens = np.array([53, 31], np.int32)
    want, _ = j_enc.encoder_forward(j_tree["encoder"], jnp.asarray(feats), jnp.asarray(lens),
                                    MODEL)
    got, _ = p_enc.encoder_forward(p_tree["encoder"], torch.from_numpy(feats),
                                   torch.from_numpy(lens), _port(MODEL))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_runner_trainer_and_main_import(source, tmp_path):
    """The runner's .pt route keeps the CMVN of data.cmvn_path (no key maps
    CMVN); the trainer imports in place; ``main --eval --wenet_ckpt_path``
    prints the WER of ``--eval --resume`` from a checkpoint of the same
    weights."""
    jp, sd = source
    pt = _save(sd, tmp_path / "model.pt", lightning=False)
    corpus = write_corpus(str(tmp_path / "corpus"), seed=4, n_train=2, n_dev=2,
                          seconds=(0.6, 1.2), vocab_size=MODEL.vocab_size)
    cmvn = tmp_path / "cmvn.json"
    cmvn.write_text(json.dumps({"mean_stat": [1.0] * 80, "var_stat": [4.0] * 80,
                                "frame_num": 2}))
    cfg = PConfig.from_dict(dataclasses.asdict(tiny_test_config()))
    cfg.model = _port(MODEL)
    cfg.data = dataclasses.replace(
        cfg.data, cmvn_path=str(cmvn), vocab_path=corpus["vocab"], bpe_model=None,
        train_data_list_path=corpus["train"], dev_data_list_path=corpus["dev"],
        test_data_list_path=corpus["dev"])
    cfg.decode.max_hyp_len = 16
    cfg.decode.n_steps = 4
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    runner = ModelRunner(cfg, pt, device="cpu")
    served = dict(leaf_paths(runner.params))
    # no key maps pos_table: the port's init keeps its own (JAX's within rounding)
    want = {k: v for k, v in leaf_paths(_to_torch(jp)) if k != "encoder.pos_table"}
    for k, v in want.items():
        assert torch.equal(served[k], v), k
    np.testing.assert_allclose(served["cmvn.mean"].numpy(), 0.5)     # 1 / 2 frames
    trainer = Trainer(cfg, device="cpu")
    before = {k: v for k, v in leaf_paths(trainer.params)}
    trainer.load_torch_checkpoint(pt)
    after = dict(leaf_paths(trainer.params))
    assert all(after[k] is before[k] for k in before)                # in place
    for k, v in want.items():
        assert torch.equal(after[k], v), k
    trainer.save()
    config = tmp_path / "cfg.json"
    config.write_text(cfg.to_json())
    wers = []
    for extra in (["--wenet_ckpt_path", pt], ["--resume", "--resume_from", "last"]):
        buf = io.StringIO()
        with redirect_stdout(buf):
            p_main.main(["--config", str(config), "--device", "cpu", "--eval", *extra])
        wers.append([line for line in buf.getvalue().splitlines() if line.startswith("WER:")])
    assert len(wers[0]) == 1 and wers[0] == wers[1]
    assert os.path.exists(os.path.join(cfg.train.checkpoint_dir, "last"))
