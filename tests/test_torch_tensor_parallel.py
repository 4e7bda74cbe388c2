"""The port's tensor parallelism (the "model" axis: ``parallel/tensor.py``,
``parallel/mesh.model_axis`` / ``shard_params``, and the trainer's rules)
against JAX's ``parallel/`` on its 8 virtual CPU devices (``shard_params``
and ``jit``, as tests/test_sharding.py runs it), on the CPU over gloo.

One set of ranks per world size, started together by a module fixture
(tests/torch_mp_worker.py, case "tp"); the JAX side runs here meanwhile.
World 2 is (data 1, model 2): the pruned loss through ``Trainer``'s step
(gradients, norm, params after it) against JAX's ``Trainer`` on the same
mesh; the full lattice with the attention decoder, the kernel flags off
and on (on the CPU each wrapper takes its plain version down its kernel's
route: the attention at a head offset, the CTC and RNN-T DPs on
replicated emissions, the joint kernels on the gathered W); checkpoints
both ways; ``validate``. World 4 is (data 2, model 2), the pruned loss and
the full lattice with the decoder, and (seq 2, model 2) through
``Trainer``'s step against JAX's 3-axis ``Trainer``. Beside them, ``python -m
conformer_tpu_torch.main --train --coordinator ... --set
train.mesh_model=2`` on a synthetic corpus (its dropout on), held to the
same command in one process.

JAX's own (data 2, model 2) program returns twice its one-device gradient
of the depthwise conv kernel, and its (seq 2, model 2) program twice that
of the depthwise kernel and of the subsampling's second conv (its (data
1, model 2) program, the port and the one-device gradient agree). Those
cases hold those leaves, the gradient norm and the params after a step to
JAX's (data 1, model 2) program on the same loss, and check that JAX's
gradient is twice it, so that a change on JAX's side shows here.

Tolerances: losses within 1e-5 relative; each gradient leaf within 1e-4
of its largest magnitude, with a floor of 1e-6 of the largest gradient of
all: the key biases' gradients are zero but for rounding (softmax ignores
a shift of a query's scores). Params after one step: Adam's first step
moves a coordinate by lr * g / (|g| + eps), whose sign rounding decides
where |g| is within the gradient's tolerance; those coordinates are held
to a move of at most lr, every other to 1e-4 of its leaf's largest value.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import tiny_test_config
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.models.transducer import transducer_forward as j_forward
from conformer_tpu.ops.pallas.attention_kernel import _tile_keep_mask
from conformer_tpu.parallel.mesh import _spec_for
from conformer_tpu.parallel.mesh import make_mesh as j_make_mesh
from conformer_tpu.parallel.mesh import shard_batch as j_shard_batch
from conformer_tpu.parallel.mesh import shard_params as j_shard_params
from conformer_tpu.train.loop import Trainer as JTrainer
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.models.transducer import init_transducer as p_init
from conformer_tpu_torch.ops import rel_attention as ra
from conformer_tpu_torch.parallel.mesh import Mesh, model_axis, shard_params
from conformer_tpu_torch.train import checkpoint as ckpt_mod
from conformer_tpu_torch.train.checkpoint import save_params_npz
from conformer_tpu_torch.train.loop import Trainer
from conformer_tpu_torch.train.optimizer import is_trainable, leaf_paths

from torch_mp_worker import free_port, join, launch, worker_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
B, T, U = 4, 68, 5          # T' = 16: whole time shards at seq 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jconfig(d, name, *, pruned=True, decoder=False, model=2, seq=1, data=1):
    """tiny_test_config without dropout, the loss and mesh asked for."""
    cfg = tiny_test_config()
    m = cfg.model
    m.dropout = m.attention_dropout = m.pos_enc_dropout = 0.0
    m.predictor_embed_dropout = m.predictor_dropout = 0.0
    m.use_pruned_loss = pruned
    if decoder:
        m.decoder_num_layers, m.decoder_hidden_dim, m.attention_weight = 1, 96, 0.3
    t = cfg.train
    t.mesh_data, t.mesh_model, t.mesh_seq = data, model, seq
    t.checkpoint_dir = str(d / name)
    cfg.decode.n_steps, cfg.decode.max_hyp_len, cfg.decode.beam_size = 3, 8, 3
    return cfg


def as_dict(cfg, **model):
    out = json.loads(json.dumps(dataclasses.asdict(cfg), default=list))
    out["model"].update(model)
    return out


def jax_grads(cfg, params, batch, mesh):
    """(loss, {path: gradient}) of JAX's deterministic forward on ``mesh``."""
    mcfg = cfg.model

    def loss_fn(p, b):
        return j_forward(p, b["feats"], b["feat_lengths"], b["labels"], b["label_lengths"],
                         mcfg, deterministic=True)["loss"]

    sp = j_shard_params(params, mesh, model_parallel=True)
    sb = j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(sp, sb)
    return float(loss), dict(leaf_paths(_np(g)))


def jax_trainer_step(cfg, batch):
    """JAX's ``Trainer`` on its mesh: (init params, step gradients, loss,
    params after one step)."""
    jt = JTrainer(cfg)
    init = _np(jt.state["params"])
    sb = j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, jt.mesh)
    grads, _ = jt._grad_fn(batch["feats"].shape)(
        jt.state["params"], sb["feats"], sb["feat_lengths"], sb["labels"], sb["label_lengths"],
        jax.random.PRNGKey(0))
    loss = jt.train_step([batch])["loss"]
    return init, dict(leaf_paths(_np(grads))), loss, dict(leaf_paths(_np(jt.state["params"])))


MAIN_SET = ["data.batch_type=static", "data.batch_size=3", "train.val_check_interval=2",
            "train.log_every=1", "train.max_steps=2", "train.num_sanity_val_steps=0",
            "data.prefetch_depth=0", "decode.max_hyp_len=8", "decode.n_steps=3"]


def main_runs(d) -> list:
    """Start ``main --train`` on a synthetic corpus: 2 ranks at
    ``train.mesh_model=2`` and the same command in one process."""
    env = worker_env(REPO)
    subprocess.run([sys.executable, "-m", "conformer_tpu_torch.data.synthetic", str(d / "corpus"),
                    "--train", "6", "--dev", "2", "--min_seconds", "1", "--max_seconds", "2",
                    "--vocab_size", "64"], cwd=REPO, env=env, check=True, capture_output=True)
    with open(d / "main.json", "w") as f:
        json.dump(dataclasses.asdict(tiny_test_config()), f, default=list)
    lists = [f"data.{k}_data_list_path={d / 'corpus' / n}.list"
             for k, n in (("train", "train"), ("dev", "dev"), ("test", "dev"))]
    base = [sys.executable, "-m", "conformer_tpu_torch.main", "--config", str(d / "main.json"),
            "--device", "cpu", "--train", "--set", *MAIN_SET, *lists,
            f"data.vocab_path={d / 'corpus' / 'vocab.txt'}"]
    port, procs = free_port(), []
    runs = [(r, [*base, f"train.checkpoint_dir={d / 'main_m2'}", "train.mesh_model=2",
                 "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                 "--process_id", str(r)]) for r in range(2)]
    runs.append((2, [*base, f"train.checkpoint_dir={d / 'main_one'}"]))
    for r, cmd in runs:
        log = open(d / f"main.{r}.log", "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    rs = np.random.RandomState(7)
    batch = {"feats": rs.randn(B, T, 80).astype(np.float32),
             "feat_lengths": np.array([68, 60, 45, 68], np.int32),
             "labels": rs.randint(1, 62, (B, U)).astype(np.int32),
             "label_lengths": np.array([5, 4, 3, 5], np.int32)}
    np.savez(d / "batch.npz", **batch)
    dev = {f"feats{r}": rs.randn(2, T, 80).astype(np.float32) for r in range(2)}
    dev.update({f"lens{r}": np.array([68, 52], np.int32) for r in range(2)})
    dev.update({f"text{r}": np.array(["3 5 7", "9 11"]) for r in range(2)})
    np.savez(d / "dev.npz", **dev)

    # the step and checkpoint cases start from JAX's Trainer's own init
    c_m2 = jconfig(d, "m2")
    c_s2m2 = jconfig(d, "s2m2", seq=2)
    c_full = jconfig(d, "full", pruned=False, decoder=True)
    c_d2 = jconfig(d, "d2", data=2)
    c_d2f = jconfig(d, "d2f", pruned=False, decoder=True, data=2)
    init, j_step_g, j_step_loss, j_step_p = jax_trainer_step(c_m2, batch)
    save_params_npz(str(d / "init.npz"), init)
    p_full = _np(j_init(jax.random.PRNGKey(3), c_full.model))
    save_params_npz(str(d / "full.npz"), p_full)

    # a one-process checkpoint after one step, for the ranks to resume
    one = Trainer(PConfig.from_dict(as_dict(jconfig(d, "one_a", model=1))), params=init,
                  device="cpu")
    one.train_step([batch])
    ckpt_a = one.save()

    flags = dict(use_pallas_attention=True, use_pallas_conv=True, use_pallas_rnnt=True,
                 use_pallas_ctc=True, use_pallas_joint=True)
    common = {"kind": "tp", "batch": str(d / "batch.npz")}
    w2 = [
        {**common, "name": "step", "config": as_dict(c_m2), "params": str(d / "init.npz"),
         "grads": True, "step": True},
        {**common, "name": "full", "config": as_dict(c_full), "params": str(d / "full.npz"),
         "grads": True},
        {**common, "name": "full_k", "config": as_dict(c_full, **flags),
         "params": str(d / "full.npz"), "grads": True},
        {**common, "name": "ckpt", "config": as_dict(jconfig(d, "ckpt")),
         "params": str(d / "init.npz"), "ckpt_in": ckpt_a},
        {**common, "name": "val", "config": as_dict(jconfig(d, "val")),
         "params": str(d / "init.npz"), "validate": str(d / "dev.npz"),
         "modes": ["greedy_rnnt", "beam_rnnt"]},
    ]
    w4 = [
        {**common, "name": "d2", "config": as_dict(c_d2), "params": str(d / "init.npz"),
         "grads": True},
        {**common, "name": "d2f", "config": as_dict(c_d2f), "params": str(d / "full.npz"),
         "grads": True},
        {**common, "name": "s2m2", "config": as_dict(c_s2m2), "params": str(d / "init.npz"),
         "grads": True, "step": True},
    ]
    procs = main_runs(d)
    for world, cases in ((2, w2), (4, w4)):
        (d / f"w{world}").mkdir()
        procs += launch(REPO, world, cases, str(d / f"w{world}"))

    # the JAX side, while the ranks run
    jax_out = {"step": (j_step_loss, j_step_g, j_step_p, init)}
    jax_out["full"] = jax_grads(c_full, p_full, batch, j_make_mesh(1, 2))
    jax_out["d2"] = jax_grads(c_d2, init, batch, j_make_mesh(2, 2))
    jax_out["d2f"] = jax_grads(c_d2f, p_full, batch, j_make_mesh(2, 2))
    _, s_g, s_loss, s_p = jax_trainer_step(c_s2m2, batch)
    jax_out["s2m2"] = (s_loss, s_g, s_p, init)

    # the one-process references of the checkpoint and validate cases
    ref = {}
    one = Trainer(PConfig.from_dict(as_dict(jconfig(d, "one_b", model=1))), params=init,
                  device="cpu")
    one.restore(ckpt_a)
    ref["loss2"] = one.train_step([batch])["loss"]
    ref["mu2"] = {k: v.numpy() for k, v in one.opt_state.mu.items()}
    vcfg = PConfig.from_dict(as_dict(jconfig(d, "one_val", model=1)))
    one = Trainer(vcfg, params=init, device="cpu")
    dev_b = [{"feats": dev[f"feats{r}"], "feat_lengths": dev[f"lens{r}"],
              "keys": [f"r{r}u{i}" for i in range(2)],
              "transcripts": [str(t) for t in dev[f"text{r}"]]} for r in range(2)]
    for mode in ("greedy_rnnt", "beam_rnnt"):
        one.cfg.decode.mode = mode
        ref[f"wer:{mode}"] = one.validate(dev_b)
        ref[f"pred:{mode}"] = (d / "one_val" / "tmp_prediction.txt").read_text()
    failed = join(procs, TIMEOUT)
    assert not failed, "\n".join(failed)
    return {"dir": d, "jax": jax_out, "ref": ref, "batch": batch, "ckpt_a": ckpt_a,
            "lr": float(c_m2.train.lr) * c_m2.train.warmup_steps ** -1.0}


def _rank(runs, world, name, r):
    return np.load(runs["dir"] / f"w{world}" / f"{name}.rank{r}.npz")


def _by(res, prefix):
    return {k[len(prefix):]: res[k] for k in res.files if k.startswith(prefix)}


def assert_grads(got: dict, want: dict):
    """Every trainable leaf within 1e-4 of its largest magnitude (floor:
    1e-6 of the largest gradient of all leaves)."""
    want = {k: v for k, v in want.items() if is_trainable(k)}
    assert set(got) == set(want)
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0,
                                   atol=max(1e-4 * np.abs(want[k]).max(), floor), err_msg=k)


def assert_stepped(got: dict, before: dict, want: dict, grads: dict, lr: float):
    """Params after one Adam step (the module docstring's rule)."""
    grads = {k: v for k, v in grads.items() if is_trainable(k)}
    floor = 1e-6 * max(np.abs(w).max() for w in grads.values())
    for k, g in grads.items():
        tol_g = max(1e-4 * np.abs(g).max(), floor)
        unsure = np.abs(g) <= tol_g
        assert np.all(np.abs(got[k] - before[k])[unsure] <= lr * (1 + 1e-5)), k
        np.testing.assert_allclose(got[k][~unsure], want[k][~unsure], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(), err_msg=k)


# ------------------------------------------------------------- spec table


@pytest.mark.parametrize("source", ["tiny", "tiny_decoder", "conformer_m", "conformer_l"])
def test_spec_table_matches_jax(source):
    """``model_axis`` names, for every leaf of the params, the axis JAX's
    ``_spec_for`` puts on "model" (and the port's init has the same
    leaves)."""
    if source.startswith("tiny"):
        mcfg = tiny_test_config().model
        if source == "tiny_decoder":
            mcfg.decoder_num_layers, mcfg.attention_weight, mcfg.use_pruned_loss = 1, 0.3, True
    else:
        mcfg = JConfig.from_json_file(os.path.join(REPO, "configs", f"{source}.json")).model
    shapes = jax.eval_shape(lambda k: j_init(k, mcfg), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    split = 0
    for path, leaf in flat:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path)
        spec = tuple(_spec_for(name, len(leaf.shape)))
        want = spec.index("model") if "model" in spec else None
        assert model_axis(name, len(leaf.shape)) == want, name
        split += want is not None
    assert split >= 10
    if source.startswith("tiny"):
        port = p_init(PConfig.from_dict(as_dict(JConfig(model=mcfg))).model, 0)
        assert sorted(k for k, _ in leaf_paths(port)) == sorted(
            ".".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path)
            for path, _ in flat)


def test_vocab_that_does_not_split_raises_like_jax():
    """V = 5002 over model 4: JAX's ``device_put`` raises ValueError, and so
    does ``shard_params``, before any leaf is cut; over model 2 the
    vocabulary leaves split in halves of 2501."""
    w = np.zeros((8, 5002), np.float32)
    with pytest.raises(ValueError, match="divisible by 4"):
        jax.device_put(w, jax.sharding.NamedSharding(j_make_mesh(2, 4), P(None, "model")))
    tree = {"joint": {"ffn_out": {"kernel": torch.zeros(8, 5002)}},
            "encoder": {"x": torch.zeros(3)}}
    with pytest.raises(ValueError, match="do not split over model=4"):
        shard_params(tree, Mesh(shape={"data": 2, "model": 4}, coords={"data": 0, "model": 1}))
    half = shard_params(tree, Mesh(shape={"model": 2}, coords={"model": 1}))
    assert half["joint"]["ffn_out"]["kernel"].shape == (8, 2501)
    assert half["encoder"]["x"] is tree["encoder"]["x"]


# ------------------------------------------------------------- keep-mask


def test_keep_mask_at_head_offset_matches_jax():
    """Heads 2-3 of 4 (``h_total=4, h_offset=2``): bit for bit JAX's
    ``_tile_keep_mask`` of those heads of the whole attention."""
    seed, tq, tk, rate = 123457, 37, 29, 0.1
    got = ra.keep_mask(torch.tensor([seed], dtype=torch.int32), 2, 2, tq, tk, rate, "cpu",
                       h_total=4, h_offset=2)
    for b in range(2):
        for h in range(2):
            want = np.asarray(_tile_keep_mask(jnp.int32(seed), jnp.int32(b), jnp.int32(2 + h),
                                              jnp.int32(0), jnp.int32(0), 4, (tq, tk), rate))
            np.testing.assert_array_equal(got[b, h].numpy(), want)


def test_attention_at_head_offset_is_the_whole_attentions_heads():
    """The attention wrapper on heads 2-3 of 4 at offset 2, with dropout,
    forward and backward, equals heads 2-3 of the whole attention."""
    g = torch.Generator().manual_seed(0)
    b, h, tq, tk, dk, d = 2, 4, 9, 11, 8, 32
    q, k, v = (torch.randn(b, h, n, dk, generator=g) for n in (tq, tk, tk))
    ab = torch.randn(b, h, tq, d, generator=g)
    feats = torch.randn(tk, d, generator=g)
    mask = torch.rand(b, tq, tk, generator=g) > 0.2
    seed = torch.tensor([99], dtype=torch.int32)
    kw = dict(scale=0.3, dropout_rate=0.2, seed=seed)
    whole = [x.clone().requires_grad_() for x in (q, ab, k, v)]
    out = ra.rel_flash_attention(*whole, feats, mask, **kw)
    out[:, 2:].sum().backward()
    part = [x[:, 2:].clone().requires_grad_() for x in (q, ab, k, v)]
    out2 = ra.rel_flash_attention(*part, feats, mask, h_total=4, h_offset=2, **kw)
    out2.sum().backward()
    np.testing.assert_allclose(out2.detach(), out[:, 2:].detach(), rtol=1e-6, atol=1e-7)
    for x, y in zip(part, whole):
        np.testing.assert_allclose(x.grad, y.grad[:, 2:], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="do not lie in h_total=4"):
        ra.rel_attention(*part, feats, mask, h_total=4, h_offset=3, **kw)


# ------------------------------------------------------------- against JAX


# the leaves whose gradient JAX's program on the mesh doubles (module docstring)
DOUBLED = {"d2": ["encoder.layers.conv_module.depthwise_conv.kernel"],
           "d2f": ["encoder.layers.conv_module.depthwise_conv.kernel"],
           "s2m2": ["encoder.layers.conv_module.depthwise_conv.kernel",
                    "encoder.embed.conv2.kernel"]}


def undoubled(runs, name, want: dict) -> dict:
    """JAX's gradients of case ``name`` with its ``DOUBLED`` leaves
    replaced by JAX's (data 1, model 2) gradient of the same loss, after
    checking that they are twice it."""
    if name not in DOUBLED:
        return want
    one_data = runs["jax"]["full" if name == "d2f" else "step"][1]
    want = dict(want)
    for k in DOUBLED[name]:
        np.testing.assert_allclose(want[k], 2 * one_data[k], rtol=1e-4,
                                   atol=1e-6 * np.abs(one_data[k]).max(), err_msg=k)
        want[k] = one_data[k]
    return want


@pytest.mark.parametrize("name", ["full", "full_k", "d2", "d2f"])
def test_loss_and_gradients_match_jax(runs, name):
    """(data 1, model 2) full lattice with the attention decoder, plain
    and through the kernels' routes; (data 2, model 2) pruned, and full
    lattice with the decoder: every rank's loss within 1e-5 relative of
    JAX's, the reduced gradients gathered over "model" equal on every rank
    and JAX's (the depthwise conv kernel at data 2: ``undoubled``)."""
    world = 4 if name.startswith("d2") else 2
    loss, want = runs["jax"]["full" if name == "full_k" else name]
    want = undoubled(runs, name, want)
    ranks = [_rank(runs, world, name, r) for r in range(world)]
    for res in ranks:
        np.testing.assert_allclose(res["metrics"][0], loss, rtol=1e-5)
    assert_grads(_by(ranks[0], "g:"), want)
    for res in ranks[1:]:
        for k, g in _by(res, "g:").items():
            np.testing.assert_allclose(g, ranks[0][f"g:{k}"], rtol=1e-6, atol=1e-9, err_msg=k)
    if name == "d2f":
        assert any("decoder" in k and "self_attn" in k for k in _by(ranks[0], "g:"))


@pytest.mark.parametrize("name", ["step", "s2m2"])
def test_trainer_step_matches_jax(runs, name):
    """``Trainer`` at model 2 and at seq 2 x model 2: the step's loss,
    gradients and norm, and the params after one step, against JAX's
    ``Trainer`` on the same mesh (at seq 2 x model 2, where JAX doubles two
    leaves' gradients, the norm and the params after the step against its
    (data 1, model 2) ``Trainer``'s); every rank alike."""
    world = 2 if name == "step" else 4
    loss, grads, after, before = runs["jax"][name]
    grads = undoubled(runs, name, grads)
    if name in DOUBLED:         # JAX's params after its step took the doubled gradients
        after = runs["jax"]["step"][2]
    ranks = [_rank(runs, world, name, r) for r in range(world)]
    norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum() for k, g in grads.items()
                       if is_trainable(k)))
    assert_grads(_by(ranks[0], "g:"), grads)
    before = dict(leaf_paths(before))
    for res in ranks:
        np.testing.assert_allclose(res["metrics"][0], loss, rtol=1e-5)
        np.testing.assert_allclose(res["step_loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(res["norm"], norm, rtol=1e-5)
        np.testing.assert_allclose(res["step_norm"], norm, rtol=1e-5)
        assert_stepped(_by(res, "p:"), before, after, grads, runs["lr"])
    assert sorted(tuple(r["coords"]) for r in ranks) == sorted(
        (0, s, m) for s in range(world // 2) for m in range(2))


# ------------------------------------------------------------- checkpoints and validate


def test_checkpoints_resume_both_ways(runs):
    """A one-process checkpoint restores at model 2 to exactly its state
    and resumes: the step's loss is the one-process resumed step's, its
    Adam moments within the gradients' tolerance. The model-2 save is the
    one-process layout, bit for bit the ranks' gathered params and
    moments, and resumes in one process to the ranks' next step's loss."""
    res = _rank(runs, 2, "ckpt", 0)
    ref = runs["ref"]
    state = ckpt_mod.restore_checkpoint(runs["ckpt_a"], "cpu")
    for k, v in leaf_paths(state["params"]):
        np.testing.assert_array_equal(res[f"r:{k}"], v.numpy(), err_msg=k)
    for k, v in state["opt_state"]["mu"].items():
        np.testing.assert_array_equal(res[f"rmu:{k}"], v.numpy(), err_msg=k)
    np.testing.assert_allclose(res["loss2"], ref["loss2"], rtol=1e-5)
    assert_grads(_by(res, "mu2:"), ref["mu2"])
    one = Trainer(PConfig.from_dict(as_dict(jconfig(runs["dir"], "one_c", model=1))),
                  device="cpu")
    one.restore(str(res["ckpt"]))
    assert one.step == 2 and one.opt_state.count == 2
    for k, v in leaf_paths(one.params):
        np.testing.assert_array_equal(v.detach().numpy(), res[f"p2:{k}"], err_msg=k)
    for k, v in one.opt_state.mu.items():
        np.testing.assert_array_equal(v.numpy(), res[f"mu2:{k}"], err_msg=k)
    np.testing.assert_allclose(one.train_step([runs["batch"]])["loss"], res["loss3"], rtol=1e-5)
    rank1 = _rank(runs, 2, "ckpt", 1)
    assert str(rank1["ckpt"]) == ""
    for k in res.files:
        if k not in ("ckpt", "coords"):
            np.testing.assert_array_equal(rank1[k], res[k], err_msg=k)


def test_main_with_mesh_model_matches_one_process(runs):
    """``main --train --coordinator`` at ``train.mesh_model=2`` (dropout
    0.1 as tiny_test_config has it): each step's losses and gradient norm,
    and the validation's WER, are the one-process command's; rank 0 writes
    the checkpoints, in the one-process layout."""
    d = runs["dir"]

    def records(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    got, want = records(d / "main_m2" / "metrics.jsonl"), records(d / "main_one" / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 2]
    for g, w in zip(got, want):
        for k in ("train_loss", "train_loss_ctc", "train_loss_rnnt", "train_grad_norm",
                  "valid_wer"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    one = ckpt_mod.restore_checkpoint(str(d / "main_one" / "step_2"), "cpu")
    m2 = ckpt_mod.restore_checkpoint(str(d / "main_m2" / "step_2"), "cpu")
    assert m2["step"] == one["step"] == 2
    for (k, a), (k2, b) in zip(leaf_paths(m2["params"]), leaf_paths(one["params"])):
        assert k == k2 and a.shape == b.shape, k
    assert not (d / "main_m2" / "metrics.rank0.jsonl").exists()


@pytest.mark.parametrize("mode", ["greedy_rnnt", "beam_rnnt"])
def test_validate_at_model_2_gives_one_process_wer(runs, mode):
    """``validate`` at model 2 (each rank decodes its batch on the whole,
    gathered params; the counts summed) gives the one-process WER."""
    ranks = [_rank(runs, 2, "val", r) for r in range(2)]
    for res in ranks:
        assert res[f"wer:{mode}"] == runs["ref"][f"wer:{mode}"]
    assert "".join(str(res[f"pred:{mode}"]) for res in ranks) == runs["ref"][f"pred:{mode}"]
