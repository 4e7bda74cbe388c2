"""The port's multi-process runtime and data parallelism against the JAX
package, on the CPU over gloo.

One set of processes for the file (a module fixture): the two ranks of
``python -m conformer_tpu_torch.main --train --coordinator ...
--num_processes 2`` on the corpus of tests/test_multiprocess.py, and two
ranks of tests/torch_mp_worker.py for the library cases. Meanwhile the JAX
side runs here: its one-process ``Trainer`` on the same 4-row global
batches, and its gradient of the joined batch of the unequal-rows case.
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
import torch.distributed as dist

from conformer_tpu.config import tiny_test_config
from conformer_tpu.data import audio
from conformer_tpu.data import native as j_native
from conformer_tpu.data.dataset import AsrDataset as JDataset
from conformer_tpu.data.dataset import eval_config as j_eval_config
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.models.transducer import transducer_forward as j_forward
from conformer_tpu.train.loop import Trainer as JTrainer
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.parallel import distributed as pdist
from conformer_tpu_torch.train import checkpoint as p_ckpt
from conformer_tpu_torch.train.loop import Trainer, make_train_state, make_trainer_mesh
from conformer_tpu_torch.train.optimizer import make_optimizer

from torch_mp_worker import free_port, join, launch, worker_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240          # seconds for every process of the file, in all
STEPS = 3


def mp_config(ws: dict, ckpt_dir: str, max_frames: int):
    """tests/mp_worker.py's config: one 64-frame bucket, no dropout,
    nothing random in the data."""
    cfg = tiny_test_config()
    m = cfg.model
    m.vocab_size, m.sos_eos_id, m.encoder_num_layers, m.hidden_dim = 6, 5, 1, 64
    m.dropout = m.attention_dropout = m.pos_enc_dropout = 0.0
    m.predictor_embed_dropout = m.predictor_dropout = 0.0
    d = cfg.data
    d.train_data_list_path = d.dev_data_list_path = d.test_data_list_path = ws["list"]
    d.vocab_path = ws["vocab"]
    d.dither, d.speed_perturb, d.spec_aug, d.shuffle, d.sort = 0.0, False, False, False, False
    d.filter_data, d.batch_type, d.bucket_boundaries = False, "bucket", (64,)
    d.max_frames_in_batch, d.max_label_len, d.prefetch_depth = max_frames, 8, 0
    t = cfg.train
    t.checkpoint_dir, t.accum_grad, t.warmup_steps, t.num_sanity_val_steps = ckpt_dir, 1, 10, 0
    t.max_steps, t.val_check_interval, t.log_every, t.mesh_data = STEPS, STEPS, 1, 1
    cfg.decode.n_steps, cfg.decode.max_hyp_len = 4, 16
    return cfg


def grads_config() -> dict:
    """The unequal-rows case's config: tiny_test_config without dropout."""
    cfg = tiny_test_config()
    m = cfg.model
    m.dropout = m.attention_dropout = m.pos_enc_dropout = 0.0
    m.predictor_embed_dropout = m.predictor_dropout = 0.0
    return cfg


def unequal_batch(cfg) -> dict:
    """A 4-row global batch whose last row is a bucket-padding dummy
    (feat_length 0): rank 0 holds 2 valid rows, rank 1 one."""
    rs = np.random.RandomState(0)
    b, t, u = 4, 64, 6
    return {"feats": rs.randn(b, t, cfg.model.input_dim).astype(np.float32),
            "feat_lengths": np.array([64, 51, 40, 0], np.int32),
            "labels": rs.randint(1, cfg.model.vocab_size - 1, (b, u)).astype(np.int32),
            "label_lengths": np.array([6, 4, 5, 0], np.int32)}


def port_checkpoint(jparams, path_dir: str, cfg) -> str:
    """A port checkpoint at step 0 holding JAX's initial params (the
    ranks of ``main`` resume from it, so both packages start alike)."""
    from conformer_tpu_torch.params import from_jax_params

    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    opt = make_optimizer(cfg.train)[0].init(params)
    state = make_train_state(params, {"count": 0, "mu": opt.mu, "nu": opt.nu}, 0)
    return p_ckpt.save_checkpoint(path_dir, state, step=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    texts = ["AB", "BA", "AA", "BB", "AB", "BA", "AA", "BB"]
    with open(d / "data.list", "w") as f:
        for i, text in enumerate(texts):
            wav = (0.2 * np.sin(2 * np.pi * (300 + 100 * i) * np.arange(6400) / 16000)
                   + 0.01 * rng.standard_normal(6400)).astype(np.float32)
            audio.save_wav(str(d / f"u{i}.wav"), wav, 16000)
            f.write(json.dumps({"key": f"u{i}", "wav_path": str(d / f"u{i}.wav"),
                                "transcript": text}) + "\n")
    with open(d / "vocab.txt", "w") as f:
        for i, w in enumerate(["<blank>", "<unk>", "A", "B", "_", "<sos/eos>"]):
            f.write(f"{w} {i}\n")
    ws = {"list": str(d / "data.list"), "vocab": str(d / "vocab.txt")}
    # both pipelines on their numpy feature paths: the ranks find no g++
    monkeypatch_module.setattr(j_native, "native_available", lambda: False)
    (d / "bin").mkdir()

    jcfg = mp_config(ws, str(d / "jax"), 256)
    jt = JTrainer(jcfg)
    init = port_checkpoint(jt.state["params"], str(d / "init"), jcfg)
    pcfg = mp_config(ws, str(d / "ckpt_n2"), 128)
    pcfg.train.mesh_data = -1           # the data axis over both ranks
    with open(d / "cfg.json", "w") as f:
        json.dump(dataclasses.asdict(pcfg), f, default=list)
    port = free_port()
    env = {**worker_env(REPO), "PATH": str(d / "bin")}
    main_procs = []
    for rank in range(2):
        log = open(d / f"main.rank{rank}.log", "w")
        main_procs.append((subprocess.Popen(
            [sys.executable, "-m", "conformer_tpu_torch.main", "--config", str(d / "cfg.json"),
             "--device", "cpu", "--train", "--coordinator", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(rank), "--resume_from", init],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))

    gcfg = grads_config()
    jp = j_init(jax.random.PRNGKey(4), gcfg.model)
    from conformer_tpu_torch.train.checkpoint import save_params_npz

    save_params_npz(str(d / "gparams.npz"), jax.tree.map(np.asarray, jp))
    batch = unequal_batch(gcfg)
    np.savez(d / "gbatch.npz", **batch)
    ccfg = grads_config()
    ccfg.model.use_dynamic_chunk = ccfg.model.use_dynamic_left_chunk = True
    rows = {"0": [0, 1], "1": [2, 3]}
    cases = [{"kind": "host", "name": "host"},
             {"kind": "trainer_grads", "name": "unequal", "config": dataclasses.asdict(gcfg),
              "params": str(d / "gparams.npz"), "batch": str(d / "gbatch.npz"), "rows": rows},
             {"kind": "chunks", "name": "chunks", "config": dataclasses.asdict(ccfg),
              "params": str(d / "gparams.npz"), "batch": str(d / "gbatch.npz"), "rows": rows,
              "steps": 4},
             {"kind": "mismatch", "name": "mismatch", "config": dataclasses.asdict(gcfg),
              "params": str(d / "gparams.npz"), "batch": str(d / "gbatch.npz"), "rows": rows,
              "cut": 16}]
    for c in cases:
        if "config" in c:
            c["config"] = json.loads(json.dumps(c["config"], default=list))
    workers = launch(REPO, 2, cases, str(d))

    # the JAX side, while the ranks run
    train_ds = JDataset(jcfg.data, mode="train", tokenizer=jt.tokenizer)
    dev_ds = JDataset(j_eval_config(jcfg.data), mode="dev", tokenizer=jt.tokenizer)
    stream, losses = jt._train_stream(train_ds), []
    while len(losses) < STEPS:
        epoch, b = next(stream)
        if epoch is not None:
            losses.append(jt.train_step([b])["loss"])
    jax_run = {"losses": losses, "wer": jt.validate(dev_ds)}

    def loss_fn(p, b):
        out = j_forward(p, *(b[k] for k in ("feats", "feat_lengths", "labels", "label_lengths")),
                        gcfg.model, deterministic=True)
        return out["loss"], out

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp, jb)
    # what a mean over each rank's own valid rows would give
    loss_of = jax.jit(lambda p, b: loss_fn(p, b)[0])
    halves = [float(loss_of(jp, {k: v[np.array(r)] for k, v in jb.items()}))
              for r in rows.values()]
    failed = join(main_procs + workers, TIMEOUT)
    assert not failed, "\n".join(failed)
    return {"dir": d, "jax": jax_run, "jgrads": jgrads, "jloss": float(jout["loss"]),
            "per_rank_mean": sum(halves) / 2}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_main_two_ranks_match_jax_one_process(runs):
    """2 ranks x 2-row batches of ``main --train`` = JAX's one-process
    Trainer on the same 4-row global batches: losses, the validation's
    WER, rank 0's checkpoint, both prediction files."""
    ckpt = runs["dir"] / "ckpt_n2"
    recs = _records(str(ckpt / "metrics.jsonl"))
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    np.testing.assert_allclose(losses, runs["jax"]["losses"], rtol=2e-4)
    wers = [r["valid_wer"] for r in recs if "valid_wer" in r]
    assert wers == [pytest.approx(runs["jax"]["wer"], abs=1e-9)]
    rank1 = [r["train_loss"] for r in _records(str(ckpt / "metrics.rank1.jsonl"))
             if "train_loss" in r]
    assert rank1 == losses          # every rank logs the global loss
    names = sorted(os.listdir(ckpt))
    assert names == sorted(["last", "params_last", f"step_{STEPS}", "metrics.jsonl",
                            "metrics.rank1.jsonl", "tmp_prediction.rank0.txt",
                            "tmp_prediction.rank1.txt",
                            f"step_{STEPS}-wer_{runs['jax']['wer']:.6f}"])
    state = p_ckpt.restore_checkpoint(str(ckpt / f"step_{STEPS}"))
    assert state["step"] == STEPS and state["opt_state"]["count"] == STEPS
    keys = set()
    for rank in range(2):
        text = (ckpt / f"tmp_prediction.rank{rank}.txt").read_text()
        keys |= {line.split()[1] for line in text.splitlines() if line.startswith("Key:")}
    assert keys == {f"u{i}" for i in range(8)}      # each rank decoded its half


def test_unequal_valid_rows_match_jax_joined_batch(runs):
    """Rank 1 holds a feat_length-0 dummy row: the 2-rank step's gradients
    and loss equal JAX's on the joined batch (a mean per rank would not)."""
    from conformer_tpu_torch.train.optimizer import leaf_paths

    r0 = np.load(runs["dir"] / "unequal.rank0.npz")
    r1 = np.load(runs["dir"] / "unequal.rank1.npz")
    np.testing.assert_allclose(r0["metrics"][0], runs["jloss"], rtol=2e-5)
    want = {k: np.asarray(v) for k, v in leaf_paths(runs["jgrads"])}
    got = {k[2:]: r0[k] for k in r0.files if k.startswith("g:")}
    assert set(got) == {k for k in want if "pos_table" not in k}
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    norm = 0.0
    for k, g in got.items():
        np.testing.assert_array_equal(g, r1[f"g:{k}"])          # every rank has the sum
        np.testing.assert_allclose(g, want[k], rtol=5e-4, atol=floor, err_msg=k)
        norm += float(np.square(g.astype(np.float64)).sum())
    np.testing.assert_allclose(r0["norm"], np.sqrt(norm), rtol=1e-5)
    # a mean over each rank's own valid rows weighs rank 1's row twice
    assert abs(runs["per_rank_mean"] - runs["jloss"]) > 1e-2 * abs(runs["jloss"])


def test_unequal_local_shapes_raise(runs):
    """Data shards that present different local shapes (rank 1's rows 16
    frames shorter, as static or dynamic batching can give) would train on
    another loss than the global batch's: every rank raises, naming the
    dimension."""
    for r in range(2):
        msg = str(np.load(runs["dir"] / f"mismatch.rank{r}.npz")["raised"])
        assert "differ in ['frames']" in msg, msg
        assert f"'frames': {64 - 16 * r}" in msg, msg


def test_chunk_sizes_agree_across_ranks(runs):
    drawn = [json.load(open(runs["dir"] / f"chunks.rank{r}.json"))["drawn"] for r in range(2)]
    assert len(drawn[0]) == 4 and drawn[0] == drawn[1]
    assert len({tuple(x) for x in drawn[0]}) > 1       # the draws do move


def test_host_reductions_and_gather(runs):
    res = [json.load(open(runs["dir"] / f"host.rank{r}.json")) for r in range(2)]
    for r, h in enumerate(res):
        assert h["sums"] == {"a": 3.0, "b": 0.75}
        assert h["coords"] == {"data": r} and h["rows"] == list(range(4 * r, 4 * r + 4))
        assert h["slice"] == [4 * r, 4 * r + 4] and h["n"] == 3
        assert h["layers"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2     # stage order
        assert h["after_norm"] == [0.0, 1.0, 2.0] and h["step"] == 7


def test_initialization_flags_and_environment(monkeypatch):
    """Nothing configured: no group. The flags or CONFORMER_* make one
    (gloo on the CPU), torchrun's environment under
    CONFORMER_DISTRIBUTED=auto; a rank's card is cuda:<local rank>."""
    for k in ("CONFORMER_COORDINATOR", "CONFORMER_NUM_PROCESSES", "CONFORMER_PROCESS_ID",
              "CONFORMER_DISTRIBUTED", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert pdist.maybe_initialize_distributed(device="cpu") is False
    assert pdist.process_count() == 1 and not pdist.is_multiprocess()
    assert pdist.allsum_host_scalars({"x": 2.0}) == {"x": 2.0}
    with pytest.raises(ValueError):
        pdist.maybe_initialize_distributed(num_processes=2, device="cpu")
    with pytest.raises(ValueError):
        pdist.maybe_initialize_distributed("127.0.0.1:1", device="cpu")
    monkeypatch.setenv("CONFORMER_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("CONFORMER_NUM_PROCESSES", "1")
    monkeypatch.setenv("CONFORMER_PROCESS_ID", "0")
    try:
        assert pdist.maybe_initialize_distributed(device="cpu")
        assert dist.get_backend() == "gloo" and pdist.process_count() == 1
        assert pdist.maybe_initialize_distributed(device="cpu")     # twice is safe
        monkeypatch.setenv("LOCAL_RANK", "3")
        assert pdist.rank_device("cuda") == torch.device("cuda", 3)
        assert pdist.rank_device("cuda:1") == torch.device("cuda", 1)
        assert pdist.rank_device("cpu") == torch.device("cpu")
    finally:
        pdist.destroy()
    for k in ("CONFORMER_COORDINATOR", "CONFORMER_NUM_PROCESSES", "CONFORMER_PROCESS_ID"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("CONFORMER_DISTRIBUTED", "auto")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        assert pdist.maybe_initialize_distributed(device="cpu")
        assert dist.get_rank() == 0 and dist.get_world_size() == 1
    finally:
        pdist.destroy()
    assert not dist.is_initialized()


def test_model_axis_raises():
    """Pipeline x model raises "pick one" (JAX's assertion); a model or
    seq mesh raises ValueError where the processes do not fill it."""
    cfg = PConfig()
    cfg.train.mesh_model = 2
    with pytest.raises(ValueError, match="needs a multiple of 2 processes, have 1"):
        make_trainer_mesh(cfg.train)
    with pytest.raises(ValueError, match="needs a multiple of 2 processes, have 1"):
        Trainer(cfg, device="cpu")
    cfg.train.mesh_pipe = 2
    with pytest.raises(ValueError, match="pick one"):
        make_trainer_mesh(cfg.train)
    cfg = PConfig()
    cfg.train.mesh_seq = 2
    with pytest.raises(ValueError, match="needs a multiple of 2 processes, have 1"):
        make_trainer_mesh(cfg.train)
    cfg.train.mesh_model = 2
    with pytest.raises(ValueError, match="needs a multiple of 4 processes, have 1"):
        make_trainer_mesh(cfg.train)
