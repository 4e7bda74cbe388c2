"""The port's sequence parallelism (``parallel/sequence.py``) against JAX's
``encoder_forward_seq`` on its 8 virtual CPU devices, at the shapes of
tests/test_sequence_parallel.py: T = 260 (T' = 64, no padding) and T =
256 (T' = 63: the pad path), at 2 ranks (seq 2) and 4 (data 2 x seq 2),
plain and with both kernel flags on (on the CPU the wrappers take their
plain versions, down the kernels' paths: a query shard at positions
r T'/S.., the conv block on a halo'd window), and one trainer step with
``mesh_seq=2`` against JAX's gradient of the same loss.

One set of processes per world size, started together by a module
fixture; the JAX side runs here meanwhile. The gradient check uses
sum(mask * out * R) for a fixed random R: JAX's own test takes the sum of
squares, which the final LayerNorm makes nearly constant.
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conformer_tpu.config import tiny_test_config
from conformer_tpu.models.encoder import init_encoder
from conformer_tpu.models.transducer import init_transducer, transducer_forward
from conformer_tpu.parallel.sequence import encoder_forward_seq, make_seq_mesh
from conformer_tpu_torch.train.checkpoint import save_params_npz
from conformer_tpu_torch.train.optimizer import leaf_paths

from torch_mp_worker import join, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
LENS = {260: [260, 200, 133, 64], 256: [256, 200, 133, 64]}
WORLDS = {2: 1, 4: 2}          # world size: data axis (seq 2)


def _tree(jtree):
    return jax.tree.map(np.asarray, jtree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    cfg = tiny_test_config()
    mcfg = cfg.model
    enc_p = init_encoder(jax.random.PRNGKey(0), mcfg)
    save_params_npz(str(d / "enc.npz"), {"encoder": _tree(enc_p)})
    rs = np.random.RandomState(1)
    batches = {}
    for t, lens in LENS.items():
        t_out = ((t - 1) // 2 - 1) // 2
        batches[t] = {"feats": rs.randn(4, t, mcfg.input_dim).astype(np.float32),
                      "lens": np.asarray(lens, np.int32),
                      "probe": rs.randn(4, t_out, mcfg.encoder_dim).astype(np.float32)}
        np.savez(d / f"b{t}.npz", **batches[t])
    flags = dataclasses.replace(mcfg, use_pallas_attention=True, use_pallas_conv=True)
    plain_md, flags_md = (json.loads(json.dumps(dataclasses.asdict(m), default=list))
                          for m in (mcfg, flags))

    # the trainer step: tiny_test_config without dropout, 4 rows, seq 2
    tcfg = tiny_test_config()
    m = tcfg.model
    m.dropout = m.attention_dropout = m.pos_enc_dropout = 0.0
    m.predictor_embed_dropout = m.predictor_dropout = 0.0
    tcfg.train.mesh_seq, tcfg.train.mesh_data = 2, -1
    tp = init_transducer(jax.random.PRNGKey(2), m)
    save_params_npz(str(d / "full.npz"), _tree(tp))
    step_b = {"feats": batches[260]["feats"],
              "feat_lengths": batches[260]["lens"],
              "labels": rs.randint(1, m.vocab_size - 2, (4, 6)).astype(np.int32),
              "label_lengths": np.array([6, 5, 3, 6], np.int32)}
    np.savez(d / "step.npz", **step_b)

    procs = []
    for world, data in WORLDS.items():
        out = d / f"w{world}"
        out.mkdir()
        cases = [{"kind": "seq", "name": f"seq{t}{tag}", "model": md, "data": data, "seq": 2,
                  "params": str(d / "enc.npz"), "batch": str(d / f"b{t}.npz"),
                  "grads": t == 260}
                 for t in LENS for tag, md in (("", plain_md), ("k", flags_md))]
        if world == 4:
            rows = {str(r): [2 * (r // 2), 2 * (r // 2) + 1] for r in range(4)}
            cases.append({"kind": "trainer_grads", "name": "step",
                          "config": json.loads(json.dumps(dataclasses.asdict(tcfg),
                                                          default=list)),
                          "params": str(d / "full.npz"), "batch": str(d / "step.npz"),
                          "rows": rows, "step": True})
        procs += launch(REPO, world, cases, str(out))

    # the JAX side, while the ranks run
    mesh = make_seq_mesh(2, 2)
    jax_out = {}
    for t, b in batches.items():
        jax_out[t] = np.asarray(jax.jit(lambda p, f, l: encoder_forward_seq(
            p, f, l, mcfg, mesh=mesh)[0])(enc_p, jnp.asarray(b["feats"]), jnp.asarray(b["lens"])))

    def probe_loss(p, b):
        out, mask = encoder_forward_seq(p, b["feats"], b["lens"], mcfg, mesh=mesh)
        return jnp.sum(jnp.where(mask[..., None], out, 0.0) * b["probe"])

    jb = {k: jnp.asarray(v) for k, v in batches[260].items()}
    jax_grads = dict(leaf_paths(_tree(jax.jit(jax.grad(probe_loss))(enc_p, jb))))

    def step_loss(p, b):
        out = transducer_forward(p, *(b[k] for k in ("feats", "feat_lengths", "labels",
                                                     "label_lengths")), m,
                                 deterministic=True,
                                 encoder_fn=partial(encoder_forward_seq, mesh=mesh))
        return out["loss"]

    sb = {k: jnp.asarray(v) for k, v in step_b.items()}
    loss, g = jax.jit(jax.value_and_grad(step_loss))(tp, sb)
    failed = join(procs, TIMEOUT)
    assert not failed, "\n".join(failed)
    return {"dir": d, "out": jax_out, "grads": jax_grads, "step_loss": float(loss),
            "step_grads": dict(leaf_paths(_tree(g)))}


def _rank(runs, world, name, r):
    return np.load(runs["dir"] / f"w{world}" / f"{name}.rank{r}.npz")


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("t", list(LENS))
@pytest.mark.parametrize("flags", ["plain", "kernel_flags"])
def test_forward_matches_jax(runs, world, t, flags):
    """Every rank returns its data shard's whole [B, T', D] output, JAX's
    within 2e-5; the pad path's output is cropped back to T' = 63."""
    data = WORLDS[world]
    rows = 4 // data
    for r in range(world):
        res = _rank(runs, world, f"seq{t}{'k' if flags != 'plain' else ''}", r)
        dc = r // 2
        want = runs["out"][t][dc * rows:(dc + 1) * rows]
        assert res["out"].shape == want.shape == (rows, ((t - 1) // 2 - 1) // 2, 64)
        np.testing.assert_allclose(res["out"], want, rtol=2e-5, atol=2e-5)
        lens = ((np.asarray(LENS[t]) - 1) // 2 - 1) // 2
        np.testing.assert_array_equal(
            res["mask"], np.arange(want.shape[1])[None] < lens[dc * rows:(dc + 1) * rows, None])


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("flags", ["plain", "kernel_flags"])
def test_gradients_match_jax(runs, world, flags):
    """The gradients of the probe loss over the global batch, summed over
    the seq group and then the data group, equal JAX's."""
    res = _rank(runs, world, f"seq260{'k' if flags != 'plain' else ''}", 0)
    got = {k[2:]: res[k] for k in res.files if k.startswith("g:")}
    assert set(got) == {k for k in runs["grads"] if "pos_table" not in k}
    for k, g in got.items():
        np.testing.assert_allclose(g, runs["grads"][k], rtol=5e-4, atol=1e-4, err_msg=k)


def test_trainer_step_with_mesh_seq_matches_jax(runs):
    """``Trainer`` at data 2 x seq 2 (``train.mesh_seq=2``): the step's
    loss and reduced gradients equal JAX's through ``encoder_forward_seq``
    on the joined batch; every rank holds the same; the step then runs."""
    ranks = [_rank(runs, 4, "step", r) for r in range(4)]
    np.testing.assert_allclose(ranks[0]["metrics"][0], runs["step_loss"], rtol=2e-5)
    want = runs["step_grads"]
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    got = {k[2:]: ranks[0][k] for k in ranks[0].files if k.startswith("g:")}
    assert set(got) == {k for k in want if "pos_table" not in k}
    for k, g in got.items():
        for other in ranks[1:]:
            np.testing.assert_array_equal(g, other[f"g:{k}"], err_msg=k)
        np.testing.assert_allclose(g, want[k], rtol=5e-4, atol=floor, err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r["step_loss"], runs["step_loss"], rtol=2e-5)
        assert np.isfinite(r["step_norm"])
