"""The port's training path against the JAX package at tiny width, float32:
masks, dropout, the predictor, ``transducer_forward`` with its losses and
gradients, the optimizer update and schedule, and ``Trainer.train_step``.

Parameters come from the JAX initialisers through ``from_jax_params``;
inputs from a seeded numpy generator. Where the JAX function reaches a
Pallas kernel it runs in interpret mode; the port takes the kernels'
plain versions on the CPU. Random draws (dropout, chunk sizes) cannot
match ``jax.random``: they are held by their statistics, and exactly at
rate 0 and at a given (chunk, left) pair. Tolerance 1e-4 abs and rel.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.models import masks as j_masks
from conformer_tpu.models import predictor as j_pred
from conformer_tpu.models import transducer as j_tr
from conformer_tpu.train import optimizer as j_opt
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.decode.greedy import greedy_search_batch
from conformer_tpu_torch.models import attention as p_att
from conformer_tpu_torch.models import layers as p_layers
from conformer_tpu_torch.models import masks as p_masks
from conformer_tpu_torch.models import predictor as p_pred
from conformer_tpu_torch.models import transducer as p_tr
from conformer_tpu_torch.ops.fbank import fbank_numpy
from conformer_tpu_torch.params import from_jax_params
from conformer_tpu_torch.train import loop as p_loop
from conformer_tpu_torch.train import optimizer as p_opt

TOL = dict(rtol=1e-4, atol=1e-4)


def _port_cfg(cfg):
    return PConfig.from_dict(dataclasses.asdict(cfg))


def _port_model(model_cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(model_cfg)}).model


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _paths(tree):
    return dict(p_opt.leaf_paths(tree))


# -------------------------------------------------------------- masks


@pytest.mark.parametrize("chunk,left", [(4, -1), (3, 1), (5, 0), (1, 2), (24, -1)])
def test_dynamic_chunk_mask_matches_jax(chunk, left):
    pad = np.arange(23)[None, :] < np.array([23, 9, 1])[:, None]
    want = j_masks.make_attn_mask(
        jnp.asarray(pad), use_dynamic_chunk=True, use_dynamic_left_chunk=True,
        decoding_chunk_size=chunk, static_chunk_size=-1, num_decoding_left_chunks=left)
    got = p_masks.make_attn_mask(torch.from_numpy(pad), static_chunk_size=-1,
                                 num_decoding_left_chunks=-1, dynamic_chunk=(chunk, left))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dynamic_chunk_sampler_distribution():
    """P(full context), the chunk sizes and the left counts against the
    JAX sampler's, over 4000 draws each (binomial sd of a share ~0.008)."""
    max_len, n = 94, 4000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    j_chunk, j_left = jax.vmap(lambda k: j_masks.sample_dynamic_chunk(k, max_len, True))(keys)
    j_chunk, j_left = np.asarray(j_chunk), np.asarray(j_left)
    gen = torch.Generator().manual_seed(0)
    draws = np.array([p_masks.sample_dynamic_chunk(gen, max_len, True) for _ in range(n)])
    p_chunk, p_left = draws[:, 0], draws[:, 1]
    full_p, full_j = p_chunk == max_len, j_chunk == max_len
    want_full = (max_len - 1 - max_len // 2) / (max_len - 1)
    assert abs(full_p.mean() - want_full) < 0.03 and abs(full_j.mean() - want_full) < 0.03
    assert (p_left[full_p] == -1).all()
    for c, lft in ((p_chunk[~full_p], p_left[~full_p]), (j_chunk[~full_j], j_left[~full_j])):
        assert c.min() == 1 and c.max() == 25
        assert lft.min() == 0 and lft.max() <= max_len - 2
    assert abs(p_chunk[~full_p].mean() - j_chunk[~full_j].mean()) < 1.0
    assert abs(p_left[~full_p].mean() - j_left[~full_j].mean()) < 4.0
    gen = torch.Generator().manual_seed(1)
    assert all(p_masks.sample_dynamic_chunk(gen, max_len, False)[1] == -1 for _ in range(50))


def test_add_blank_matches_jax():
    t = np.array([[3, 4, -1], [-1, -1, -1], [5, 1, 2]], np.int32)
    np.testing.assert_array_equal(p_masks.add_blank(torch.from_numpy(t), 0, -1).numpy(),
                                  np.asarray(j_masks.add_blank(jnp.asarray(t), 0, -1)))


# ------------------------------------------------------------ dropout


def test_dropout_keep_rate_and_rate_zero():
    x = torch.randn(200, 500, generator=torch.Generator().manual_seed(0)) + 3.0
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(p_layers.dropout(gen, x, 0.0, False), x)
    assert torch.equal(p_layers.dropout(gen, x, 0.1, True), x)
    assert torch.equal(p_layers.dropout(None, x, 0.1, True), x)
    y = p_layers.dropout(gen, x, 0.1, False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005        # sd 0.0006
    torch.testing.assert_close(y[kept], x[kept] / 0.9)
    with pytest.raises(ValueError):
        p_layers.dropout(None, x, 0.1, False)


def test_attention_kernel_in_training_raises():
    """The kernel path trains (tests/test_torch_attention_train.py), but
    live attention dropout without a generator raises."""
    cfg = tiny_test_config().model
    p = p_att.init_mhsa(torch.Generator().manual_seed(0), cfg.encoder_dim, cfg.num_heads)
    x = torch.randn(1, 5, cfg.encoder_dim)
    pos = torch.arange(5)
    with pytest.raises(ValueError, match="Generator"):
        p_att.mhsa(p, x, x, torch.ones(1, 5, 5, dtype=torch.bool), num_heads=cfg.num_heads,
                   rel_positions=(pos, pos), use_pallas=True, dropout_rate=0.1,
                   gen=None, deterministic=False)


# ----------------------------------------------------------- predictor


def test_predictor_forward_matches_jax():
    cfg = dataclasses.replace(tiny_test_config().model, predictor_num_layers=2)
    jp = j_pred.init_predictor(jax.random.PRNGKey(3), cfg)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    want = j_pred.predictor_forward(jp, jnp.asarray(tok), cfg)
    got = p_pred.predictor_forward(_to_torch(jp), torch.from_numpy(tok), _port_model(cfg))
    _close(got, want)


# ---------------------------------------------------- transducer forward


def _tiny_batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 67, cfg.input_dim)).astype(np.float32)
    feat_lens = np.array([67, 41, 0], np.int32)             # row 2: bucket padding
    labels = rng.integers(1, cfg.vocab_size - 1, (3, 5)).astype(np.int32)
    label_lens = np.array([5, 3, 0], np.int32)
    labels = np.where(np.arange(5)[None, :] < label_lens[:, None], labels, 0).astype(np.int32)
    return feats, feat_lens, labels, label_lens


@pytest.mark.parametrize("pruned", [True, False])
def test_transducer_forward_matches_jax(pruned):
    cfg = dataclasses.replace(tiny_test_config().model, use_pruned_loss=pruned, prune_range=3,
                              use_pallas_rnnt=True, use_pallas_ctc=True)
    jp = j_tr.init_transducer(jax.random.PRNGKey(6), cfg)
    batch = _tiny_batch(cfg)
    jb = [jnp.asarray(a) for a in batch]

    def j_loss(p):
        out = j_tr.transducer_forward(p, *jb, cfg, deterministic=True)
        return out["loss"], out

    j_g, j_out = jax.grad(j_loss, has_aux=True)(jp)
    pp = _to_torch(jp)
    for leaf in _paths(pp).values():
        leaf.requires_grad_(True)
    out = p_tr.transducer_forward(pp, *(torch.from_numpy(a) for a in batch), _port_model(cfg),
                                  deterministic=True)
    out["loss"].backward()
    keys = ["loss", "loss_ctc", "loss_rnnt"] + (["loss_simple"] if pruned else [])
    for k in keys:
        _close(out[k], j_out[k])
    _close(out["encoder_out"], j_out["encoder_out"])
    want_g = _paths(_to_torch(j_g))
    got = _paths(pp)
    assert set(got) == set(want_g)
    for k, leaf in got.items():
        _close(leaf.grad, want_g[k], err_msg=k)


def test_transducer_forward_training_mode_runs_and_draws():
    """deterministic=False: dropout and a dynamic chunk mask, drawn from
    the generators; the same seeds give the same loss."""
    cfg = dataclasses.replace(tiny_test_config().model, use_pruned_loss=True,
                              use_dynamic_chunk=True, use_dynamic_left_chunk=True)
    pcfg = _port_model(cfg)
    p = p_tr.init_transducer(pcfg, seed=0)
    batch = [torch.from_numpy(a) for a in _tiny_batch(cfg)]
    losses = []
    for seed in (1, 1, 2):
        out = p_tr.transducer_forward(p, *batch, pcfg, gen=torch.Generator().manual_seed(seed),
                                      host_gen=torch.Generator().manual_seed(seed))
        losses.append(float(out["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] and losses[0] != losses[2]
    det = float(p_tr.transducer_forward(p, *batch, pcfg, deterministic=True)["loss"])
    assert det != losses[0]


# ------------------------------------------------------------ optimizer


def test_schedule_matches_jax():
    for base, warm in ((1e-3, 25000), (3e-3, 5), (1e-3, 0)):
        js = j_opt.warmup_lr_schedule(base, warm)
        ps = p_opt.warmup_lr_schedule(base, warm)
        for step in (0, 1, 4, 5, 6, 24999, 25000, 100000):
            assert ps(step) == pytest.approx(float(js(jnp.asarray(step))), rel=1e-6)
    assert p_opt.warmup_lr_schedule(1e-3, 25000)(0) == pytest.approx(4e-8, rel=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])        # below and above the clip
def test_optimizer_updates_match_optax(grad_scale):
    """Every leaf moves as optax moves it, but the sinusoid tables: the
    encoder's pos_table and both attention decoders' (a decoder of one
    layer each way), which the port freezes, while the JAX package's
    optax.masked adds their raw gradients."""
    cfg = tiny_test_config()
    cfg.model = dataclasses.replace(cfg.model, decoder_num_layers=1, reverse_weight=0.3)
    jp = j_tr.init_transducer(jax.random.PRNGKey(7), cfg.model)
    tx, _ = j_opt.make_optimizer(cfg.train, jp)
    j_state = tx.init(jp)
    pp = _to_torch(jp)
    opt, _ = p_opt.make_optimizer(_port_cfg(cfg).train)
    p_state = opt.init(pp)
    rng = np.random.default_rng(8)
    tables = sorted(k for k in _paths(pp) if k.endswith("pos_table"))
    assert tables == ["decoder.left_decoder.pos_table", "decoder.right_decoder.pos_table",
                      "encoder.pos_table"]
    pos0 = {k: _paths(pp)[k].clone() for k in tables}
    for _ in range(2):                                         # bias correction, schedule
        j_grads = jax.tree.map(
            lambda a: jnp.asarray(grad_scale * rng.standard_normal(a.shape).astype(np.float32)),
            jp)
        upd, j_state = tx.update(j_grads, j_state, jp)
        j_new = optax.apply_updates(jp, upd)
        g = _paths(_to_torch(j_grads))
        lr, norm = opt.update(pp, {k: g[k] for k in p_state.mu}, p_state)
        want = _paths(_to_torch(j_new))
        for k, leaf in _paths(pp).items():
            if k not in tables:
                _close(leaf, want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        # the JAX package's optax.masked adds each table's raw gradient
        old = _paths(_to_torch(jp))
        for k in tables:
            _close(want[k] - old[k], g[k], atol=1e-6)
        jp = j_new
    for k in tables:
        assert torch.equal(_paths(pp)[k], pos0[k])
        assert not p_opt.is_trainable(k)
    assert p_opt.is_trainable("ctc.ctc_lo.kernel")


# --------------------------------------------------------------- trainer


def _trainer_cfg(**model):
    cfg = _port_cfg(tiny_test_config())
    cfg.model = dataclasses.replace(cfg.model, use_pruned_loss=True, prune_range=3, dropout=0.0,
                                    attention_dropout=0.0, predictor_embed_dropout=0.0,
                                    predictor_dropout=0.0, **model)
    return cfg


def _mb(cfg, seed):
    f, fl, lab, ll = _tiny_batch(cfg.model, seed)
    return {"feats": f, "feat_lengths": fl, "labels": lab, "label_lengths": ll}


def test_train_step_equals_update_on_averaged_grads():
    cfg = _trainer_cfg()
    cfg.train.warmup_steps = 5
    a = p_loop.Trainer(cfg, device="cpu")
    b = p_loop.Trainer(cfg, params=a.params, device="cpu")
    mbs = [_mb(cfg, 10), _mb(cfg, 11)]
    g1, o1 = b.compute_grads(mbs[0])
    g2, o2 = b.compute_grads(mbs[1])
    avg = {k: (g1[k] + g2[k]) / 2 for k in g1}
    lr_b, _ = b.optimizer.update(b.params, avg, b.opt_state)
    phases = []
    a.phase_end = phases.append          # the hook a profile synchronizes in
    res = a.train_step(mbs)
    assert phases == ["encoder_fwd", "losses_fwd", "backward", "backward"] * 2 + ["optimizer"]
    assert res["lr"] == lr_b == pytest.approx(cfg.train.lr * 5 ** 0.5 * 5 ** -1.5)
    assert res["loss"] == pytest.approx((o1["loss"].item() + o2["loss"].item()) / 2, rel=1e-6)
    assert np.isfinite(res["grad_norm"]) and a.step == 1
    pa, pb = _paths(a.params), _paths(b.params)
    for k in pa:
        _close(pa[k], pb[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_trainer_requires_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_loop.Trainer(_trainer_cfg())
    assert p_loop.Trainer(_trainer_cfg(), device="cpu").device.type == "cpu"


def _tone_batch(cfg):
    """Four tone utterances of 0.5 s with the labels AB, BA, AAB, BB."""
    rng = np.random.default_rng(0)
    texts = [[2, 3], [3, 2], [2, 2, 3], [3, 3]]
    feats = []
    for i in range(4):
        wav = (0.2 * np.sin(2 * np.pi * (300 + 200 * i) * np.arange(8000) / 16000)
               + 0.01 * rng.standard_normal(8000)).astype(np.float32)
        feats.append(fbank_numpy(wav * (1 << 15), dither=0.0))
    f = np.stack(feats).astype(np.float32)
    f = (f - f.mean(axis=(0, 1))) / (f.std(axis=(0, 1)) + 1e-5)
    lab = np.zeros((4, 3), np.int32)
    for i, t in enumerate(texts):
        lab[i, :len(t)] = t
    return {"feats": f, "feat_lengths": np.full(4, f.shape[1], np.int32), "labels": lab,
            "label_lengths": np.array([len(t) for t in texts], np.int32)}, texts


def test_pruned_training_overfits_one_batch():
    cfg = _port_cfg(tiny_test_config())
    cfg.model = dataclasses.replace(cfg.model, vocab_size=6, sos_eos_id=5, encoder_num_layers=1,
                                    hidden_dim=64, use_pruned_loss=True, use_pallas_rnnt=True,
                                    use_pallas_ctc=True)
    cfg.train.warmup_steps = 5
    cfg.train.lr = 3e-3
    trainer = p_loop.Trainer(cfg, device="cpu")
    batch, texts = _tone_batch(cfg)
    losses, hyps = [], None
    for _ in range(12):
        for _ in range(20):
            losses.append(trainer.train_step([batch])["loss"])
        with torch.no_grad():
            enc, lens = p_tr.encode(trainer.params, torch.from_numpy(batch["feats"]),
                                    torch.from_numpy(batch["feat_lengths"]), cfg.model)
            h, hl, _ = greedy_search_batch(trainer.params, enc, lens, cfg.model, max_hyp_len=8)
        hyps = [h[i, :int(hl[i])].tolist() for i in range(4)]
        if hyps == texts:
            break
    assert hyps == texts, hyps
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


# ---------------------------------------------------- profiling, config


def test_step_timer_matches_jax(monkeypatch):
    """Both timers on the same clock readings: the warm-up step left out,
    the same summary."""
    from conformer_tpu.train import profiling as j_prof
    from conformer_tpu_torch.train import profiling as p_prof

    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 2.5, 3.0, 3.125]
    summaries = []
    for mod in (j_prof, p_prof):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup_steps=1)
        dts = []
        for audio in (10.0, 20.0, 30.0, 40.0):
            timer.start()
            dts.append(timer.stop(audio_seconds=audio))
        summaries.append((dts, timer.summary(), timer.steps_per_sec))
    assert summaries[1] == summaries[0]
    assert summaries[1][1] == {"steps": 4, "steps_per_sec": round(3 / 0.875, 4),
                               "audio_seconds_per_sec": round(90 / 0.875, 2)}
    with pytest.raises(RuntimeError):
        p_prof.StepTimer().stop()


def test_trace_writes_a_file_and_device_sync(tmp_path):
    from conformer_tpu.train import profiling as j_prof
    from conformer_tpu_torch.train import profiling as p_prof

    with p_prof.trace(str(tmp_path / "trace")):
        y = torch.ones(4, 4) @ torch.ones(4, 4)
    path = tmp_path / "trace" / "trace.json"
    assert path.stat().st_size > 0 and "traceEvents" in path.read_text()
    tree = {"b": np.arange(3.0, dtype=np.float32), "a": np.full(2, 2.0, np.float32)}
    assert p_prof.device_sync({k: torch.from_numpy(v) for k, v in tree.items()}) == \
        j_prof.device_sync({k: jnp.asarray(v) for k, v in tree.items()}) == 4.0
    assert p_prof.device_sync(y) == 64.0


def test_tiny_test_config_matches_jax():
    from conformer_tpu_torch.config import tiny_test_config as p_tiny

    assert json.loads(p_tiny().to_json()) == json.loads(tiny_test_config().to_json())
