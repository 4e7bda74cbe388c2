"""The reference-parity encoder modes of the port against the JAX package's,
at tiny width in float32: the BatchNorm conv module (``conv_norm
="batch_norm"``, running statistics that are not the identity), the
reference's position terms (``rel_mode`` "ref_abs" / "ref_batch") and
absolute positions (``use_relative=False``); offline with both encoder
kernel flags on (the port must take the plain attention in every one of
these modes, and the plain conv under BatchNorm; on the CPU its kernel
wrappers run their plain versions, which would apply a LayerNorm to a
BatchNorm tree), chunk by chunk, and in the slot pool against single
sessions. Weights from the JAX initialisers through ``from_jax_params``,
inputs from seeded numpy generators; tolerance 1e-4 abs and rel, as in
``tests/test_torch_modules.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.decode.streaming import new_session as j_new_session
from conformer_tpu.decode.streaming import session_accept_chunk as j_accept
from conformer_tpu.models import encoder as j_enc
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.train import checkpoint as j_ckpt
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.decode import stream_batch as p_sb
from conformer_tpu_torch.decode.greedy import init_greedy_state as p_fresh
from conformer_tpu_torch.decode.streaming import new_session as p_new_session
from conformer_tpu_torch.decode.streaming import session_accept_chunk as p_accept
from conformer_tpu_torch.models import encoder as p_enc
from conformer_tpu_torch.models.transducer import init_transducer as p_init
from conformer_tpu_torch.params import from_jax_params, load_jax_npz
from conformer_tpu_torch.train import checkpoint as p_ckpt
from conformer_tpu_torch.train.optimizer import leaf_paths

TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK, LEFT = 4, 2
CACHE = CHUNK * LEFT
MODES = {
    "ref_batch-bn": dict(rel_mode="ref_batch", conv_norm="batch_norm"),
    "ref_abs-bn": dict(rel_mode="ref_abs", conv_norm="batch_norm"),
    "ref_abs-ln": dict(rel_mode="ref_abs"),
    "absolute-ln": dict(use_relative=False),
    "ref_batch-ln": dict(rel_mode="ref_batch"),
}


def _cfg(mode: str, kernels: bool = True):
    return dataclasses.replace(tiny_test_config().model, use_pallas_attention=kernels,
                               use_pallas_conv=kernels, **MODES[mode])


def _port(model_cfg):
    return PConfig.from_dict({"model": dataclasses.asdict(model_cfg)}).model


def _to_torch(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")


def with_bn_stats(enc: dict, seed: int) -> dict:
    """The encoder tree with random BatchNorm running statistics (kept
    when the conv module has a LayerNorm)."""
    norm = enc["layers"]["conv_module"]["norm"]
    if "mean" in norm:
        rng = np.random.default_rng(seed)
        norm["mean"] = jnp.asarray(0.3 * rng.standard_normal(norm["mean"].shape), jnp.float32)
        norm["var"] = jnp.asarray(rng.uniform(0.5, 2.0, norm["var"].shape), jnp.float32)
    return enc


def _feats(seed, b, t):
    return np.random.default_rng(seed).standard_normal((b, t, 80)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_forward_matches_jax(mode):
    cfg = _cfg(mode)
    jp = with_bn_stats(j_enc.init_encoder(jax.random.PRNGKey(7), cfg), 3)
    feats = _feats(8, 3, 61)
    lens = np.array([61, 40, 7], np.int32)
    want, want_mask = j_enc.encoder_forward(jp, jnp.asarray(feats), jnp.asarray(lens), cfg)
    got, got_mask = p_enc.encoder_forward(_to_torch(jp), torch.from_numpy(feats),
                                          torch.from_numpy(lens), _port(cfg))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    _close(got, want)


@pytest.mark.parametrize("mode", ["ref_abs-bn", "ref_batch-ln", "absolute-ln"])
def test_chunk_by_chunk_matches_jax(mode):
    """Per-row key positions offset - C + j (ref modes; negative before the
    stream's start) and clipped absolute positions, chunk after chunk."""
    cfg = _cfg(mode, kernels=False)
    jp = with_bn_stats(j_enc.init_encoder(jax.random.PRNGKey(9), cfg), 4)
    feats = _feats(10, 2, 71)
    want, _ = j_enc.encoder_forward_chunk_by_chunk(
        jp, jnp.asarray(feats), cfg, decoding_chunk_size=CHUNK, num_decoding_left_chunks=LEFT)
    got, _ = p_enc.encoder_forward_chunk_by_chunk(
        _to_torch(jp), torch.from_numpy(feats), _port(cfg), decoding_chunk_size=CHUNK,
        num_decoding_left_chunks=LEFT)
    _close(got, want)


def _windows(seed, n):
    _, window, _ = j_enc.chunk_window_params(CHUNK)
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((1, window, 80))).astype(np.float32) for _ in range(n)]


def _port_single(pp, mcfg, chunks):
    s = p_new_session(pp, mcfg, cache_size=CACHE, max_hyp_len=64, device="cpu")
    with torch.inference_mode():
        for c in chunks:
            s = p_accept(pp, s, torch.from_numpy(c), mcfg, n_steps=4)
    return s.hyps[0, : int(s.hyp_len[0])].tolist()


@pytest.mark.parametrize("mode", ["ref_abs-ln", "absolute-ln"])
def test_pool_matches_single_sessions_staggered(mode):
    """Three streams joining and leaving at different ticks of one pool give
    their B=1 session transcripts exactly, with per-row offsets in the
    position terms (tests/test_scheduler.py:55-66 in JAX); a session's
    transcript equals JAX's."""
    cfg = _cfg(mode, kernels=False)
    mcfg = _port(cfg)
    jp = j_init(jax.random.PRNGKey(0), cfg)
    pp = _to_torch(jp)
    streams = {0: _windows(10, 3), 1: _windows(11, 4), 2: _windows(12, 2)}
    expect = {k: _port_single(pp, mcfg, v) for k, v in streams.items()}
    s = j_new_session(jp, cfg, cache_size=CACHE, max_hyp_len=64)
    for c in streams[1]:
        s = j_accept(jp, s, jnp.asarray(c), cfg, n_steps=4)
    assert expect[1] == np.asarray(s.hyps)[0, : int(s.hyp_len[0])].tolist()
    assert any(expect.values())
    n_slots = 4
    pool = p_sb.init_pool(pp, mcfg, n_slots, cache_size=CACHE, max_hyp_len=64, device="cpu")
    fresh = p_fresh(pp, mcfg, 1)
    schedule = [{0: (0, 0)}, {0: (0, 1), 1: (1, 0)}, {0: (0, 2), 1: (1, 1), 3: (2, 0)},
                {1: (1, 2), 3: (2, 1)}, {1: (1, 3)}]
    resets = {0: [0], 1: [1], 2: [3]}
    _, window, _ = j_enc.chunk_window_params(CHUNK)
    with torch.inference_mode():
        for tick, assignments in enumerate(schedule):
            if tick in resets:
                mask = torch.zeros(n_slots, dtype=torch.bool)
                mask[resets[tick]] = True
                pool = p_sb.pool_reset_slots(pool, mask, fresh, mcfg.blank_id)
            chunks = torch.zeros(n_slots, window, 80)
            active = torch.zeros(n_slots, dtype=torch.bool)
            out_valid = torch.zeros(n_slots, dtype=torch.int32)
            for slot, (sid, ci) in assignments.items():
                chunks[slot] = torch.from_numpy(streams[sid][ci][0])
                active[slot] = True
                out_valid[slot] = CHUNK
            pool = p_sb.pool_step(pp, pool, chunks, active, out_valid, mcfg, n_steps=4)
    for sid, slot in {0: 0, 1: 1, 2: 3}.items():
        assert pool.hyps[slot, : int(pool.hyp_len[slot])].tolist() == expect[sid]


@pytest.mark.parametrize("mode", ["ref_batch-bn", "absolute-ln"])
def test_init_trees_round_trip_npz(mode, tmp_path):
    """The port's init (a BatchNorm conv's norm.mean / norm.var; the
    absolute mode's tree without linear_pos or position biases) through
    the port's .npz into JAX and back through JAX's .npz, leaf for leaf;
    the trees have JAX's keys and shapes."""
    cfg = _cfg(mode, kernels=False)
    tree = p_init(_port(cfg), seed=3)
    p_ckpt.save_params_npz(tmp_path / "port.npz", tree)
    j_tree = j_ckpt.load_params_npz(str(tmp_path / "port.npz"))
    j_ckpt.save_params_npz(str(tmp_path / "jax.npz"), j_tree)
    back = load_jax_npz(str(tmp_path / "jax.npz"))
    want = jax.tree.map(np.shape, j_init(jax.random.PRNGKey(0), cfg))
    assert jax.tree.map(np.shape, j_tree) == want
    got, src = dict(leaf_paths(back)), dict(leaf_paths(tree))
    assert set(got) == set(src)
    for k in src:
        assert torch.equal(got[k], src[k]), k
    assert ("encoder.layers.self_attn.linear_pos.kernel" in src) == mode.startswith("ref")
    assert ("encoder.layers.conv_module.norm.mean" in src) == mode.endswith("bn")
