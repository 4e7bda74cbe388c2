"""The port's streaming serving stack against the JAX package's, on the CPU
in float32 at tiny width (``tiny_test_config``: 2 layers, D=64): the slot
pool, the stream featurizer, the micro-batching scheduler, the runner's
live sessions, both WebSocket handlers over a real ``websockets`` server
on 127.0.0.1, the stream client, and streaming validation.

Weights come from the JAX initialiser and cross over through
``from_jax_params``; inputs come from seeded numpy generators. Transcripts
agree token for token; the featurizer's features bit for bit with JAX's.
"""

import asyncio
import contextlib
import dataclasses
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.decode import stream_batch as j_sb
from conformer_tpu.decode.greedy import init_greedy_state as j_fresh
from conformer_tpu.decode.streaming import new_session as j_new_session
from conformer_tpu.decode.streaming import session_accept_chunk as j_accept
from conformer_tpu.decode.streaming import streaming_greedy_search as j_stream_search
from conformer_tpu.models.encoder import chunk_window_params
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.serve.runner import ModelRunner as JaxRunner
from conformer_tpu.serve.scheduler import StreamFeaturizer as JFeaturizer
from conformer_tpu.serve.scheduler import StreamScheduler as JScheduler
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.data import dataset as p_ds
from conformer_tpu_torch.data.audio import save_wav
from conformer_tpu_torch.data.synthetic import write_corpus
from conformer_tpu_torch.decode import stream_batch as p_sb
from conformer_tpu_torch.decode.greedy import init_greedy_state as p_fresh
from conformer_tpu_torch.decode.streaming import new_session as p_new_session
from conformer_tpu_torch.decode.streaming import session_accept_chunk as p_accept
from conformer_tpu_torch.ops.fbank import fbank_numpy
from conformer_tpu_torch.params import from_jax_params
from conformer_tpu_torch.serve import clients, scheduler as p_sched, websocket_server as ws_srv
from conformer_tpu_torch.serve.runner import ModelRunner
from conformer_tpu_torch.train.loop import Trainer

CHUNK, LEFT = 4, 2
CACHE = CHUNK * LEFT


def _cfgs():
    cfg = tiny_test_config()
    cfg.decode.decoding_chunk_size = CHUNK
    cfg.decode.num_decoding_left_chunks = LEFT
    cfg.decode.max_hyp_len = 64
    cfg.decode.n_steps = 4
    return cfg, PConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def setup():
    cfg, pcfg = _cfgs()
    jp = j_init(jax.random.PRNGKey(0), cfg.model)
    return cfg, pcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _windows(seed, n):
    _, window, _ = chunk_window_params(CHUNK)
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((1, window, 80))).astype(np.float32) for _ in range(n)]


def _port_single(pp, pcfg, chunks, max_hyp_len=64):
    s = p_new_session(pp, pcfg.model, cache_size=CACHE, max_hyp_len=max_hyp_len, device="cpu")
    with torch.inference_mode():
        for c in chunks:
            s = p_accept(pp, s, torch.from_numpy(c), pcfg.model, n_steps=pcfg.decode.n_steps)
    return s.hyps[0, : int(s.hyp_len[0])].tolist()


def _jax_single(jp, cfg, chunks, max_hyp_len=64):
    s = j_new_session(jp, cfg.model, cache_size=CACHE, max_hyp_len=max_hyp_len)
    for c in chunks:
        s = j_accept(jp, s, jnp.asarray(c), cfg.model, n_steps=cfg.decode.n_steps)
    return np.asarray(s.hyps)[0, : int(s.hyp_len[0])].tolist()


# ------------------------------------------------------------ pool


def test_sessions_match_jax(setup):
    cfg, pcfg, jp, pp = setup
    chunks = _windows(1, 3)
    got = _port_single(pp, pcfg, chunks)
    assert got == _jax_single(jp, cfg, chunks) and len(got) > 0


def test_pool_matches_single_sessions_staggered(setup):
    """Three streams joining and leaving at different ticks of one pool give
    their B=1 session transcripts exactly, with the default (relative)
    positions; tests/test_torch_ref_modes.py runs the same schedule under
    ref_abs and absolute positions, as JAX's tests/test_scheduler.py does."""
    cfg, pcfg, jp, pp = setup
    streams = {0: _windows(10, 3), 1: _windows(11, 4), 2: _windows(12, 2)}
    expect = {k: _port_single(pp, pcfg, v) for k, v in streams.items()}
    n_slots = 4
    pool = p_sb.init_pool(pp, pcfg.model, n_slots, cache_size=CACHE, max_hyp_len=64,
                          device="cpu")
    fresh = p_fresh(pp, pcfg.model, 1)
    schedule = [{0: (0, 0)}, {0: (0, 1), 1: (1, 0)}, {0: (0, 2), 1: (1, 1), 3: (2, 0)},
                {1: (1, 2), 3: (2, 1)}, {1: (1, 3)}]
    resets = {0: [0], 1: [1], 2: [3]}
    _, window, _ = chunk_window_params(CHUNK)
    with torch.inference_mode():
        for tick, assignments in enumerate(schedule):
            if tick in resets:
                mask = torch.zeros(n_slots, dtype=torch.bool)
                mask[resets[tick]] = True
                pool = p_sb.pool_reset_slots(pool, mask, fresh, pcfg.model.blank_id)
            chunks = torch.zeros(n_slots, window, 80)
            active = torch.zeros(n_slots, dtype=torch.bool)
            out_valid = torch.zeros(n_slots, dtype=torch.int32)
            for slot, (sid, ci) in assignments.items():
                chunks[slot] = torch.from_numpy(streams[sid][ci][0])
                active[slot] = True
                out_valid[slot] = CHUNK
            pool = p_sb.pool_step(pp, pool, chunks, active, out_valid, pcfg.model,
                                  n_steps=pcfg.decode.n_steps)
    for sid, slot in {0: 0, 1: 1, 2: 3}.items():
        assert pool.hyps[slot, : int(pool.hyp_len[slot])].tolist() == expect[sid]


def _row(pool, i):
    return (pool.enc.attn_k[:, i], pool.enc.attn_v[:, i], pool.enc.attn_len[i],
            pool.enc.conv_cache[:, i], pool.enc.offset[i], pool.dec.last_token[i],
            pool.dec.pred_state.h[:, i], pool.dec.pred_state.c[:, i], pool.dec.pred_proj[i],
            pool.hyps[i], pool.hyp_len[i])


def test_pool_step_and_reset_match_jax_inactive_frozen(setup):
    """One tick with slot 1 inactive leaves its whole state bitwise
    unchanged; the pool after the tick and after resetting slot 0 matches
    JAX's, leaf for leaf."""
    cfg, pcfg, jp, pp = setup
    c0 = _windows(20, 1)[0][0]
    chunks = np.stack([c0, c0])
    active = np.array([True, False])
    valid = np.array([CHUNK, CHUNK], np.int32)
    j_pool = j_sb.init_pool(jp, cfg.model, 2, cache_size=CACHE, max_hyp_len=32)
    j_pool = j_sb.pool_step(jp, j_pool, jnp.asarray(chunks), jnp.asarray(active),
                            jnp.asarray(valid), cfg.model, n_steps=cfg.decode.n_steps)
    with torch.inference_mode():
        pool0 = p_sb.init_pool(pp, pcfg.model, 2, cache_size=CACHE, max_hyp_len=32, device="cpu")
        pool1 = p_sb.pool_step(pp, pool0, torch.from_numpy(chunks), torch.from_numpy(active),
                               torch.from_numpy(valid), pcfg.model, n_steps=pcfg.decode.n_steps)
    for a, b in zip(_row(pool0, 1), _row(pool1, 1)):
        assert torch.equal(a, b)
    assert pool1.enc.offset.tolist() == [CHUNK, 0]
    assert int(pool1.hyp_len[0]) > 0

    def check(p_pool, j_pool):
        for a, b in zip(jax.tree.leaves(p_pool), jax.tree.leaves(j_pool)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)

    check(pool1, j_pool)
    reset = np.array([True, False])
    j_pool = j_sb.pool_reset_slots(j_pool, jnp.asarray(reset), j_fresh(jp, cfg.model, 1),
                                   cfg.model.blank_id)
    pool2 = p_sb.pool_reset_slots(pool1, torch.from_numpy(reset), p_fresh(pp, pcfg.model, 1),
                                  pcfg.model.blank_id)
    check(pool2, j_pool)
    assert int(pool2.hyp_len[0]) == 0 and int(pool2.enc.offset[0]) == 0


def test_streaming_state_needs_the_card_unless_asked(setup, monkeypatch):
    """Sessions, pools and the scheduler default to cuda and raise without
    it; the runner's default device raises the same way."""
    _, pcfg, _, pp = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: p_new_session(pp, pcfg.model),
                 lambda: p_sb.init_pool(pp, pcfg.model, 2),
                 lambda: p_sched.StreamScheduler(pp, pcfg, n_slots=2),
                 lambda: ModelRunner(pcfg, params=pp)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ------------------------------------------------------------ featurizer


def test_featurizer_piecewise_matches_batch_and_jax():
    """Piece by piece, bit for bit JAX's featurizer on the same pieces; the
    concatenation within 1e-5 of one batch call (JAX's own test's
    tolerance: numpy's FFT of another frame count sums in another order)."""
    cfg, pcfg = _cfgs()
    wav = (0.1 * np.random.default_rng(0).standard_normal(16000 * 2)).astype(np.float32)
    full = fbank_numpy(wav * (1 << 15), dither=0.0)
    pf, jf = p_sched.StreamFeaturizer(pcfg.data), JFeaturizer(cfg.data)
    got, want, pos = [], [], 0
    for size in (100, 1600, 3, 7000, 160, 23000, 500, len(wav)):
        piece = wav[pos:pos + size]
        pos += size
        got.append(pf.feed(piece))
        want.append(jf.feed(piece))
        np.testing.assert_array_equal(got[-1], want[-1])
    inc = np.concatenate(got)
    assert inc.shape == full.shape
    np.testing.assert_allclose(inc, full, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ scheduler


def _utterances(n, remainder=0):
    """Feature frames of n streams of 2-4 full windows; with
    ``remainder``, odd streams end in that many more frames (a padded
    final chunk)."""
    stride, window, _ = chunk_window_params(CHUNK)
    rng = np.random.default_rng(100)
    return [(0.5 * rng.standard_normal(((1 + i % 3) * stride + window + remainder * (i % 2), 80))
             ).astype(np.float32) for i in range(n)]


def _window_chunks(feats):
    stride, window, _ = chunk_window_params(CHUNK)
    return [feats[None, p:p + window] for p in range(0, len(feats) - window + 1, stride)]


def _drive(sched, utts, pool_full):
    """One thread per utterance: open (retrying on PoolFull), drip-feed in
    pieces of 5 frames, close. Returns the final transcripts."""
    results, errors = [None] * len(utts), []

    def client(i):
        try:
            while True:
                try:
                    slot = sched.open()
                    break
                except pool_full:
                    time.sleep(0.01)
            for start in range(0, len(utts[i]), 5):
                sched.feed_frames(slot, utts[i][start:start + 5])
            results[i] = sched.close(slot, timeout=120)
        except Exception as e:  # noqa: BLE001 (reported by the assertion below)
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(utts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return results


def test_scheduler_matches_jax_scheduler(setup):
    """Five client threads through three slots (late joins, slot reuse), the
    odd streams ending in a padded final chunk: every final transcript
    equals JAX's scheduler's."""
    cfg, pcfg, jp, pp = setup
    utts = _utterances(5, remainder=9)
    sched = p_sched.StreamScheduler(pp, pcfg, n_slots=3, max_wait_ms=1.0, device="cpu")
    try:
        got = _drive(sched, utts, p_sched.PoolFull)
        stats = sched.stats()
    finally:
        sched.shutdown()
    assert not sched._worker.is_alive()
    jsched = JScheduler(jp, cfg, n_slots=3, max_wait_ms=1.0)
    try:
        want = _drive(jsched, utts, Exception)
    finally:
        jsched.shutdown()
    assert sched.cache_size == jsched.cache_size == 64
    assert got == want and all(len(g) > 0 for g in got)
    assert stats["steps"] > 0 and stats["chunks"] > 0 and "chunk_latency_p99_ms" in stats


def test_scheduler_transcripts_equal_b1_sessions(setup):
    """The bar of JAX's tests/test_scheduler.py: each stream through the
    shared pool equals its B=1 session (at the scheduler's cache size)
    exactly."""
    _, pcfg, _, pp = setup
    utts = _utterances(4)
    sched = p_sched.StreamScheduler(pp, pcfg, n_slots=2, max_wait_ms=1.0, device="cpu")
    try:
        got = _drive(sched, utts, p_sched.PoolFull)
    finally:
        sched.shutdown()
    for g, u in zip(got, utts):
        s = p_new_session(pp, pcfg.model, cache_size=sched.cache_size, max_hyp_len=64,
                          device="cpu")
        with torch.inference_mode():
            for c in _window_chunks(u):
                s = p_accept(pp, s, torch.from_numpy(c), pcfg.model, n_steps=pcfg.decode.n_steps)
        assert g == s.hyps[0, : int(s.hyp_len[0])].tolist() and len(g) > 0


def test_scheduler_pool_full_and_backpressure(setup):
    _, pcfg, _, pp = setup
    sched = p_sched.StreamScheduler(pp, pcfg, n_slots=1, max_wait_ms=0.0, max_buffer_chunks=1,
                                    device="cpu")
    try:
        slot = sched.open()
        with pytest.raises(p_sched.PoolFull):
            sched.open()
        _, window, _ = chunk_window_params(CHUNK)
        with sched._cond:   # hold the lock: the worker cannot drain the buffer
            sched._slots[slot].buf = np.zeros((window, 80), np.float32)
            with pytest.raises(p_sched.Backpressure):
                sched.feed_frames(slot, np.zeros((1, 80), np.float32), block=False)
        sched.close(slot)
    finally:
        sched.shutdown()


def test_scheduler_worker_error_reaches_flush_wait(setup, monkeypatch):
    _, pcfg, _, pp = setup

    def boom(*args, **kwargs):
        raise ValueError("injected pool_step failure")

    monkeypatch.setattr(p_sched, "pool_step", boom)
    sched = p_sched.StreamScheduler(pp, pcfg, n_slots=2, max_wait_ms=0.0, device="cpu")
    try:
        slot = sched.open()
        sched.feed_frames(slot, _windows(3, 1)[0][0])
        with pytest.raises(RuntimeError, match="worker died") as info:
            sched.flush_wait(slot, timeout=60)
        assert isinstance(info.value.__cause__, ValueError)
        with pytest.raises(RuntimeError, match="worker died"):
            sched.open()
    finally:
        sched.shutdown()


# ------------------------------------------------------------ runner and servers


@pytest.fixture(scope="module")
def runners():
    """(JAX runner, port runner on its weights), decoding chunk 16 with
    unlimited left chunks: a cache of 64, as the runners pick it."""
    cfg = tiny_test_config()
    cfg.decode.max_hyp_len = 128
    cfg.decode.n_steps = 4
    jrunner = JaxRunner(cfg)
    prunner = ModelRunner(PConfig.from_dict(dataclasses.asdict(cfg)),
                          params=jax.tree.map(np.asarray, jrunner.params), device="cpu")
    return jrunner, prunner


def _pcm(seed, seconds=1.5):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 3000).astype(
        np.int16)


@pytest.mark.parametrize("int8", [False, True])
def test_runner_sessions_match_jax_runner(runners, int8):
    """Sessions fed 400 ms pieces, token for token and text for text with
    the JAX runner's; with decode.quantize_int8 both runners quantize the
    same float weights (route A: each FFN's w_1 through the int8 matmul,
    M = 1 x Tq rows a chunk)."""
    jrunner, prunner = runners
    if int8:
        cfg = dataclasses.replace(jrunner.cfg, decode=dataclasses.replace(
            jrunner.cfg.decode, quantize_int8=True))
        float_params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(cfg.train.seed),
                                                       cfg.model))
        jrunner = JaxRunner(cfg)
        prunner = ModelRunner(PConfig.from_dict(dataclasses.asdict(cfg)), params=float_params,
                              device="cpu")
        assert "kernel_q" in prunner.params["encoder"]["layers"]["feed_forward"]["w_1"]
    pcm = _pcm(0)
    js, ps = jrunner.new_session(), prunner.new_session()
    assert ps.enc.attn_k.shape[3] == 64 and ps.enc.attn_k.device.type == "cpu"
    for i in range(0, len(pcm), 6400):
        wav = pcm[i:i + 6400].astype(np.float32) / 32768.0
        js, jrec = jrunner.accept_chunk(js, wav, 16000)
        ps, prec = prunner.accept_chunk(ps, wav, 16000)
        assert prec.tokens == jrec.tokens and prec.text == jrec.text
    assert len(prec.tokens) > 0


def _serve_scenario(prunner, pooled, clients_fn):
    """Run ``clients_fn(port)`` against the port's handler (pooled or B=1)
    behind a websockets server on an ephemeral localhost port."""
    import websockets

    scheduler = prunner.make_scheduler(n_slots=4, max_wait_ms=1.0) if pooled else None

    async def scenario():
        async def handler(ws):
            if pooled:
                await ws_srv.handle_connection_pooled(prunner, ws, scheduler)
            else:
                await ws_srv.handle_connection(prunner, ws)

        async with websockets.serve(handler, "127.0.0.1", 0) as server:
            return await clients_fn(server.sockets[0].getsockname()[1])

    try:
        return asyncio.run(scenario())
    finally:
        if scheduler is not None:
            scheduler.shutdown()


async def _stream(port, pcm, piece=4000, poison=False):
    import websockets

    async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
        await ws.send(json.dumps({"signal": 1}))
        replies = [await ws.recv()]
        if poison:   # an odd-length buffer: np.frombuffer(int16) raises
            await ws.send(b"\x00")
            replies.append(json.loads(await ws.recv()))
        for i in range(0, len(pcm), piece):
            await ws.send(pcm[i:i + piece].tobytes())
            replies.append(await ws.recv())
        await ws.send(json.dumps({"signal": 0}))
        replies.append(await ws.recv())
        return replies


@pytest.mark.parametrize("pooled", [False, True])
def test_websocket_handlers_match_sessions(runners, pooled):
    """Two concurrent connections: "$start$", a partial per piece, and a
    "$final$" whose text is the B=1 session's (the runner's accept_chunk
    per piece) or the scheduler's (the whole stream through one slot); a
    poisoned frame gets {"status": "fail"} and the connection goes on."""
    jrunner, prunner = runners
    pcms = [_pcm(1), _pcm(2, 2.0)]

    async def both(port):
        return await asyncio.gather(_stream(port, pcms[0], poison=True), _stream(port, pcms[1]))

    out = _serve_scenario(prunner, pooled, both)
    for replies, pcm in zip(out, pcms):
        assert replies[0] == "$start$" and replies[-1].startswith("$final$")
        assert not any(isinstance(r, str) and r.startswith("{") for r in replies)
        if pooled:
            sched = jrunner.make_scheduler(n_slots=1, max_wait_ms=0.0)
            try:
                slot = sched.open()
                sched.feed(slot, pcm.astype(np.float32) / 32768.0, 16000)
                want = jrunner._ids_to_text(sched.close(slot, timeout=120))
            finally:
                sched.shutdown()
        else:
            s = jrunner.new_session()
            for i in range(0, len(pcm), 4000):
                s, rec = jrunner.accept_chunk(s, pcm[i:i + 4000].astype(np.float32) / 32768.0,
                                              16000)
            want = rec.text
        assert replies[-1] == "$final$" + want and want
    fail = out[0][1]
    assert fail["status"] == "fail" and "ValueError" in fail["message"]


def test_stream_client_against_the_server(runners, tmp_path):
    _, prunner = runners
    path = str(tmp_path / "a.wav")
    save_wav(path, _pcm(3).astype(np.float32) / 32768.0, 16000)

    async def run(port):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            await clients.stream_client(f"ws://127.0.0.1:{port}", path, chunk_ms=640)
        return buf.getvalue().splitlines()

    lines = _serve_scenario(prunner, True, run)
    assert lines[0] == "$start$" and lines[-1].startswith("$final$")
    assert len(lines) == 2 + 3 and all(x.startswith("partial:") for x in lines[1:-1])


def test_websocket_server_imports_without_websockets():
    """Only serve_async imports websockets: the module's globals hold none."""
    assert "websockets" not in vars(ws_srv) and "websockets" not in vars(clients)


# ------------------------------------------------------------ validation


def test_streaming_validate_matches_jax_decode(tmp_path):
    cfg = tiny_test_config()
    corpus = write_corpus(str(tmp_path / "corpus"), seed=3, n_train=2, n_dev=3,
                          seconds=(0.6, 2.4), vocab_size=64)
    cfg.data = dataclasses.replace(
        cfg.data, train_data_list_path=corpus["train"], dev_data_list_path=corpus["dev"],
        test_data_list_path=corpus["dev"], vocab_path=corpus["vocab"], bpe_model=None,
        cmvn_path="")
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.decode.streaming = True
    cfg.decode.decoding_chunk_size = 8
    cfg.decode.max_hyp_len = 48
    cfg.decode.n_steps = 4
    pcfg = PConfig.from_dict(dataclasses.asdict(cfg))
    jp = j_init(jax.random.PRNGKey(cfg.train.seed), cfg.model)
    trainer = Trainer(pcfg, params=jax.tree.map(np.asarray, jp), device="cpu")
    dev = p_ds.AsrDataset(p_ds.eval_config(pcfg.data), "dev", tokenizer=trainer.tokenizer)
    wer = trainer.validate(dev, max_batches=1)
    batch = next(iter(dev))
    hyps, lens = j_stream_search(
        jp, jnp.asarray(batch["feats"]), jnp.asarray(batch["feat_lengths"]), cfg.model,
        decoding_chunk_size=8, num_decoding_left_chunks=-1, n_steps=4, max_hyp_len=48)
    hyps, lens = np.asarray(hyps), np.asarray(lens)
    want = [trainer.tokenizer.decode_ids(hyps[i, : lens[i]].tolist(),
                                         stop_id=cfg.model.sos_eos_id)
            for i in range(len(batch["keys"]))]
    got = [line[len("Pred: "):] for line in
           open(tmp_path / "ckpt" / "tmp_prediction.txt").read().splitlines()
           if line.startswith("Pred: ")]
    assert got == want and any(want)
    assert np.isfinite(wer)
