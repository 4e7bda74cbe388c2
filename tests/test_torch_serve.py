"""The port's serving surface and weights bridge: ModelRunner and the REST
handler against the JAX runner on the same weights and wav, the npz
loader's layouts, and the runner's device rule.
"""

import dataclasses
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from conformer_tpu.config import tiny_test_config
from conformer_tpu.data import audio as j_audio
from conformer_tpu.serve.runner import ModelRunner as JaxRunner
from conformer_tpu.train import checkpoint as j_ckpt
from conformer_tpu.train.checkpoint import load_params_npz, save_params_npz
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.data import audio as p_audio
from conformer_tpu_torch.params import from_jax_params, load_jax_npz
from conformer_tpu_torch.serve import rest_server
from conformer_tpu_torch.serve.runner import ModelRunner

FIXTURE = "tests/fixtures/micro_trained.npz"


def _configs():
    cfg = tiny_test_config()
    cfg.decode.max_hyp_len = 32
    cfg.decode.n_steps = 4
    return cfg, PConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("wav") / "a.wav")
    j_audio.save_wav(path, wav, 16000)
    return path


def _post(url: str, payload: bytes) -> dict:
    boundary = "XB"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"audio\"; "
            f"filename=\"a.wav\"\r\n\r\n").encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_rest_server_matches_jax_runner(wav_path):
    jcfg, pcfg = _configs()
    jrunner = JaxRunner(jcfg)
    want = jrunner.recognize_file(wav_path)
    runner = ModelRunner(pcfg, params=jax.tree.map(np.asarray, jrunner.params), device="cpu")
    assert runner.recognize_file(wav_path).tokens == want.tokens
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), rest_server.make_handler(runner))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/recognize/"
        with open(wav_path, "rb") as f:
            got = _post(url, f.read())
        bad = _post(url, b"not a wav")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert got == {"status": "success", "message": want.text}
    assert len(want.tokens) > 0
    assert bad["status"] == "fail"


def test_preprocessing_matches_jax(wav_path):
    jcfg, pcfg = _configs()
    wav, sr = p_audio.load_audio(wav_path)
    j_wav, j_sr = j_audio.load_audio(wav_path)
    assert sr == j_sr
    np.testing.assert_array_equal(wav, j_wav)
    np.testing.assert_allclose(p_audio.resample(wav, 16000, 8000),
                               j_audio.resample(j_wav, 16000, 8000), rtol=1e-6, atol=1e-6)
    runner = ModelRunner(pcfg, device="cpu")
    got = runner.preprocess_waveform(wav, 8000)
    want = JaxRunner.preprocess_waveform(type("R", (), {"cfg": jcfg})(), j_wav, 8000)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_runner_keeps_given_cmvn_as_jax_does(tmp_path, wav_path):
    """Weights that carry CMVN statistics keep them when ``data.cmvn_path``
    names others: JAX builds its init with the file's stats, then restores
    the checkpoint over the whole tree. The port once overwrote the given
    stats with the file's (fault C2)."""
    jcfg, pcfg = _configs()
    rng = np.random.default_rng(5)
    own = {"mean": rng.standard_normal(80).astype(np.float32),
           "istd": rng.uniform(0.5, 2.0, 80).astype(np.float32)}
    tree = jax.tree.map(np.asarray, JaxRunner(jcfg).params)
    tree["cmvn"] = own
    npz = str(tmp_path / "weights.npz")
    save_params_npz(npz, tree)
    stats = tmp_path / "global_cmvn"
    stats.write_text(json.dumps({"mean_stat": [3.0] * 80, "var_stat": [20.0] * 80,
                                 "frame_num": 2}))
    jcfg.data.cmvn_path = pcfg.data.cmvn_path = str(stats)
    ckpt_dir = str(tmp_path / "ckpt")
    j_ckpt.save_checkpoint(ckpt_dir, {"params": tree}, step=0)
    jrunner = JaxRunner(jcfg, checkpoint=ckpt_dir)
    for params in (npz, tree):
        runner = ModelRunner(pcfg, params=params, device="cpu")
        for k in ("mean", "istd"):
            np.testing.assert_array_equal(runner.params["cmvn"][k].numpy(), own[k])
            np.testing.assert_array_equal(np.asarray(jrunner.params["cmvn"][k]), own[k])
    assert runner.recognize_file(wav_path).tokens == jrunner.recognize_file(wav_path).tokens
    fresh = ModelRunner(pcfg, device="cpu")          # the random init takes the file's
    np.testing.assert_allclose(fresh.params["cmvn"]["mean"].numpy(), 1.5)


def test_runner_defaults_to_cuda(monkeypatch):
    _, pcfg = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRunner(pcfg)


def test_runner_refuses_vocab_until_tokenizer_port():
    """The tokenizer is ported: a vocab is read, and a missing one raises."""
    _, pcfg = _configs()
    pcfg.data.vocab_path = "no/such/vocab.txt"
    with pytest.raises(FileNotFoundError):
        ModelRunner(pcfg, device="cpu")


def test_runner_returns_text_through_tokenizer(wav_path, tmp_path):
    """With data.vocab_path set, the runner's text is the JAX runner's:
    the tokenizer's decode of the same ids (cut at <sos/eos>)."""
    jcfg, pcfg = _configs()
    vocab = ["<blank>", "<unk>", *(f"▁W{i}" for i in range(jcfg.model.vocab_size - 3)),
             "<sos/eos>"]
    path = tmp_path / "vocab.txt"
    path.write_text("".join(f"{w} {i}\n" for i, w in enumerate(vocab)))
    jcfg.data.vocab_path = pcfg.data.vocab_path = str(path)
    jcfg.data.bpe_model = pcfg.data.bpe_model = None
    jrunner = JaxRunner(jcfg)
    want = jrunner.recognize_file(wav_path)
    runner = ModelRunner(pcfg, params=jax.tree.map(np.asarray, jrunner.params), device="cpu")
    got = runner.recognize_file(wav_path)
    assert got.tokens == want.tokens and len(got.tokens) > 0
    assert got.text == want.text and got.text.startswith("W")


def test_load_jax_npz_matches_jax_loader():
    want = load_params_npz(FIXTURE)
    got = load_jax_npz(FIXTURE, "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_w:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    layers = got["encoder"]["layers"]
    assert layers["conv_module"]["depthwise_conv"]["kernel"].shape == (3, 7, 1, 96)
    assert got["encoder"]["pos_table"].shape == (2 * 5000 - 1, 96)
    assert isinstance(got["predictor"]["rnn"], list)
    assert {"ctc", "decoder", "simple_am_proj", "simple_lm_proj"} <= set(got)


def test_load_jax_npz_ignores_key_order(tmp_path):
    rng = np.random.default_rng(3)
    tree = {
        "predictor": {"rnn": [{"w": rng.standard_normal((2, 3))} for _ in range(3)]},
        "encoder": {"layers": {"a": {"kernel": rng.standard_normal((4, 2, 2))}}},
        "grid": [[rng.standard_normal(1), rng.standard_normal(2)], [rng.standard_normal(3)]],
    }
    path = tmp_path / "p.npz"
    save_params_npz(str(path), tree)
    with np.load(path) as z:
        items = {k: z[k] for k in z.files}
    shuffled = tmp_path / "shuffled.npz"
    np.savez(shuffled, **dict(reversed(list(items.items()))))
    got = load_jax_npz(str(shuffled))
    want = from_jax_params(tree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)
    assert len(got["predictor"]["rnn"]) == 3 and len(got["grid"][0]) == 2


def test_parse_multipart():
    body = (b"--B\r\nContent-Disposition: form-data; name=\"audio\"; filename=\"a.wav\"\r\n"
            b"Content-Type: application/octet-stream\r\n\r\nPAYLOAD\r\n--B--\r\n")
    assert rest_server.parse_multipart(body, "multipart/form-data; boundary=B") == {
        "audio": b"PAYLOAD"}
