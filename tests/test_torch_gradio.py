"""The port's Gradio demo (``conformer_tpu_torch/serve/gradio_server.py``)
against the JAX package's, both on the trained
``tests/fixtures/micro_trained.npz`` on the CPU, with a minimal fake
``gradio`` module (the JAX package's ``tests/test_gradio.py``): the stream
callback's transcript after each microphone chunk (int16, float32,
stereo, None), and the "Reset Model" button. Also the serving entry
points' ``--checkpoint`` flag.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

from conformer_tpu.serve.gradio_server import build_app as j_build_app
from conformer_tpu.serve.runner import ModelRunner as JRunner
from conformer_tpu.train.checkpoint import load_params_npz as j_load_npz
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.data.audio import load_audio
from conformer_tpu_torch.data.synthetic import write_recordings
from conformer_tpu_torch.serve import gradio_server, rest_server, websocket_server
from conformer_tpu_torch.serve.runner import ModelRunner as PRunner
from conformer_tpu_torch.tools.make_micro_corpus import build_micro_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import train_micro_wer as j_wer  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "fixtures", "micro_trained.npz")
PIECE_MS = 640


class _FakeComponent:
    def __init__(self, *a, **k):
        pass


class _FakeAudio(_FakeComponent):
    def __init__(self, *a, **k):
        self.stream_fn = None

    def stream(self, fn, inputs=None, outputs=None):
        self.stream_fn = fn


class _FakeButton(_FakeComponent):
    def __init__(self, *a, **k):
        self.click_fn = None

    def click(self, fn, inputs=None, outputs=None):
        self.click_fn = fn


class _FakeBlocks:
    def __init__(self, *a, **k):
        self.audio: _FakeAudio | None = None
        self.button: _FakeButton | None = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def launch(self, **k):
        raise AssertionError("launch() must not be called in tests")


@pytest.fixture()
def fake_gradio(monkeypatch):
    mod = types.ModuleType("gradio")
    blocks_holder = {}

    def _blocks(*a, **k):
        blocks_holder["b"] = _FakeBlocks()
        return blocks_holder["b"]

    def _audio(*a, **k):
        blocks_holder["b"].audio = _FakeAudio()
        return blocks_holder["b"].audio

    def _button(*a, **k):
        blocks_holder["b"].button = _FakeButton()
        return blocks_holder["b"].button

    mod.Blocks = _blocks
    mod.Textbox = _FakeComponent
    mod.Audio = _audio
    mod.Button = _button
    monkeypatch.setitem(sys.modules, "gradio", mod)
    return blocks_holder


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The micro config (vocab of a tiny micro corpus from four seeded 8 s
    recordings) as a JSON file, and the longest of its four eval wavs."""
    root = tmp_path_factory.mktemp("gradio")
    samples = write_recordings(str(root / "samples"))
    meta = build_micro_corpus(str(root / "corpus"), samples, n_train=1, n_eval=4)
    cfg = j_wer.build_config(meta, str(root / "exp"), pruned=True, steps=0)
    cfg.decode.n_steps = 4
    cfg_path = str(root / "micro.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    with open(meta["eval_list"]) as f:
        paths = [json.loads(line)["wav_path"] for line in f]
    return cfg, cfg_path, max(paths, key=os.path.getsize)


def _apps(fake_gradio, micro):
    cfg, cfg_path, _ = micro
    jrunner = JRunner(cfg)
    jrunner.params = j_load_npz(FIXTURE)
    prunner = PRunner(PConfig.from_json_file(cfg_path), FIXTURE, device="cpu")
    apps = []
    for build, runner in ((j_build_app, jrunner), (gradio_server.build_app, prunner)):
        demo = build(runner)
        blocks = fake_gradio["b"]
        assert demo is blocks
        apps.append((blocks.audio.stream_fn, blocks.button.click_fn))
    return apps


def _chunks(wav_path):
    """The eval wav as the microphone delivers it: 640 ms int16 pieces, one
    of them float32 and one stereo int16, a None chunk among them."""
    wav, sr = load_audio(wav_path)
    n = sr * PIECE_MS // 1000
    pcm = np.round(wav * 32767.0).astype(np.int16)
    pieces = [pcm[i : i + n] for i in range(0, len(pcm), n)]
    chunks = [(sr, pieces[0]), None, (sr, pieces[1].astype(np.float32) / 32768.0)]
    chunks += [(sr, np.stack([p, p // 2], axis=1)) for p in pieces[2:]]
    return chunks


def test_gradio_app_matches_jax(fake_gradio, micro):
    """Each chunk's transcript equals JAX's app's and the last is not
    empty; Reset returns "" and starts a fresh session: the chunks streamed
    again give the same transcripts."""
    (j_stream, j_reset), (p_stream, p_reset) = _apps(fake_gradio, micro)
    chunks = _chunks(micro[2])
    assert len(chunks) >= 4
    outs = []
    for c in chunks:
        want, got = j_stream(c), p_stream(c)
        assert isinstance(got, str) and got == want
        outs.append(got)
    assert outs[1] == "" and outs[-1] != ""
    assert p_reset() == "" and j_reset() == ""
    for c, out in zip(chunks, outs):
        assert p_stream(c) == j_stream(c) == out


def test_gradio_main(monkeypatch, micro, fake_gradio):
    """``main`` builds the runner from --config / --checkpoint / --device
    and launches on --port; without gradio it exits with JAX's message."""
    _, cfg_path, _ = micro
    launched = {}
    monkeypatch.setattr(_FakeBlocks, "launch", lambda self, **k: launched.update(k),
                        raising=True)
    gradio_server.main(["--config", cfg_path, "--checkpoint", FIXTURE, "--device", "cpu",
                        "--port", "7861"])
    assert launched == {"server_port": 7861}
    monkeypatch.setitem(sys.modules, "gradio", None)      # import gradio raises
    with pytest.raises(SystemExit, match="gradio is not installed"):
        gradio_server.main(["--config", cfg_path, "--checkpoint", FIXTURE, "--device", "cpu"])


@pytest.mark.parametrize("server", ["rest", "websocket", "gradio"])
def test_servers_take_checkpoint(server, monkeypatch, micro):
    """Every serving entry point takes the weights as --checkpoint (JAX's
    flag), an .npz of the JAX layout; the runner serves them."""
    _, cfg_path, _ = micro
    seen = {}

    def capture(runner, *a, **k):
        seen["runner"] = runner

    argv = ["--config", cfg_path, "--checkpoint", FIXTURE, "--device", "cpu"]
    if server == "rest":
        monkeypatch.setattr(rest_server, "serve", capture)
        rest_server.main(argv)
    elif server == "websocket":
        monkeypatch.setattr(websocket_server, "serve_async", capture)
        monkeypatch.setattr(websocket_server.asyncio, "run", lambda coro: None)
        websocket_server.main(argv)
    else:
        monkeypatch.setattr(gradio_server, "build_app", lambda runner: capture(runner) or
                            types.SimpleNamespace(launch=lambda **k: None))
        gradio_server.main(argv)
    want = j_load_npz(FIXTURE)["joint"]["ffn_out"]["kernel"]
    got = seen["runner"].params["joint"]["ffn_out"]["kernel"]
    np.testing.assert_array_equal(got.numpy(), want)
