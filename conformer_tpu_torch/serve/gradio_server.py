"""Gradio live-microphone demo (the JAX package's ``serve/gradio_server.py``;
reference backend ``gradio_server.py``): the microphone's stream feeds one
live session of ``ModelRunner`` (``new_session`` / ``accept_chunk``), and
the "Reset Model" button starts a fresh one.

    python -m conformer_tpu_torch.serve.gradio_server --config cfg.json \\
        --checkpoint params.npz --port 7860

``gradio`` is imported by ``build_app``, not at import; without it ``main``
exits with a message. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import Config
from .runner import ModelRunner


def build_app(runner: ModelRunner):
    """The demo's Blocks: a transcript box, a streaming microphone whose
    callback takes gradio's ``(sample_rate, samples)`` and returns the
    running transcript, and the reset button."""
    import gradio as gr

    state_holder = {"session": runner.new_session()}

    def transcribe(audio):
        if audio is None:
            return ""
        sr, wav = audio
        if wav.dtype != np.float32:         # int16 PCM, as the microphone sends it
            wav = wav.astype(np.float32) / 32768.0
        if wav.ndim == 2:
            wav = wav.mean(axis=1)
        state_holder["session"], rec = runner.accept_chunk(state_holder["session"], wav, sr)
        return rec.text

    def reset():
        state_holder["session"] = runner.new_session()
        return ""

    with gr.Blocks() as demo:
        out = gr.Textbox(label="transcript")
        mic = gr.Audio(sources=["microphone"], streaming=True)
        mic.stream(transcribe, inputs=mic, outputs=out)
        gr.Button("Reset Model").click(reset, outputs=out)
    return demo


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="JAX params .npz (save_params_npz format) or a reference / WeNet "
                         "state dict (.pt, .ckpt, .pth); random init if omitted")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args(argv)
    cfg = Config.from_json_file(args.config) if args.config else Config()
    runner = ModelRunner(cfg, args.checkpoint, args.device)
    try:
        app = build_app(runner)
    except ImportError as e:
        raise SystemExit(f"gradio is not installed in this image: {e}")
    app.launch(server_port=args.port)


if __name__ == "__main__":
    main()
