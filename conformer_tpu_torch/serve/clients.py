"""Example clients of the REST and WebSocket servers (JAX
``serve/clients.py``).

    python -m conformer_tpu_torch.serve.clients rest --wav a.wav
    python -m conformer_tpu_torch.serve.clients stream --wav a.wav
"""

from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np


def rest_client(url: str, wav_path: str) -> None:
    import requests

    with open(wav_path, "rb") as f:
        resp = requests.post(url, files={"audio": f}, timeout=600)
    print(resp.json())


async def stream_client(url: str, wav_path: str, chunk_ms: int = 640) -> None:
    """Stream a wav as int16 PCM pieces of ``chunk_ms``, printing every
    reply: "$start$", one partial transcript per piece, "$final$..."."""
    import websockets

    from ..data.audio import load_audio

    wav, sr = load_audio(wav_path)
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    chunk = int(sr * chunk_ms / 1000)
    async with websockets.connect(url) as ws:
        await ws.send(json.dumps({"signal": 1}))
        print(await ws.recv())
        for i in range(0, len(pcm), chunk):
            await ws.send(pcm[i:i + chunk].tobytes())
            print("partial:", await ws.recv())
        await ws.send(json.dumps({"signal": 0}))
        print(await ws.recv())


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["rest", "stream"])
    ap.add_argument("--wav", required=True)
    ap.add_argument("--url", default=None)
    args = ap.parse_args(argv)
    if args.mode == "rest":
        rest_client(args.url or "http://127.0.0.1:9000/recognize/", args.wav)
    else:
        asyncio.run(stream_client(args.url or "ws://127.0.0.1:8000", args.wav))


if __name__ == "__main__":
    main()
