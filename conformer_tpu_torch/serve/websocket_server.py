"""WebSocket streaming ASR server (JAX ``serve/websocket_server.py``), with
the same protocol:
  - JSON control frames {"signal": 1} (start) and {"signal": 0} (end);
    any other text frame is a wav FILE PATH; binary frames are raw audio
    (16 kHz 16-bit PCM);
  - the server replies with the running transcript after each audio frame,
    and "$start$" / "$final$<transcript>" to the control frames;
  - a frame whose handling raises gets {"status": "fail", "message": ...}
    and the connection goes on (a per-frame error barrier).

With more than one slot (the default, 16), connections share the runner's
micro-batching scheduler (``serve/scheduler.py``); with ``--slots 1`` each
connection owns a B=1 ``StreamingSession``. ``websockets`` is imported
only when the server starts.

Usage:
    python -m conformer_tpu_torch.serve.websocket_server --config cfg.json \
        --checkpoint params.npz --port 8000
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os

import numpy as np

from ..config import Config
from ..data.audio import load_audio
from .runner import ModelRunner

logger = logging.getLogger(__name__)


async def _send_fail(websocket, e: Exception) -> bool:
    """Log the frame's failure and send the fail reply; False when the
    peer is already gone."""
    logger.exception("websocket frame handling failed")
    try:
        await websocket.send(json.dumps({"status": "fail",
                                         "message": f"{type(e).__name__}: {e}"}))
    except Exception:  # noqa: BLE001 (the peer is gone: end the connection)
        return False
    return True


def _pcm(message: bytes) -> np.ndarray:
    return np.frombuffer(message, np.int16).astype(np.float32) / 32768.0


async def handle_connection_pooled(runner: ModelRunner, websocket, scheduler) -> None:
    """Scheduler-backed handler: this connection's audio rides a slot of the
    shared pool, whose worker thread batches the decode steps of every live
    connection; the blocking calls run off the event loop."""
    slot = None
    sr = runner.cfg.data.resample_rate
    try:
        async for message in websocket:
            try:
                if isinstance(message, (bytes, bytearray)):
                    if slot is None:
                        continue
                    await asyncio.to_thread(scheduler.feed, slot, _pcm(message), sr)
                    ids = await asyncio.to_thread(scheduler.flush_wait, slot)
                    await websocket.send(runner._ids_to_text(ids))
                    continue
                try:
                    obj = json.loads(message)
                except json.JSONDecodeError:
                    obj = None
                if isinstance(obj, dict) and "signal" in obj:
                    if obj["signal"] == 1:
                        slot = scheduler.open()
                        await websocket.send("$start$")
                    else:
                        text = ""
                        if slot is not None:
                            ids = await asyncio.to_thread(scheduler.close, slot)
                            text = runner._ids_to_text(ids)
                            slot = None
                        await websocket.send("$final$" + text)
                elif isinstance(message, str) and os.path.exists(message):
                    if slot is None:
                        slot = scheduler.open()
                    wav, wav_sr = load_audio(message)
                    await asyncio.to_thread(scheduler.feed, slot, wav, wav_sr)
                    ids = await asyncio.to_thread(scheduler.flush_wait, slot)
                    await websocket.send(runner._ids_to_text(ids))
                else:
                    await websocket.send(json.dumps({"status": "fail", "message": "bad frame"}))
            except Exception as e:  # noqa: BLE001 (the per-frame error barrier)
                if not await _send_fail(websocket, e):
                    return
    finally:
        if slot is not None:   # free the slot on an abrupt disconnect
            try:
                await asyncio.to_thread(scheduler.close, slot)
            except Exception:  # noqa: BLE001 (cleanup of a dropped connection)
                logger.exception("slot cleanup failed")


async def handle_connection(runner: ModelRunner, websocket) -> None:
    """B=1 handler: the connection owns one ``StreamingSession``."""
    session = None
    async for message in websocket:
        try:
            if isinstance(message, (bytes, bytearray)):
                if session is None:
                    continue
                session, rec = await asyncio.to_thread(
                    runner.accept_chunk, session, _pcm(message), runner.cfg.data.resample_rate)
                await websocket.send(rec.text)
                continue
            try:
                obj = json.loads(message)
            except json.JSONDecodeError:
                obj = None
            if isinstance(obj, dict) and "signal" in obj:
                if obj["signal"] == 1:
                    session = await asyncio.to_thread(runner.new_session)
                    await websocket.send("$start$")
                else:
                    text = ""
                    if session is not None:
                        text = runner._ids_to_text(runner.session_ids(session))
                    session = None
                    await websocket.send("$final$" + text)
            elif isinstance(message, str) and os.path.exists(message):
                if session is None:
                    session = await asyncio.to_thread(runner.new_session)
                wav, sr = load_audio(message)
                session, rec = await asyncio.to_thread(runner.accept_chunk, session, wav, sr)
                await websocket.send(rec.text)
            else:
                await websocket.send(json.dumps({"status": "fail", "message": "bad frame"}))
        except Exception as e:  # noqa: BLE001 (the per-frame error barrier)
            if not await _send_fail(websocket, e):
                return


async def serve_async(runner: ModelRunner, host: str, port: int, slots: int = 16) -> None:
    import websockets

    scheduler = runner.make_scheduler(n_slots=slots) if slots > 1 else None

    async def handler(ws):
        if scheduler is not None:
            await handle_connection_pooled(runner, ws, scheduler)
        else:
            await handle_connection(runner, ws)

    try:
        async with websockets.serve(handler, host, port, max_size=1 << 24):
            mode = f"{slots}-slot micro-batched" if scheduler else "single-stream"
            print(f"WebSocket streaming server ({mode}) on ws://{host}:{port}")
            await asyncio.Future()
    finally:
        if scheduler is not None:
            scheduler.shutdown()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="JAX params .npz (save_params_npz format) or a reference / WeNet "
                         "state dict (.pt, .ckpt, .pth); random init if omitted")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=16,
                    help="stream slots in the micro-batching pool (1: one session per connection)")
    args = ap.parse_args(argv)
    cfg = Config.from_json_file(args.config) if args.config else Config()
    runner = ModelRunner(cfg, args.checkpoint, args.device)
    asyncio.run(serve_async(runner, args.host, args.port, slots=args.slots))


if __name__ == "__main__":
    main()
