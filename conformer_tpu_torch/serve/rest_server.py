"""REST recognition server on the stdlib http.server (JAX
``serve/rest_server.py``), with the same protocol:

    POST /recognize/   multipart form field "audio" (or a raw wav body)
    -> {"status": "success", "message": "<transcript>"}
    errors -> {"status": "fail", "message": "..."}

Also serves GET /health. Threaded: requests share the runner, whose decode
calls take its lock.

Usage:
    python -m conformer_tpu_torch.serve.rest_server --config cfg.json \
        --checkpoint params.npz --port 9000
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..config import Config
from .runner import ModelRunner


def parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    """Minimal multipart/form-data parser (cgi was removed in Python 3.13)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    boundary = ("--" + m.group(1)).encode()
    fields: dict[str, bytes] = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        header_blob, _, content = part.partition(b"\r\n\r\n")
        name_m = re.search(rb'name="([^"]+)"', header_blob)
        if name_m:
            fields[name_m.group(1).decode()] = content.rstrip(b"\r\n")
    return fields


def make_handler(runner: ModelRunner):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") in ("", "/health"):
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"status": "fail", "message": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path.rstrip("/") != "/recognize":
                self._send(404, {"status": "fail", "message": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("multipart/form-data"):
                    audio = parse_multipart(body, ctype).get("audio")
                    if audio is None:
                        raise ValueError("missing form field 'audio'")
                else:
                    audio = body
                with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                    f.write(audio)
                    f.flush()
                    rec = runner.recognize_file(f.name)
                self._send(200, {"status": "success", "message": rec.text})
            except Exception as e:  # noqa: BLE001 (the protocol reports every failure)
                self._send(200, {"status": "fail", "message": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve(runner: ModelRunner, host: str = "0.0.0.0", port: int = 9000):
    httpd = ThreadingHTTPServer((host, port), make_handler(runner))
    print(f"REST server on http://{host}:{port}/recognize/")
    httpd.serve_forever()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="JAX params .npz (save_params_npz format) or a reference / WeNet "
                         "state dict (.pt, .ckpt, .pth); random init if omitted")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    args = ap.parse_args(argv)
    cfg = Config.from_json_file(args.config) if args.config else Config()
    serve(ModelRunner(cfg, args.checkpoint, args.device), args.host, args.port)


if __name__ == "__main__":
    main()
