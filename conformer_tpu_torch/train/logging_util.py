"""Metric logging (the JAX package's ``train/logging_util.py``): one line
per record on stderr, and either Weights & Biases, when asked for and
importable, or a JSONL file ``<log_dir>/<name>`` (``metrics.jsonl``) of
{step, time, **metrics} objects. The file is opened at the first record.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str, project: str = "conformer-rnnt", use_wandb: bool = False,
                 name: str = "metrics.jsonl"):
        self.path = os.path.join(log_dir, name)
        self._f = None
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("wandb is not installed; logging to " + self.path, file=sys.stderr)
            else:
                wandb.init(project=project, dir=log_dir)
                self._wandb = wandb

    def log(self, step: int, metrics: dict[str, Any], prefix: str = "") -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({prefix + k: _to_py(v) for k, v in metrics.items()})
        if self._wandb is not None:
            self._wandb.log({prefix + k: _to_py(v) for k, v in metrics.items()}, step=step)
        else:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._f = open(self.path, "a")
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        pretty = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items() if k != "time"
        )
        print(f"[{rec['time']:9.1f}s] {pretty}", file=sys.stderr)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._wandb is not None:
            self._wandb.finish()


def _to_py(v: Any):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
