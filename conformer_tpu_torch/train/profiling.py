"""Tracing and timing (JAX ``train/profiling.py``).

- ``device_sync(x)``: wait for the device and fetch a scalar of ``x``;
- ``trace(logdir)``: a ``torch.profiler`` trace of the host and, on the
  card, of CUDA kernels, written under ``logdir`` as a Chrome trace;
- ``StepTimer``: wall time per step with the first steps skipped as
  warm-up, and audio-seconds per second.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _first_leaf(x):
    """The first leaf in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(x, dict):
        return _first_leaf(x[sorted(x)[0]])
    if isinstance(x, (list, tuple)):
        return _first_leaf(x[0])
    return x


def device_sync(x) -> float:
    """Wait for the work behind ``x`` (a tensor or a tree of them) and
    return its first leaf's sum, fetched to the host."""
    leaf = _first_leaf(x)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.sum()) if leaf.dim() else float(leaf)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: CPU activity, and CUDA activity where a card is
    present; the trace goes to ``logdir/trace.json`` (Chrome's trace
    format, read by Perfetto or TensorBoard)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Per-step wall time and audio seconds, the first ``warmup_steps``
    steps left out of the totals."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup = warmup_steps
        self.steps = 0
        self.total_time = 0.0
        self.total_audio_seconds = 0.0
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float = 0.0) -> float:
        """End the step begun by ``start``; returns its seconds."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop without start")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.steps += 1
        if self.steps > self.warmup:
            self.total_time += dt
            self.total_audio_seconds += audio_seconds
        return dt

    @property
    def steps_per_sec(self) -> float:
        counted = max(self.steps - self.warmup, 0)
        return counted / self.total_time if self.total_time else 0.0

    @property
    def audio_seconds_per_sec(self) -> float:
        return self.total_audio_seconds / self.total_time if self.total_time else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "steps_per_sec": round(self.steps_per_sec, 4),
            "audio_seconds_per_sec": round(self.audio_seconds_per_sec, 2),
        }
