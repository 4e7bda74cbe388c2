"""Micro-batching stream scheduler (JAX ``serve/scheduler.py``): N
concurrent connections, one batched chunk step per tick.

Connections claim slots of a ``SessionPool`` (``decode/stream_batch.py``)
on the scheduler's device; one worker thread coalesces whatever chunks are
pending across connections into one ``pool_step`` call on [n_slots, Tc,
F], so no device work runs on a caller's (or an asyncio event loop's)
thread.

Client API (thread-safe, callable from any number of threads):
    slot = sched.open()                     # claim + reset a slot
    sched.feed(slot, pcm_f32, sr)           # buffer audio (fbank on caller)
    ids = sched.flush_wait(slot)            # steps through buffered chunks,
                                            # returns the running transcript
    ids = sched.close(slot)                 # final flush + free the slot

Each tick consumes ``stride`` feature frames per active slot but reads a
``window``-frame slice (3 frames overlap), which gives
``decoding_chunk_size`` subsampled frames (``chunk_window_params``).

Where torch differs from JAX:
  - ``torch.inference_mode`` is thread-local: the worker thread enters it
    itself, or every tick would record an autograd graph;
  - ``transfer_dtype="bfloat16"`` converts the tick's chunk batch on the
    host with torch before the copy to the device;
  - there is no buffer donation: each tick replaces the pool's tensors.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import Config
from ..decode.greedy import init_greedy_state
from ..decode.stream_batch import init_pool, pool_reset_slots, pool_step
from ..device import resolve_device
from ..models import encoder as encoder_mod
from ..ops.fbank import fbank_numpy, frame_params, num_frames


class PoolFull(RuntimeError):
    """open() found no free slot. Distinct from the RuntimeError of a dead
    worker, so that a retry loop can spin on pool exhaustion alone."""


class Backpressure(RuntimeError):
    """feed would exceed the slot's admission-controlled buffer depth."""


class StreamFeaturizer:
    """Incremental log-mel fbank over a growing PCM stream. Frames are
    window-local (DC offset and preemphasis per frame), so audio fed
    piecewise gives the features of one batch call, bit for bit."""

    def __init__(self, data_cfg):
        self.cfg = data_cfg
        ws, shift, _ = frame_params(data_cfg.resample_rate, data_cfg.frame_length,
                                    data_cfg.frame_shift)
        self._ws, self._shift = ws, shift
        self._buf = np.zeros((0,), np.float32)

    def feed(self, wav: np.ndarray) -> np.ndarray:
        """Append samples (float32 in [-1, 1]); return the newly completed
        feature frames [n, num_mel_bins] (n may be 0)."""
        self._buf = np.concatenate([self._buf, np.asarray(wav, np.float32)])
        n = num_frames(len(self._buf), self._ws, self._shift)
        if n == 0:
            return np.zeros((0, self.cfg.num_mel_bins), np.float32)
        used = (n - 1) * self._shift + self._ws
        feats = fbank_numpy(
            self._buf[:used] * (1 << 15), sample_rate=self.cfg.resample_rate,
            num_mel_bins=self.cfg.num_mel_bins, frame_length=self.cfg.frame_length,
            frame_shift=self.cfg.frame_shift, dither=0.0,
        )
        self._buf = self._buf[n * self._shift:]
        return feats


@dataclass
class _Slot:
    in_use: bool = False
    closing: bool = False
    in_flight: bool = False
    buf: np.ndarray = field(default_factory=lambda: np.zeros((0, 1), np.float32))
    featurizer: StreamFeaturizer | None = None
    ready_ts: float | None = None   # when the oldest pending chunk completed
    final_ids: list | None = None   # set exactly once, when the slot is freed


class StreamScheduler:
    """The pool, its worker thread and the client API. ``params`` lie on
    ``device`` (the card unless the CPU is asked for).

    Admission is checked per call, as in JAX: ``feed_frames`` waits (or
    raises ``Backpressure``) only while the slot already holds
    ``max_buffer_chunks`` undecoded chunks, and then appends the whole
    call's frames, so one large call can leave the slot above the limit.

    Counters: ``chunk_latencies`` (seconds from a chunk being complete to
    its tick returning) and ``step_records`` ((host seconds of
    ``pool_step``, active slots) per tick). The greedy loop reads ``any(t
    < lens)`` on the host, so a step's host time waits for its encoder and
    decode on the device, all but the last state merges."""

    def __init__(self, params, cfg: Config, *, n_slots: int = 16, max_wait_ms: float = 2.0,
                 transfer_dtype: str = "float32", max_buffer_chunks: int = 8, device=None):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.device = resolve_device(device)
        # host->device dtype of each tick's chunk batch: bfloat16 halves the
        # copy (the encoder casts to its compute dtype anyway); float32
        # keeps bitwise parity with the B=1 session path
        self._transfer_dtype = torch.bfloat16 if transfer_dtype == "bfloat16" else torch.float32
        mcfg = cfg.model
        dc = cfg.decode
        self.chunk = dc.decoding_chunk_size
        self.stride, self.window, self.context = encoder_mod.chunk_window_params(self.chunk)
        self.cache_size = max(self.chunk * max(dc.num_decoding_left_chunks, 1), 64)
        self.max_hyp_len = dc.max_hyp_len
        self._n_steps = dc.n_steps
        self._max_wait = max_wait_ms / 1e3
        # admission control: a slot buffers at most this many undecoded
        # chunks, so that a client faster than real time cannot build an
        # unbounded queue behind every other stream
        self._max_buf_frames = (
            self.window + max(0, max_buffer_chunks - 1) * self.stride
            if max_buffer_chunks > 0 else None
        )
        with torch.inference_mode():
            self._fresh_dec = init_greedy_state(params, mcfg, 1, self.device)
            self._pool = init_pool(params, mcfg, n_slots, cache_size=self.cache_size,
                                   max_hyp_len=self.max_hyp_len, device=self.device)

        self._cond = threading.Condition()
        self._slots = [_Slot() for _ in range(n_slots)]
        self._pending_reset = np.zeros((n_slots,), bool)
        self._hyps_host = np.full((n_slots, self.max_hyp_len), mcfg.blank_id, np.int32)
        self._hyp_len_host = np.zeros((n_slots,), np.int32)
        self._stop = False
        self._worker_error: BaseException | None = None
        # transcripts are fetched from the device lazily: only when a
        # flush_wait / close waiter needs them or a stream finalizes
        self._host_stale = False
        self._need_fetch = False
        self.chunk_latencies: list[float] = []
        self.step_records: list[tuple[float, int]] = []   # (step_s, n_active)

        self._worker = threading.Thread(target=self._run_guarded, daemon=True)
        self._worker.start()

    def _run_guarded(self) -> None:
        try:
            with torch.inference_mode():   # thread-local: entered on this thread
                self._run()
        except BaseException as e:  # noqa: BLE001 (surfaced to every waiter)
            with self._cond:
                self._worker_error = e
                self._stop = True
                self._cond.notify_all()

    def _check_worker(self) -> None:
        if self._worker_error is not None:
            raise RuntimeError("stream scheduler worker died") from self._worker_error

    # ------------------------------------------------------------- client API

    def open(self) -> int:
        """Claim a free slot; raises PoolFull when every slot is in use."""
        with self._cond:
            self._check_worker()
            for i, s in enumerate(self._slots):
                if not s.in_use:
                    self._slots[i] = _Slot(
                        in_use=True,
                        buf=np.zeros((0, self.cfg.data.num_mel_bins), np.float32),
                        featurizer=StreamFeaturizer(self.cfg.data),
                    )
                    self._pending_reset[i] = True
                    self._hyp_len_host[i] = 0
                    return i
        raise PoolFull(f"all {self.n_slots} stream slots in use")

    def feed(self, slot: int, wav: np.ndarray, sr: int | None = None) -> None:
        """Buffer raw audio samples (float32 [-1, 1]) for a slot. One feeder
        per slot (the owning connection): the fbank runs outside the
        scheduler's lock, so N connections' features do not serialize."""
        if sr is not None and sr != self.cfg.data.resample_rate:
            from ..data.audio import resample

            wav = resample(wav, sr, self.cfg.data.resample_rate)
        with self._cond:
            s = self._slots[slot]
            if not s.in_use or s.closing:
                raise RuntimeError(f"slot {slot} not open")
        frames = s.featurizer.feed(wav)   # per-slot state, owner-only
        if len(frames):
            self.feed_frames(slot, frames)

    def feed_frames(self, slot: int, frames: np.ndarray, *, block: bool = True,
                    timeout: float = 30.0) -> None:
        """Buffer feature frames [n, F]. While the slot holds
        ``max_buffer_chunks`` undecoded chunks, wait for the worker to
        drain it (``block``) or raise Backpressure."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                s = self._slots[slot]
                if not s.in_use or s.closing:
                    raise RuntimeError(f"slot {slot} not open")
                if self._max_buf_frames is None or len(s.buf) < self._max_buf_frames:
                    break
                if not block:
                    raise Backpressure(f"slot {slot} buffer at admission limit")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"feed_frames(slot={slot}) timed out")
                self._cond.wait(remaining)
                self._check_worker()
            s.buf = np.concatenate([s.buf, np.asarray(frames, np.float32)])
            if len(s.buf) >= self.window and s.ready_ts is None:
                s.ready_ts = time.perf_counter()
            self._cond.notify_all()

    def transcript(self, slot: int) -> list[int]:
        """The latest fetched ids of a slot (no waiting; may lag the device
        by the ticks since the last flush_wait / close)."""
        with self._cond:
            n = int(self._hyp_len_host[slot])
            return self._hyps_host[slot, :n].tolist()

    def flush_wait(self, slot: int, timeout: float = 30.0) -> list[int]:
        """Wait until every buffered FULL chunk of the slot is decoded;
        return the running transcript."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._stop:
                pending = (len(self._slots[slot].buf) >= self.window
                           or self._slots[slot].in_flight)
                if not pending:
                    if not self._host_stale:
                        break
                    self._need_fetch = True
                    self._cond.notify_all()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"flush_wait(slot={slot}) timed out")
                self._cond.wait(remaining)
            self._check_worker()
            n = int(self._hyp_len_host[slot])
            return self._hyps_host[slot, :n].tolist()

    def close(self, slot: int, timeout: float = 30.0) -> list[int]:
        """Decode the final (padded) partial chunk, free the slot and return
        the final transcript."""
        deadline = time.monotonic() + timeout
        with self._cond:
            s = self._slots[slot]
            if not s.in_use:
                raise RuntimeError(f"slot {slot} not open")
            s.closing = True
            self._cond.notify_all()
            # wait on the slot OBJECT: if the index is reopened by another
            # client, this transcript stays this caller's
            while s.final_ids is None and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"close(slot={slot}) timed out")
                self._cond.wait(remaining)
            self._check_worker()
            return list(s.final_ids or [])

    def shutdown(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=10)

    def stats(self) -> dict:
        """Chunk latency p50 / p99 (complete -> decoded), step timing and
        queue depths."""
        with self._cond:
            lats = sorted(self.chunk_latencies)
            steps = list(self.step_records)
            depths = [
                max(0, 1 + (len(s.buf) - self.window) // self.stride)
                if len(s.buf) >= self.window else 0
                for s in self._slots if s.in_use
            ]
        out = {"chunks": len(lats), "steps": len(steps), "open_slots": len(depths)}
        out["queue_depth_mean"] = round(sum(depths) / len(depths), 2) if depths else 0.0
        out["queue_depth_max"] = max(depths) if depths else 0
        if lats:
            out["chunk_latency_p50_ms"] = round(lats[len(lats) // 2] * 1e3, 2)
            out["chunk_latency_p99_ms"] = round(
                lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3, 2)
        if steps:
            out["step_ms_mean"] = round(sum(t for t, _ in steps) / len(steps) * 1e3, 2)
            out["active_per_step_mean"] = round(sum(n for _, n in steps) / len(steps), 2)
        return out

    # ---------------------------------------------------------------- worker

    def _subsampled(self, n_frames: int) -> int:
        return max(((n_frames - 1) // 2 - 1) // 2, 0)

    def _collect(self):
        """(lock held) This tick's work: full chunks, padded final chunks,
        empty closes, pending resets."""
        n_mel = self.cfg.data.num_mel_bins
        reset_mask = self._pending_reset.copy()
        work = []         # (slot, chunk [window, F], out_valid, ready_ts)
        empty_close = []  # closing slots with nothing left to decode
        for i, s in enumerate(self._slots):
            if not s.in_use:
                continue
            if len(s.buf) >= self.window:
                work.append((i, s.buf[: self.window], self.chunk, s.ready_ts))
            elif s.closing:
                n = len(s.buf)
                valid = self._subsampled(n)
                if valid > 0:
                    chunk = np.zeros((self.window, n_mel), np.float32)
                    chunk[:n] = s.buf
                    work.append((i, chunk, valid, s.ready_ts))
                else:
                    empty_close.append(i)
        return reset_mask, work, empty_close

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.to(dtype if dtype is not None else t.dtype).to(self.device)

    def _run(self) -> None:
        n_mel = self.cfg.data.num_mel_bins
        mcfg = self.cfg.model
        while True:
            with self._cond:
                while not self._stop:
                    reset_mask, work, empty_close = self._collect()
                    if (work or empty_close or reset_mask.any()
                            or (self._need_fetch and self._host_stale)):
                        break
                    self._cond.wait()
                if self._stop:
                    return
                # a short coalescing window: concurrent feeds land in this
                # tick instead of the next
                if 0 < len(work) < self.n_slots and self._max_wait > 0:
                    self._cond.wait(self._max_wait)
                    reset_mask, work, empty_close = self._collect()
                self._pending_reset[:] = False
                want_fetch = self._need_fetch and self._host_stale
                chunks = np.zeros((self.n_slots, self.window, n_mel), np.float32)
                active = np.zeros((self.n_slots,), bool)
                out_valid = np.zeros((self.n_slots,), np.int32)
                final_slots = []
                for i, chunk, valid, _ in work:
                    s = self._slots[i]
                    chunks[i] = chunk
                    active[i] = True
                    out_valid[i] = valid
                    s.in_flight = True
                    if valid == self.chunk:
                        s.buf = s.buf[self.stride:]
                        s.ready_ts = time.perf_counter() if len(s.buf) >= self.window else None
                    else:  # padded final chunk
                        s.buf = s.buf[:0]
                        s.ready_ts = None
                        final_slots.append(i)

            # ---- device work, lock released so that feeds keep landing
            if reset_mask.any():
                self._pool = pool_reset_slots(self._pool, self._to_device(reset_mask),
                                              self._fresh_dec, mcfg.blank_id)
            stepped = bool(active.any())
            dt = 0.0
            if stepped:
                t0 = time.perf_counter()
                self._pool = pool_step(
                    self.params, self._pool, self._to_device(chunks, self._transfer_dtype),
                    self._to_device(active), self._to_device(out_valid), mcfg,
                    n_steps=self._n_steps)
                dt = time.perf_counter() - t0
            # one device-to-host copy, only when a stream finalizes or a
            # waiter asked for it
            hyps = hyp_len = None
            if final_slots or empty_close or want_fetch:
                hyps = np.array(self._pool.hyps.cpu())
                hyp_len = np.array(self._pool.hyp_len.cpu())

            with self._cond:
                now = time.perf_counter()
                if stepped:
                    self.step_records.append((dt, int(active.sum())))
                    self._host_stale = True
                if hyps is not None:
                    # a slot reopened (pending reset) after this fetch was
                    # taken must not get its previous occupant's transcript
                    # back over the zero open() wrote
                    for j in np.nonzero(self._pending_reset)[0]:
                        hyp_len[j] = 0
                    self._hyps_host = hyps
                    self._hyp_len_host = hyp_len
                    self._host_stale = False
                    self._need_fetch = False
                for i, _, _, ready_ts in work:
                    self._slots[i].in_flight = False
                    if ready_ts is not None:
                        self.chunk_latencies.append(now - ready_ts)
                for i in final_slots + empty_close:
                    s = self._slots[i]
                    n = int(self._hyp_len_host[i])
                    s.final_ids = self._hyps_host[i, :n].tolist()
                    s.in_use = False
                    s.closing = False
                self._cond.notify_all()
