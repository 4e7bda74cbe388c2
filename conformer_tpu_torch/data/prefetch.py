"""Background-thread prefetch of training batches (the port's own copy of
the JAX package's ``data/prefetch.py``).

The host pipeline (wav decode, resampling, speed perturbation, fbank,
SpecAugment, batching) runs on a daemon thread, ``depth`` batches ahead,
while the trainer launches the step's kernels; numpy and scipy release
the interpreter lock in their heavy calls, so the two overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher:
    """Iterate `iterable` on a background thread, `depth` items ahead.

    Exceptions in the producer propagate to the consumer at the point of
    `next()`. `close()` (or garbage collection of the iterator) stops the
    producer promptly even if the consumer abandons the stream early.
    """

    def __init__(self, iterable: Iterable[T], depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._produce, args=(iterable,), daemon=True
        )
        self._thread.start()

    def _produce(self, iterable: Iterable[T]) -> None:
        try:
            for item in iterable:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            self._err = e
        while not self._stop.is_set():
            try:
                self._q.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        # poll with a timeout, so that a close() that raced the producer's
        # exit ends the iteration instead of blocking on an empty queue
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
        if item is _SENTINEL:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        self.close()
