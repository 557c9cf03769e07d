"""Background input prefetching for the training loop: a daemon thread
iterates the batch source ``size`` batches ahead into a bounded queue, so
featurization of the next batches overlaps the device's step."""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

_SENTINEL = object()
_POLL_S = 0.1


class Prefetcher:
    """Iterate ``src`` on a background thread, ``size`` batches ahead.

    An exception of the source is raised again on the consuming thread at
    ``__next__``. ``close()`` (or the context manager) stops the thread
    early; every wait polls, so nothing blocks for good."""

    def __init__(self, src: Iterable[Any], size: int = 4) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, size))
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, args=(iter(src),), daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 - raised again on the consumer
            self._error = exc
        finally:
            self._put(_SENTINEL)

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Any:
        while True:
            try:
                item = self._queue.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    raise RuntimeError("prefetch thread ended without a result") from None
        if item is _SENTINEL:
            self._thread.join(timeout=5)
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:  # drain, so a worker blocked on a full queue sees the flag
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch(src: Iterable[Any], size: int = 4) -> Prefetcher:
    return Prefetcher(src, size=size)
