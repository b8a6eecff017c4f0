"""Threaded output writers: overlap formatting (CPU) with file writes (IO).

The one-shot tools' tail stage is "format bytes, write them, write the
second copy" — serial CPU+IO+IO. TeeWriter runs one writer thread per
destination fed from a bounded queue, so formatting chunk k+1 overlaps
writing chunk k on every destination concurrently (the kt_pipeline
read/compute/write overlap of the reference, klib/kthread.c:83-143, on the
output side).
"""

from __future__ import annotations

import queue
import threading
from typing import Sequence


class TeeWriter:
    """Write the same chunk stream to several file objects concurrently."""

    def __init__(self, sinks: Sequence, maxsize: int = 4):
        self._sinks = list(sinks)
        self._qs = [queue.Queue(maxsize=maxsize) for _ in self._sinks]
        self._errs: list[BaseException | None] = [None] * len(self._sinks)
        self._threads = []
        for i, (s, q) in enumerate(zip(self._sinks, self._qs)):
            t = threading.Thread(target=self._drain, args=(i, s, q),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _drain(self, i, sink, q) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            if self._errs[i] is not None:
                continue  # keep draining so the producer never blocks
            try:
                sink.write(item)
            except BaseException as e:  # surfaced in close()
                self._errs[i] = e

    def write(self, data) -> None:
        for q in self._qs:
            q.put(data)

    def close(self) -> None:
        """Flush queues, join threads, re-raise the first writer error."""
        for q in self._qs:
            q.put(None)
        for t in self._threads:
            t.join()
        for e in self._errs:
            if e is not None:
                raise e


def prefetch1(gen):
    """Pull items of `gen` one ahead on a worker thread: the producer's
    next item computes while the consumer handles the current one.
    Exceptions re-raise in order at the consumer.

    Abandon-safe: if the consumer stops iterating (close()/GeneratorExit/
    an exception mid-loop), the worker is signalled instead of blocking
    forever on the full queue, and it closes the inner generator so its
    resources (fds, producer threads — e.g. an abandoned
    stream_pileup_events) are released promptly in long-lived processes."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=1)
    done = object()
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            it = iter(gen)
            while not stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    put_or_stop(done)
                    return
                except BaseException as e:  # noqa: BLE001 - relayed
                    put_or_stop(e)
                    return
                if not put_or_stop(item):
                    return
        finally:
            if stop.is_set():
                try:  # release the abandoned source's fds/threads
                    gen.close()
                except BaseException:  # noqa: BLE001 - best-effort
                    pass

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:  # wake a worker mid-put immediately
            q.get_nowait()
        except queue.Empty:
            pass
