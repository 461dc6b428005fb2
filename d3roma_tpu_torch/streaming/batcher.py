"""Dynamic micro-batching for multi-stream serving.

Port of `d3roma_tpu/streaming/batcher.py`, pure Python. The reference
processes one frame per pipeline call (d3roma_processor.py:24-286); when
several cameras or clients share one card, one batched call per group of
frames amortizes the weights' reads and the launches of a call over the
frames (PERF.md's serve cell measures what that buys on the card).

`MicroBatcher` aggregates concurrent requests into fixed-size batches:

- `submit(item)` enqueues and returns a `concurrent.futures.Future`.
- A worker thread collects up to `max_batch` items, waiting at most
  `max_wait_ms` after the first one arrives, calls `infer_batch(items)`
  once and resolves each Future with its row.
- With `pad=True` the batch is padded by repeating its last item up to
  `max_batch`, so every call has the same batch size; the padded rows are
  dropped before resolution. With `pad=False` partial batches go through at
  their own size.

The batcher is model-agnostic: `infer_batch` takes the list of submitted
items and returns an indexable of per-item results in order.
`d3roma_tpu_torch.inference.D3RoMa.infer_with_rgb_raw_batch` is the
intended callee. The model runs on the worker thread: thread-local state a
caller sets on another thread (an activation-scale capture or replay, for
one) is not seen there.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

__all__ = ["MicroBatcher"]


class MicroBatcher:
    def __init__(
        self,
        infer_batch: Callable[[List], Sequence],
        max_batch: int = 16,
        max_wait_ms: float = 25.0,
        pad: bool = True,
        queue_size: int = 256,
    ):
        assert max_batch >= 1
        self.infer_batch = infer_batch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.pad = pad
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        # serializes submit's (check-stop, enqueue) against stop's (set-stop,
        # drain/sentinel): without it an item enqueued between the worker's
        # last stop-and-empty check and its exit would never resolve
        self._lifecycle = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="d3roma-microbatcher", daemon=True)
        self._worker.start()
        # telemetry (coarse counters, read without a lock)
        self.batches = 0
        self.items = 0
        self.padded_rows = 0

    def submit(self, item) -> Future:
        """Enqueue one request; the Future resolves to its result row (or
        raises what `infer_batch` raised for its batch).

        Raises RuntimeError when stopped or when the worker has died, and
        queue.Full (without blocking) when the backlog is at capacity: the
        serving layer answers that with 503 instead of piling up blocked
        handler threads that the request timeout cannot bound."""
        fut: Future = Future()
        with self._lifecycle:
            if self._stop.is_set():
                raise RuntimeError("MicroBatcher is stopped")
            if not self._worker.is_alive():
                raise RuntimeError("MicroBatcher worker has died")
            self._q.put_nowait((item, fut))  # queue.Full propagates
        return fut

    def stop(self, drain: bool = True, timeout: Optional[float] = 10.0):
        """Stop the worker. With `drain=True` queued requests are still
        processed; otherwise they are cancelled."""
        with self._lifecycle:
            # stop before draining: a racing submit can no longer slip an
            # item past the cancellation loop
            self._stop.set()
            if not drain:
                try:
                    while True:
                        entry = self._q.get_nowait()
                        if entry is not None:
                            entry[1].cancel()
                except queue.Empty:
                    pass
            # wake a worker waiting on an empty queue; a full queue wakes it
            # anyway (and a blocking put would hold the lock indefinitely)
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
        self._worker.join(timeout=timeout)

    def _collect(self) -> List:
        """Block for the first item, then take what arrives within
        max_wait_s, up to max_batch."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while not (self._stop.is_set() and self._q.empty()):
            # claim each future: one cancelled while queued is dropped here,
            # and a claimed one can no longer be cancelled, so the
            # set_result / set_exception below cannot raise InvalidStateError
            # and kill the worker
            pairs = [(it, f) for it, f in self._collect()
                     if f.set_running_or_notify_cancel()]
            if not pairs:
                continue
            items = [p[0] for p in pairs]
            n = len(items)
            if self.pad and n < self.max_batch:
                items = items + [items[-1]] * (self.max_batch - n)
                self.padded_rows += self.max_batch - n
            try:
                results = self.infer_batch(items)
                self.batches += 1
                self.items += n
                for i, (_, fut) in enumerate(pairs):
                    fut.set_result(results[i])
            except BaseException as e:  # noqa: BLE001 - fail the whole batch
                # a SystemExit or fatal runtime error still resolves the
                # claimed futures (their clients would hang otherwise) before
                # it ends the worker; submit() then sees the dead worker
                for _, fut in pairs:
                    if not fut.done():
                        fut.set_exception(
                            e if isinstance(e, Exception)
                            else RuntimeError(f"worker died: {e!r}"))
                if not isinstance(e, Exception):
                    raise
