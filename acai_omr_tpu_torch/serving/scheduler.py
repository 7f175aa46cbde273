"""Dynamic request batching for the OMR inference service.

The twin of the JAX package's ``serving/scheduler.py``. Requests enqueue one
at a time; a scheduler thread forms batches under a ``(max_batch,
max_wait_ms)`` policy: a full batch flushes at once, and no request waits
more than ``max_wait_ms`` for stragglers. The model then sees large decode
batches even when every client sends one system image, and a decode step's
cost is spread over the batch's rows. Batch execution is delegated to a
caller-provided ``run_batch(items) -> results`` (in production the port's
``inference.batch_inference``).

Threading model: ONE scheduler thread owns the card, so every kernel of a
batch launches from that thread, on its current CUDA stream; request
threads block on per-request events. ``submit`` is lock-protected and O(1).
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np

_STATS_WINDOW = 4096  # most recent samples kept per series


def _accepts_emit(fn) -> bool:
    """True iff ``fn`` has a parameter named ``emit`` (DynamicBatcher's
    streaming opt-in)."""
    try:
        return "emit" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@dataclasses.dataclass
class BatcherStats:
    """Rolling service statistics (all times seconds). The series are
    bounded deques, so a long-lived worker's stats do not grow with its
    request count."""
    completed: int = 0
    failed: int = 0
    batches: int = 0
    batch_sizes: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_STATS_WINDOW))
    queue_wait: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_STATS_WINDOW))
    service_time: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_STATS_WINDOW))

    def summary(self) -> dict:
        def pct(xs, q):
            return float(np.percentile(list(xs), q)) if xs else 0.0
        return {
            "completed": self.completed,
            "failed": self.failed,
            "batches": self.batches,
            "mean_batch": (sum(self.batch_sizes) / len(self.batch_sizes)
                           if self.batch_sizes else 0.0),
            "p50_wait_s": pct(self.queue_wait, 50),
            "p99_wait_s": pct(self.queue_wait, 99),
            "p50_service_s": pct(self.service_time, 50),
            "p99_service_s": pct(self.service_time, 99),
        }


class _Request:
    __slots__ = ("item", "event", "result", "error", "t_submit", "t_done",
                 "progress_queue")

    def __init__(self, item, progress_queue=None):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_submit = time.perf_counter()
        self.t_done = None
        # optional caller-owned queue.Queue: the scheduler thread puts
        # (request, payload) mid-decode progress events here (SSE STEP
        # streaming under dynamic batching, serving/routes.py)
        self.progress_queue = progress_queue


class DynamicBatcher:
    """Cross-request batch formation in front of a batched model call.

    Parameters
    ----------
    run_batch:
        ``run_batch(items: list) -> list``: results positionally aligned
        with ``items``. Runs on the scheduler thread only. A ``run_batch``
        with a parameter named ``emit`` is called ``run_batch(items, emit)``,
        and ``emit(idx, payload)`` routes mid-decode progress to the
        submitting request's progress queue.
    max_batch:
        flush as soon as this many requests are pending.
    max_wait_ms:
        flush a non-empty, non-full queue this long after its OLDEST
        request arrived (tail-latency bound for low-traffic periods).
    """

    def __init__(self, run_batch: Callable[[list], Sequence[Any]],
                 max_batch: int = 32, max_wait_ms: float = 25.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        # detected by name, not arity: an unrelated second parameter
        # (run_batch(items, retries=3)) must not receive the callback
        self._emits = _accepts_emit(run_batch)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque[_Request] = collections.deque()
        self._closed = False
        self.stats = BatcherStats()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="omr-dynamic-batcher")
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, item, progress_queue=None) -> _Request:
        """Enqueue one request; returns a handle (see :meth:`result`).

        ``progress_queue``: optional ``queue.Queue`` that receives
        ``(request, payload)`` mid-decode progress events (when the
        batcher's ``run_batch`` supports the emit protocol)."""
        req = _Request(item, progress_queue)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(req)
            self._cv.notify()
        return req

    def result(self, req: _Request, timeout: float | None = None):
        """Block for one request's result (re-raises batch errors)."""
        if not req.event.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if req.error is not None:
            raise req.error
        return req.result

    def __call__(self, item, timeout: float | None = None):
        """Synchronous convenience: submit + wait."""
        return self.result(self.submit(item), timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue and stop the scheduler thread."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout)

    # -- scheduler thread ---------------------------------------------------

    def _pop_batch(self) -> list[_Request]:
        return [self._queue.popleft()
                for _ in range(min(len(self._queue), self.max_batch))]

    def _take_batch(self) -> list[_Request] | None:
        """Block until a batch is due (full, aged out, or closing)."""
        with self._cv:
            while True:
                if self._queue:
                    if len(self._queue) >= self.max_batch or self._closed:
                        return self._pop_batch()
                    oldest = self._queue[0].t_submit
                    due_in = oldest + self.max_wait - time.perf_counter()
                    if due_in <= 0:
                        return self._pop_batch()
                    self._cv.wait(timeout=due_in)
                elif self._closed:
                    return None
                else:
                    self._cv.wait()

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            t0 = time.perf_counter()
            try:
                if self._emits:
                    def _emit(idx, payload, batch=batch):
                        q = batch[idx].progress_queue
                        if q is not None:
                            q.put((batch[idx], payload))
                    results = self._run_batch([r.item for r in batch], _emit)
                else:
                    results = self._run_batch([r.item for r in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(batch)} items")
                for r, res in zip(batch, results):
                    r.result = res
            except Exception as e:  # noqa: BLE001 (resolve every waiter)
                for r in batch:
                    r.error = e
            t1 = time.perf_counter()
            self.stats.batches += 1
            self.stats.batch_sizes.append(len(batch))
            for r in batch:
                r.t_done = t1
                if r.error is None:
                    self.stats.completed += 1
                else:
                    self.stats.failed += 1
                self.stats.queue_wait.append(t0 - r.t_submit)
                self.stats.service_time.append(t1 - r.t_submit)
                r.event.set()


def omr_batcher(model, *, max_batch: int = 32, max_wait_ms: float = 25.0,
                **transcribe_kwargs) -> DynamicBatcher:
    """A DynamicBatcher over ``api.OmrModel.transcribe_batch``.

    Each submitted item is one image (path / PIL / array, as
    ``OmrModel.transcribe`` accepts); results are ``Transcription``s.
    """
    def run(items):
        return model.transcribe_batch(items, **transcribe_kwargs)
    return DynamicBatcher(run, max_batch=max_batch, max_wait_ms=max_wait_ms)
