"""Cross-request micro-batching in front of the port's predictors.

Counterpart of ``vltk_tpu/serving.py`` (the port's own copy: it imports
nothing of the JAX package). The predictors (``predict.py``) pad every
call to their static ``batch_size`` bucket, so a single request pays for
the whole bucket. ``MicroBatchServer`` coalesces concurrent single
requests: worker threads drain a queue into buckets, make one batched call
and hand each caller its own result. Throughput approaches the batched
number while a request waits at most ``max_delay_ms`` for its bucket to
fill.

Semantics, as the JAX package's: results go back in request order within a
bucket; a failing batch is retried request by request so only the
poisoned request fails; a result count that does not match the bucket
fails the whole bucket; ``close`` serves every pending request before the
workers stop and refuses new ones; a batch slower than
``slow_batch_warn_s`` warns; ``workers > 1`` overlaps one bucket's host
work with another's step (the predictors are safe to call from several
threads: their one mutation, the lazy int8 calibration, is locked).

``for_vqa`` / ``for_doc`` / ``for_span`` put a server in front of
``VQAPredictor``, ``DocTokenClassifier`` and ``DocSpanQA``.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence, Tuple


class MicroBatchServer:
    """Coalesce concurrent single requests into batched calls.

    Args:
      batch_fn: ``List[request] -> List[result]``, same length and order.
      batch_size: most requests a call gets: the predictor's bucket.
      max_delay_ms: how long a worker waits, after a bucket's first
        request, for more before it runs a partial bucket.
      workers: worker threads (each runs whole buckets).
      slow_batch_warn_s: a batch slower than this warns (0: never).

    ``submit`` returns a ``concurrent.futures.Future``; calling the server
    blocks for the result. Use it as a context manager or call ``close``.
    """

    def __init__(
        self,
        batch_fn: Callable[[List[Any]], Sequence[Any]],
        batch_size: int,
        max_delay_ms: float = 5.0,
        workers: int = 1,
        slow_batch_warn_s: float = 30.0,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._batch_fn = batch_fn
        self._batch_size = int(batch_size)
        self._max_delay = max(float(max_delay_ms), 0.0) / 1e3
        self._slow_batch_warn = max(float(slow_batch_warn_s), 0.0)
        self._slowest_batch = 0.0
        self._queue: "queue.Queue[Optional[Tuple[Any, Future, float]]]" = queue.Queue()
        self._batches_run = 0
        self._requests_served = 0
        # submit -> result latencies, a bounded ring
        self._latencies: List[float] = []
        self._lat_cap = 4096
        self._stats_lock = threading.Lock()
        self._closed = False
        # orders every submit's enqueue against close()'s sentinels, so no
        # request lands behind a sentinel and strands its caller
        self._submit_lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._run, daemon=True, name=f"vltk-serve-{i}")
            for i in range(int(workers))
        ]
        for t in self._workers:
            t.start()

    def submit(self, request: Any) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put((request, fut, time.monotonic()))
        return fut

    def __call__(self, request: Any) -> Any:
        return self.submit(request).result()

    def close(self, timeout: Optional[float] = None) -> None:
        """Serve every pending request, then stop the workers. Raises
        ``TimeoutError`` when a worker is still running after ``timeout``
        seconds (None: wait as long as it takes)."""
        with self._submit_lock:
            if not self._closed:
                self._closed = True
                for _ in self._workers:
                    self._queue.put(None)  # drain, then exit
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._workers:
            t.join(None if deadline is None else max(deadline - time.monotonic(), 0.0))
        alive = [t.name for t in self._workers if t.is_alive()]
        if alive:
            raise TimeoutError(f"MicroBatchServer workers still running after {timeout} s: {alive}")

    def __enter__(self) -> "MicroBatchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def stats(self) -> dict:
        """Batches run, requests served, the slowest batch and the latency
        percentiles (p50, p95, p99, max) in ms."""
        with self._stats_lock:
            out = {
                "batches_run": self._batches_run,
                "requests_served": self._requests_served,
                "slowest_batch_ms": round(self._slowest_batch * 1e3, 3),
            }
            lats = sorted(self._latencies)
        if lats:
            def pick(q):
                return lats[min(int(q * len(lats)), len(lats) - 1)]

            out["latency_ms"] = {
                "p50": round(pick(0.50) * 1e3, 3),
                "p95": round(pick(0.95) * 1e3, 3),
                "p99": round(pick(0.99) * 1e3, 3),
                "max": round(lats[-1] * 1e3, 3),
            }
        return out

    def _run(self) -> None:
        while True:
            head = self._queue.get()
            if head is None:
                return
            bucket = [head]
            # wait up to max_delay for the bucket to fill; past the
            # deadline, still take what is already queued
            deadline = time.monotonic() + self._max_delay
            while len(bucket) < self._batch_size:
                remaining = deadline - time.monotonic()
                try:
                    item = self._queue.get(timeout=remaining) if remaining > 0 else self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    self._serve(bucket)
                    return
                bucket.append(item)
            self._serve(bucket)

    def _serve(self, bucket: List[Tuple[Any, Future, float]]) -> None:
        # claim each future; one its caller cancelled is dropped here
        bucket = [item for item in bucket if item[1].set_running_or_notify_cancel()]
        if not bucket:
            return
        requests = [r for r, _, _ in bucket]
        t0 = time.monotonic()
        try:
            results = list(self._batch_fn(requests))
        except BaseException as exc:  # handed to the callers, never lost
            if len(bucket) == 1:
                bucket[0][1].set_exception(exc)
                return
            # one poisoned request must not fail its peers: retry each alone
            for req, fut, t_req in bucket:
                try:
                    solo = list(self._batch_fn([req]))
                except BaseException as solo_exc:
                    fut.set_exception(solo_exc)
                else:
                    if len(solo) == 1:
                        self._finish(fut, t_req, solo[0])
                    else:
                        fut.set_exception(RuntimeError(f"batch_fn returned {len(solo)} results for 1 request"))
            return
        if len(results) != len(requests):
            # a contract fault of batch_fn, not a poisoned request
            exc = RuntimeError(f"batch_fn returned {len(results)} results for {len(requests)} requests")
            for _, fut, _ in bucket:
                fut.set_exception(exc)
            return
        dur = time.monotonic() - t0
        for (_, fut, t_req), res in zip(bucket, results):
            self._finish(fut, t_req, res)
        with self._stats_lock:
            self._batches_run += 1
            self._slowest_batch = max(self._slowest_batch, dur)
        if self._slow_batch_warn and dur > self._slow_batch_warn:
            warnings.warn(
                f"MicroBatchServer: one batch of {len(bucket)} took {dur:.1f}s "
                f"(threshold {self._slow_batch_warn:.0f}s); every queued caller waited behind it",
                stacklevel=2,
            )

    def _finish(self, fut: Future, t0: float, res: Any) -> None:
        with self._stats_lock:
            self._requests_served += 1
            if len(self._latencies) >= self._lat_cap:
                del self._latencies[: self._lat_cap // 2]
            self._latencies.append(time.monotonic() - t0)
        fut.set_result(res)


def for_vqa(predictor, max_delay_ms: float = 5.0, top_k: int = 5, workers: int = 1) -> MicroBatchServer:
    """Serve a ``VQAPredictor``: request = (image, question) -> result dict."""
    return MicroBatchServer(
        lambda reqs: predictor([r[0] for r in reqs], [r[1] for r in reqs], top_k=top_k),
        batch_size=predictor.batch_size, max_delay_ms=max_delay_ms, workers=workers,
    )


def for_doc(classifier, max_delay_ms: float = 5.0, workers: int = 1) -> MicroBatchServer:
    """Serve a ``DocTokenClassifier``: request = document dict -> word labels."""
    return MicroBatchServer(
        lambda reqs: classifier(list(reqs)),
        batch_size=classifier.batch_size, max_delay_ms=max_delay_ms, workers=workers,
    )


def for_span(span_qa, max_delay_ms: float = 5.0, workers: int = 1) -> MicroBatchServer:
    """Serve a ``DocSpanQA``: request = (document, question) -> span dict."""
    return MicroBatchServer(
        lambda reqs: span_qa([r[0] for r in reqs], [r[1] for r in reqs]),
        batch_size=span_qa.batch_size, max_delay_ms=max_delay_ms, workers=workers,
    )
