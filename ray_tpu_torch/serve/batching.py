"""@serve.batch: transparent request batching inside a replica.

Port of ray_tpu/serve/batching.py: concurrent calls to a decorated method
are queued and executed as one underlying call on a list, results fanned
back out. Thread-based: replicas run requests on a thread pool
(max_concurrency), so concurrent callers park on futures while one batcher
thread drains the queue; items whose deadline passed while queued are
dropped before the batch runs, and each traced item gets its own
``serve.batch_item`` span under its own request's trace. Out: the
batcher's expiry counter (the serve metrics, ROADMAP Queue A item (iv)).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from functools import wraps
from typing import Any, Callable

from ray_tpu_torch.serve.resilience import (
    DeadlineExceeded,
    current_deadline,
    expired,
)
from ray_tpu_torch.util import tracing


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def submit(self, instance: Any, item: Any) -> Future:
        # The request's deadline rides along (thread-local, stamped by the
        # replica before the user method ran): the batch loop sheds items
        # that expire while queued instead of spending a batch slot on
        # them. The trace context is captured HERE too — batching fans
        # many requests into ONE execution, so each item's batch span must
        # parent to its own request's trace, not to whichever request
        # happened to trigger the batch (captured per-item while the
        # caller's thread-local context is still live).
        fut: Future = Future()
        ctx = tracing.inject() if tracing.current_context() else None
        self.q.put((instance, item, fut, current_deadline(), ctx,
                    time.time()))
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
        return fut

    @staticmethod
    def _drop_expired(batch: list) -> list:
        """Fail expired entries (DeadlineExceeded) and return the live
        rest — run just before the batch executes, where queue wait has
        already been paid and compute is about to be."""
        live = []
        for entry in batch:
            if expired(entry[3]):
                entry[2].set_exception(DeadlineExceeded(
                    "request expired while queued for a batch"))
            else:
                live.append(entry)
        return live

    def _loop(self) -> None:
        while True:
            try:
                first = self.q.get(timeout=5.0)
            except queue.Empty:
                return  # idle; a new submit restarts the thread
            batch = [first]
            deadline = self.timeout
            while len(batch) < self.max_batch_size:
                try:
                    batch.append(self.q.get(timeout=deadline))
                except queue.Empty:
                    break
            batch = self._drop_expired(batch)
            if not batch:
                continue
            instance = batch[0][0]
            items = [b[1] for b in batch]
            futs = [b[2] for b in batch]
            status = "OK"
            try:
                results = (self.fn(instance, items) if instance is not None
                           else self.fn(items))
                if len(results) != len(items):
                    raise RuntimeError(
                        f"@serve.batch function returned {len(results)} results "
                        f"for a batch of {len(items)}")
                for f, r in zip(futs, results):
                    f.set_result(r)
            except BaseException as e:  # noqa: BLE001
                status = f"ERROR: {type(e).__name__}"
                for f in futs:
                    if not f.done():
                        f.set_exception(e)
            # One batch execution, many requests: each item with a
            # propagated context gets its own span (queue wait + execute)
            # parented under ITS request's trace — the batch loop thread
            # never entered any of them, so the context rides explicitly.
            end = time.time()
            for entry in batch:
                if entry[4] is not None:
                    tracing.record_span(
                        "serve.batch_item", entry[5], end,
                        attributes={"batch_size": len(items),
                                    "status": status},
                        ctx=entry[4])


def batch(_fn: Callable | None = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: ``@serve.batch`` on a method taking a list of inputs."""

    def deco(fn: Callable):
        # Queues hold locks/threads, so they are created lazily per replica
        # instance (keeps the decorated class picklable for shipping to the
        # replica actor) and batching state is per-replica, as in the
        # reference.
        # Lazy queue creation keeps the decorated class picklable (queues
        # hold locks/threads) and makes batching state per-replica. No lock:
        # dict.setdefault is atomic under the GIL, so a racing duplicate
        # queue is simply discarded in favor of the winner.
        attr = f"_serve_batch_queue_{fn.__name__}"
        unbound_holder: dict = {}

        @wraps(fn)
        def wrapper(*args):
            if len(args) == 2:  # bound method: (self, item)
                instance, item = args
                holder = instance.__dict__
            else:
                instance, item = None, args[0]
                holder = unbound_holder
            bq = holder.get(attr)
            if bq is None:
                bq = holder.setdefault(
                    attr, _BatchQueue(fn, max_batch_size,
                                      batch_wait_timeout_s))
            return bq.submit(instance, item).result()

        wrapper._is_serve_batch = True
        return wrapper

    return deco(_fn) if _fn is not None else deco
