"""Batch iteration + streaming_split (reference capability:
python/ray/data/_internal/iterator/stream_split_iterator.py:30 — a shared
coordinator actor runs the streaming executor once; n consumers pull their
round-robined shards; ray_tpu.train workers use this for per-host ingest).

Port of ray_tpu/data/iterator.py on the in-process runtime. The
coordinator's producer thread carries the runtime's thread prefix (its
shutdown joins it) and stops on ``close()``, which the trainer calls at
the end of each run: the executor's pools are then shut down. Input-wait
time is counted on the DataIterator (``input_wait_s``), where ray_tpu
stamps it on its goodput ledger. ``device_prefetch`` is the counterpart
of ray_tpu's ``device_put`` pipeline: pinned host copies, ``non_blocking``
copies on a side stream and an event the consumer's stream waits on.
``batches_from_blocks`` re-batches blocks held in memory.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Iterator

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.executor import HeldBlock, get_block

_split_metrics_cache: dict | None = None


def _split_metrics() -> dict:
    """Lazy federated counters for streaming_split backpressure — created
    once per process (re-instantiating a same-named Counter would re-register
    and orphan the prior series)."""
    global _split_metrics_cache
    if _split_metrics_cache is None:
        from ray_tpu_torch.util.metrics import Counter

        _split_metrics_cache = {
            "stall": Counter(
                "data_split_stall",
                "streaming_split producer stalls on a full per-split queue",
                ("split",)),
            "empty": Counter(
                "data_split_empty_poll",
                "streaming_split consumer polls that found an empty queue",
                ("split",)),
        }
    return _split_metrics_cache


def batches_from_blocks(
    blocks,
    *,
    batch_size: int | None,
    drop_last: bool = False,
    shuffle_buffer_size: int | None = None,
    shuffle_seed: int | None = None,
) -> Iterator[Block]:
    """``batches_from_refs`` over blocks held in memory (numpy batches)."""
    yield from batches_from_refs(
        ((HeldBlock(b), {}) for b in blocks), None, batch_size=batch_size,
        drop_last=drop_last, shuffle_buffer_size=shuffle_buffer_size,
        shuffle_seed=shuffle_seed)


def batches_from_refs(
    refs_iter: Iterator[tuple[Any, dict]],
    api,
    *,
    batch_size: int | None,
    batch_format: str = "numpy",
    drop_last: bool = False,
    shuffle_buffer_size: int | None = None,
    shuffle_seed: int | None = None,
) -> Iterator[Any]:
    """Re-batch a stream of block refs into fixed-size batches."""
    carry: list[Block] = []
    carry_rows = 0
    rng = np.random.default_rng(shuffle_seed)

    def emit(block: Block):
        if shuffle_buffer_size and BlockAccessor(block).num_rows() > 1:
            order = rng.permutation(BlockAccessor(block).num_rows())
            block = BlockAccessor(block).take_rows(order)
        return BlockAccessor(block).to_batch(batch_format)

    for ref, _meta in refs_iter:
        block = get_block(ref, api)
        n = BlockAccessor(block).num_rows()
        if n == 0:
            continue
        if batch_size is None:
            yield emit(block)
            continue
        carry.append(block)
        carry_rows += n
        while carry_rows >= batch_size:
            merged = concat_blocks(carry)
            acc = BlockAccessor(merged)
            yield emit(acc.slice(0, batch_size))
            rest = acc.slice(batch_size, acc.num_rows())
            carry = [rest] if BlockAccessor(rest).num_rows() else []
            carry_rows = BlockAccessor(rest).num_rows() if carry else 0
    if carry_rows and batch_size is not None and not drop_last:
        yield emit(concat_blocks(carry))


class SplitCoordinator:
    """Actor: runs the dataset's executor once, round-robins output blocks
    into n bounded per-split queues. Consumers poll get_next(i).

    The per-split queue bound (``data_split_prefetch_blocks``) is the
    ingest-side backpressure: a slow consumer stalls the producer thread
    (and through it the whole streaming executor's launch budget) instead
    of buffering the dataset unboundedly. Stalls are counted in the
    federated ``data_split_stall`` metric; consumer-side empty polls in
    ``data_split_empty_poll`` — together they say whether an ingest phase
    is producer-bound or consumer-bound."""

    MAX_QUEUED_PER_SPLIT = 8  # fallback when config is unavailable

    def __init__(self, dataset, n: int, equal: bool):
        self._n = n
        self._equal = equal
        self._queues = [collections.deque() for _ in range(n)]
        self._lock = threading.Lock()
        self._done = False
        self._error: str | None = None
        self._epoch_datasets = dataset
        self._closed = False
        self.stalls = 0       # producer waits on a full split queue
        self.empty_polls = 0  # consumer polls that found nothing queued
        try:
            from ray_tpu_torch.utils.config import get_config

            self._prefetch = max(1, int(get_config().data_split_prefetch_blocks))
        except Exception:
            self._prefetch = self.MAX_QUEUED_PER_SPLIT
        try:
            self._metrics = _split_metrics()
        except Exception:
            self._metrics = None
        from ray_tpu_torch.core.worker import global_worker

        self._rt = global_worker.runtime
        self._thread = threading.Thread(
            target=self._run, args=(dataset,), daemon=True,
            name=self._rt._thread_prefix + "split-producer",
        )
        self._thread.start()

    def _stopping(self) -> bool:
        return self._closed or self._rt._shutdown

    def _run(self, dataset) -> None:
        blocks = dataset.iter_block_refs()
        try:
            i = 0
            for ref, meta in blocks:
                # backpressure: wait while the target queue is full
                stalled = False
                while True:
                    if self._stopping():
                        return
                    with self._lock:
                        if len(self._queues[i % self._n]) < self._prefetch:
                            self._queues[i % self._n].append((ref, meta))
                            break
                    if not stalled:
                        stalled = True
                        self.stalls += 1
                        if self._metrics is not None:
                            self._metrics["stall"].inc(
                                tags={"split": str(i % self._n)})
                    time.sleep(0.01)
                i += 1
        except Exception as e:  # surfaced to all consumers
            with self._lock:
                self._error = f"{type(e).__name__}: {e}"
        finally:
            self._done = True
            close = getattr(blocks, "close", None)
            if close is not None:  # the executor shuts its pools down
                close()

    def get_next(self, split: int):
        """(status, payload): status in {"block", "empty", "done", "error"}."""
        if self._error:
            return ("error", self._error)
        with self._lock:
            if self._queues[split]:
                ref, meta = self._queues[split].popleft()
                return ("block", ref)
        if self._done:
            with self._lock:
                if self._queues[split]:
                    ref, meta = self._queues[split].popleft()
                    return ("block", ref)
            return ("done", None)
        self.empty_polls += 1
        if self._metrics is not None:
            self._metrics["empty"].inc(tags={"split": str(split)})
        return ("empty", None)

    def ping(self) -> bool:
        return True

    def close(self) -> bool:
        """Stop the producer (the executor's pools are shut down) and wait
        for it to end."""
        self._closed = True
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=150)
        with self._lock:
            for q in self._queues:
                q.clear()
        return not self._thread.is_alive()


class DataIterator:
    """Per-consumer handle over a SplitCoordinator split (reference
    capability: ray.data.DataIterator)."""

    def __init__(self, coordinator, split: int):
        self._coord = coordinator
        self._split = split
        # Input-stall accounting: the time between asking the coordinator
        # for a block and having one in hand (polls + empty sleeps) is
        # dataset wait, not consumer compute.
        self.input_wait_s = 0.0

    def iter_block_refs(self) -> Iterator[tuple[Any, dict]]:
        import ray_tpu_torch

        while True:
            t0 = time.perf_counter()
            status, payload = ray_tpu_torch.get(
                self._coord.get_next.remote(self._split)
            )
            if status == "block":
                self.input_wait_s += time.perf_counter() - t0
                yield payload, {}
            elif status == "done":
                return
            elif status == "error":
                raise RuntimeError(f"streaming_split producer failed: {payload}")
            else:
                time.sleep(0.01)
                self.input_wait_s += time.perf_counter() - t0

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        import ray_tpu_torch

        yield from batches_from_refs(
            self.iter_block_refs(), ray_tpu_torch,
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
        )

    def iter_torch_batches(self, *, batch_size: int | None = 256,
                           dtypes=None, device="cpu",
                           drop_last: bool = False,
                           prefetch: int = 0) -> Iterator[Any]:
        """Batches as dicts of torch tensors on ``device``; ``prefetch`` > 0
        copies that many batches ahead through ``device_prefetch``."""
        yield from torch_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            dtypes=dtypes, device=device, prefetch=prefetch)

    def iter_rows(self) -> Iterator[dict]:
        import ray_tpu_torch

        for ref, _ in self.iter_block_refs():
            yield from BlockAccessor(get_block(ref, ray_tpu_torch)).iter_rows()

    def close(self) -> None:
        """Stop the split's producer (every split of it)."""
        import ray_tpu_torch

        ray_tpu_torch.get(self._coord.close.remote(), timeout=180)


def make_streaming_split(dataset, n: int, *, equal: bool = False):
    import ray_tpu_torch

    coord_cls = ray_tpu_torch.remote(num_cpus=0)(SplitCoordinator)
    coord = coord_cls.remote(dataset, n, equal)
    ray_tpu_torch.get(coord.ping.remote())  # ensure started
    return [DataIterator(coord, i) for i in range(n)]


def torch_batches(batches, *, dtypes=None, device="cpu",
                  prefetch: int = 0) -> Iterator[dict]:
    """numpy batches as dicts of torch tensors (ray_tpu's
    ``iter_torch_batches`` conversion), through ``device_prefetch`` when
    ``prefetch`` > 0."""
    import torch

    if prefetch > 0:
        yield from device_prefetch(batches, device=device, depth=prefetch,
                                   dtypes=dtypes)
        return
    for batch in batches:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            dt = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
            if dt is not None:
                t = t.to(dt)
            out[k] = t.to(device) if str(device) != "cpu" else t
        yield out


def device_prefetch(batches, *, device="cuda", depth: int = 2,
                    dtypes=None):
    """Pipeline host→device transfer: a background thread copies up to
    ``depth`` batches ahead while the consumer computes on the current one
    (ray_tpu's ``device_put`` pipeline on the card).

    Each numeric column goes into a pinned host tensor, then a
    ``non_blocking`` copy on a side stream (``dtypes`` converts there too);
    an event recorded after the copies is waited on by the consumer's
    current stream before the batch is handed over, and each tensor is
    marked as used by that stream. Columns torch cannot hold (strings)
    stay numpy. On a CPU device the batches are converted in the thread.
    An early break or an error stops the producer and drops the queued
    batches (ray_tpu's release)."""
    import queue as _q
    import threading

    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:  # the caller's current card
        dev = torch.device("cuda", torch.cuda.current_device())
    q: "_q.Queue" = _q.Queue(maxsize=max(1, depth))
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded put that notices consumer abandonment — a plain q.put on
        # a full queue would block this thread forever and pin `depth`
        # device-resident batches (plus the upstream pipeline).
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _q.Full:
                continue
        return False

    def convert(batch, stream):
        out = {}
        for k, v in batch.items():
            arr = np.asarray(v)
            if arr.dtype.kind not in "biuf":
                out[k] = arr
                continue
            t = torch.from_numpy(np.ascontiguousarray(arr))
            dt = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
            if on_card:
                with torch.cuda.stream(stream):
                    t = t.pin_memory().to(dev, non_blocking=True)
                    if dt is not None:
                        t = t.to(dt)
            elif dt is not None:
                t = t.to(dt)
            out[k] = t
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def produce():
        stream = None
        try:
            if on_card:
                torch.cuda.set_device(dev)
                stream = torch.cuda.Stream(dev)
            for batch in batches:
                if stop.is_set():
                    return
                if not _put(convert(batch, stream)):
                    return
        except BaseException as e:  # noqa: BLE001 - surface in consumer
            _put(e)
            return
        _put(_END)

    t = threading.Thread(target=produce, daemon=True,
                         name="data-device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            out, event = item
            if event is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(event)
                for v in out.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(cur)
            yield out
    finally:
        stop.set()  # early break / error: release the producer + buffers
        while not q.empty():
            try:
                q.get_nowait()
            except _q.Empty:
                break
        t.join(timeout=5)
