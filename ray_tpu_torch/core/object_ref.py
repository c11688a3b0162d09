"""ObjectRef: a first-class distributed future.

Port of ray_tpu/core/object_ref.py for the in-process runtime (out: the
client proxy's ``refcount_disabled``): a ref names an object owned by
exactly one worker; refs are cheap to copy and pickle; every live ref holds
one local reference in the runtime's reference counter, so an object is
freed when its last ref goes. ``ObjectRefGenerator`` iterates the yields of
a streaming task (``num_returns="streaming"``). Added: a generator dropped
before its stream ends tells the runtime, which stops driving the producer
(it is closed at its next yield) and frees the items nobody will read; and
a generator waiting for its next item raises ObjectLostError once the
runtime shuts down.
"""

from __future__ import annotations

import time
from typing import Any

from ray_tpu_torch.utils.ids import ObjectID, WorkerID

# Lazily-bound process worker (worker.py imports this module, so bind on
# first use).
_worker_singleton = None


def _current_runtime():
    global _worker_singleton
    if _worker_singleton is None:
        from ray_tpu_torch.core.worker import global_worker

        _worker_singleton = global_worker
    return _worker_singleton.runtime


class ObjectRef:
    __slots__ = ("id", "owner_id", "_counted")

    def __init__(self, object_id: ObjectID, owner_id: WorkerID | None = None):
        self.id = object_id
        self.owner_id = owner_id
        self._counted = False
        # Every live ObjectRef instance holds one local ref; released in
        # __del__ (reference: _raylet ObjectRef dealloc).
        rt = _current_runtime()
        if rt is not None:
            rt.refs.add_local_ref(object_id)
            self._counted = True

    @classmethod
    def counted(cls, object_id: ObjectID,
                owner_id: WorkerID | None) -> "ObjectRef":
        """Construct a ref whose local count was ALREADY taken (fused into
        the owner registration). __del__ still releases."""
        ref = cls.__new__(cls)
        ref.id = object_id
        ref.owner_id = owner_id
        ref._counted = True
        return ref

    def __del__(self):
        if not self._counted:
            return
        try:
            rt = _current_runtime()
            if rt is not None:
                rt.refs.remove_local_ref(self.id)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    # -- future-like sugar -------------------------------------------------
    def get(self, timeout: float | None = None) -> Any:
        import ray_tpu_torch

        return ray_tpu_torch.get(self, timeout=timeout)

    def wait(self, timeout: float | None = None) -> bool:
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait([self], num_returns=1, timeout=timeout)
        return bool(ready)

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        return f"ObjectRef({self.id.hex()[:16]})"

    def __reduce__(self):
        return (ObjectRef, (self.id, self.owner_id))


# Stream-end sentinel index: the item count of a finished streaming task is
# stored under this return index (far above any real item index).
STREAM_END_INDEX = 0xFFFFFFFE


class ObjectRefGenerator:
    """Iterator over the yields of a streaming task
    (``num_returns="streaming"``): each ``__next__`` blocks until the next
    yielded item is in the store and returns its ObjectRef. The stream ends
    when the executor stores the item count (or the producer's error) under
    STREAM_END_INDEX."""

    def __init__(self, task_id, owner_id: WorkerID, end_ref=None):
        self._task_id = task_id
        self._owner_id = owner_id
        self._index = 0
        self._total: int | None = None
        # Pins the stream-end marker for the generator's lifetime: it is
        # the task's only pre-declared return.
        self._end_ref = end_ref
        self._rt = _current_runtime()

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self._next(timeout=300.0)

    def _next(self, timeout: float) -> ObjectRef:
        rt = self._rt
        contains = rt.store.contains
        oid = ObjectID.for_task_return(self._task_id, self._index)
        end_oid = ObjectID.for_task_return(self._task_id, STREAM_END_INDEX)
        deadline = time.monotonic() + timeout
        while True:
            if self._total is not None and self._index >= self._total:
                raise StopIteration
            if contains(oid):
                self._index += 1
                return ObjectRef(oid, self._owner_id)
            if self._total is None and contains(end_oid):
                end = rt.get([ObjectRef(end_oid, self._owner_id)])[0]
                self._total = int(end)
                continue
            if rt._shutdown:
                from ray_tpu_torch.core.exceptions import ObjectLostError

                raise ObjectLostError(oid.hex(), "the runtime shut down")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"streaming task {self._task_id.hex()[:12]} produced no "
                    f"item {self._index} in time")
            # Plain polling: building ObjectRefs to use wait() would take
            # and drop local refs on ids the producer has not sealed yet.
            with rt._wait_cond:
                rt._wait_cond.wait(timeout=0.02)

    def completed(self) -> bool:
        return self._total is not None and self._index >= self._total

    def __del__(self):
        try:
            self._rt.close_stream(self._task_id, self._index)
        except Exception:  # noqa: BLE001 - runtime gone or interpreter teardown
            pass
