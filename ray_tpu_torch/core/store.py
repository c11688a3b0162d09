"""In-memory object store with capacity accounting, LRU spill, and
reference counting.

Capability parity with the reference's plasma store + reference counter
(reference: src/ray/object_manager/plasma/store.h, eviction_policy.cc;
src/ray/core_worker/reference_counter.h): objects are immutable byte buffers
created once and sealed; the store enforces a memory cap by spilling cold
objects to disk (reference threshold semantics: ray_config_def.h:694 spill
at 0.8 capacity); an object is freed once no ref to it and no pending task
that takes it remain.

Port of ray_tpu/core/store.py. The store holds serialized bytes in host
memory; a tensor is pickled through host memory on its way in
(utils/serialization.py). ``close`` (the runtime's shutdown) wakes every
``get`` still waiting, which then raises ObjectLostError.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from ray_tpu_torch.core.exceptions import ObjectLostError
from ray_tpu_torch.utils.config import get_config
from ray_tpu_torch.utils.ids import ObjectID, WorkerID


@dataclass
class ObjectEntry:
    data: bytes | None  # None => spilled
    size: int
    owner_id: WorkerID
    spilled_path: str | None = None


class LocalObjectStore:
    """Per-node immutable object arena with LRU spill-to-disk."""

    def __init__(self, capacity_bytes: int | None = None, spill_dir: str | None = None):
        cfg = get_config()
        self._capacity = capacity_bytes or cfg.object_store_memory_bytes
        self._spill_threshold = cfg.object_spilling_threshold
        self._spill_dir = spill_dir or os.path.join(cfg.temp_dir, "spill")
        self._objects: OrderedDict[ObjectID, ObjectEntry] = OrderedDict()
        self._used = 0
        self._lock = threading.RLock()
        self._seal_events: dict[ObjectID, threading.Event] = {}
        # Optional runtime hook fired after every seal — wakes event-driven
        # wait()/get() paths without polling.
        self.on_seal = None

    # -- create/seal -------------------------------------------------------
    def put(self, object_id: ObjectID, data: bytes, owner_id: WorkerID) -> None:
        with self._lock:
            if object_id in self._objects:
                return  # idempotent (reconstruction may race)
            entry = ObjectEntry(data=data, size=len(data), owner_id=owner_id)
            self._objects[object_id] = entry
            self._used += entry.size
            self._maybe_spill_locked()
            ev = self._seal_events.pop(object_id, None)
        if ev is not None:
            ev.set()
        if self.on_seal is not None:
            self.on_seal()

    # -- read --------------------------------------------------------------
    def get(self, object_id: ObjectID, timeout: float | None = None) -> bytes:
        ev = None
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is None:
                ev = self._seal_events.setdefault(object_id, threading.Event())
        if ev is not None:
            if not ev.wait(timeout):
                raise TimeoutError(f"object {object_id.hex()[:12]} not sealed in time")
            with self._lock:
                entry = self._objects.get(object_id)
        if entry is None:
            raise ObjectLostError(object_id.hex())
        with self._lock:
            self._objects.move_to_end(object_id)  # LRU touch
            if entry.data is not None:
                return entry.data
            return self._restore_locked(object_id, entry)

    def stats(self) -> dict:
        """Occupancy, as ray_tpu's store reports it (profiling/memory.py)."""
        with self._lock:
            spilled = sum(1 for e in self._objects.values() if e.data is None)
            return {
                "num_objects": len(self._objects),
                "num_spilled": spilled,
                "used_bytes": self._used,
                "capacity_bytes": self._capacity,
            }

    def close(self) -> None:
        """Wake every waiting ``get``: its object will never be sealed."""
        with self._lock:
            events, self._seal_events = list(self._seal_events.values()), {}
        for ev in events:
            ev.set()

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def delete(self, object_id: ObjectID) -> bool:
        """Remove the entry; returns whether it was present (callers skip
        shm-arena cleanup for objects this process store held — the two
        stores are exclusive destinations)."""
        with self._lock:
            entry = self._objects.pop(object_id, None)
            if entry is None:
                return False
            if entry.data is not None:
                self._used -= entry.size
            if entry.spilled_path:
                try:
                    os.unlink(entry.spilled_path)
                except OSError:
                    pass
            return True

    def _maybe_spill_locked(self) -> None:
        limit = self._capacity * self._spill_threshold
        if self._used <= limit:
            return
        os.makedirs(self._spill_dir, exist_ok=True)
        for oid in list(self._objects.keys()):
            if self._used <= limit:
                break
            entry = self._objects[oid]
            if entry.data is None:
                continue
            path = os.path.join(self._spill_dir, oid.hex())
            with open(path, "wb") as f:
                f.write(entry.data)
            entry.spilled_path = path
            entry.data = None
            self._used -= entry.size

    def _restore_locked(self, object_id: ObjectID, entry: ObjectEntry) -> bytes:
        assert entry.spilled_path is not None
        with open(entry.spilled_path, "rb") as f:
            data = f.read()
        entry.data = data
        self._used += entry.size
        self._maybe_spill_locked()
        return data


@dataclass
class _RefRecord:
    local_refs: int = 0
    submitted_task_refs: int = 0  # pending tasks that take this ref as an arg


class ReferenceCounter:
    """Refcounting of one process's objects (reference: reference_counter.h,
    without borrowers or lineage: every holder is in this process). An
    object is released once no ObjectRef to it is alive and no pending task
    takes it as an argument; ``on_release`` then deletes it from the store.
    """

    def __init__(self, on_release=None):
        self._records: dict[ObjectID, _RefRecord] = {}
        self._lock = threading.RLock()
        self._on_release = on_release

    def add_owned(self, object_id: ObjectID, local_refs: int = 0):
        """Register an object. ``local_refs`` pre-takes that many local refs
        in the same lock round trip (the returned ObjectRef is then built
        with ObjectRef.counted)."""
        with self._lock:
            rec = self._records.setdefault(object_id, _RefRecord())
            rec.local_refs += local_refs

    def has(self, object_id: ObjectID) -> bool:
        """Whether anything still counts ``object_id``."""
        with self._lock:
            return object_id in self._records

    def add_local_ref(self, object_id: ObjectID):
        with self._lock:
            self._records.setdefault(object_id, _RefRecord()).local_refs += 1

    def remove_local_ref(self, object_id: ObjectID):
        with self._lock:
            rec = self._records.get(object_id)
            if rec is None:
                return
            rec.local_refs = max(0, rec.local_refs - 1)
            self._maybe_release_locked(object_id, rec)

    def on_task_submitted(self, arg_ids: list[ObjectID]):
        """reference_counter.h: UpdateSubmittedTaskReferences (:79)."""
        with self._lock:
            for oid in arg_ids:
                self._records.setdefault(oid, _RefRecord()).submitted_task_refs += 1

    def on_task_finished(self, arg_ids: list[ObjectID]):
        """reference_counter.h: UpdateFinishedTaskReferences (:88)."""
        with self._lock:
            for oid in arg_ids:
                rec = self._records.get(oid)
                if rec is None:
                    continue
                rec.submitted_task_refs = max(0, rec.submitted_task_refs - 1)
                self._maybe_release_locked(oid, rec)

    def _maybe_release_locked(self, object_id: ObjectID, rec: _RefRecord) -> None:
        if rec.local_refs == 0 and rec.submitted_task_refs == 0:
            self._records.pop(object_id, None)
            if self._on_release is not None:
                self._on_release(object_id)
