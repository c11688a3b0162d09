"""ObjectRef: a first-class distributed future.

Port of ray_tpu/core/object_ref.py for the in-process runtime (out: the
client proxy's ``refcount_disabled`` and the streaming tasks'
``ObjectRefGenerator``): a ref names an object owned by
exactly one worker; refs are cheap to copy and pickle; every live ref holds
one local reference in the runtime's reference counter, so an object is
freed when its last ref goes.
"""

from __future__ import annotations

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
