"""Unique identifiers for cluster entities.

Semantics modeled on the reference's ID scheme (reference: src/ray/common/id.h):
every object has exactly one *owner* (the worker that created it), and the
owner's identity is embedded in the ObjectID so any holder of a ref can reach
the owner without a directory lookup. Task-return objects additionally embed
the creating task and a return index, which is what makes lineage
reconstruction possible (re-running the task deterministically re-creates the
same ObjectIDs).

This is a fresh implementation: fixed-width random ids with structured
ObjectIDs, hex round-tripping, and msgpack-friendly bytes representation.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import ClassVar

_UNIQUE_LEN = 16  # bytes of entropy for standalone ids

# Fast unique-id source: one urandom draw per process, then a counter.
# os.urandom is a syscall per call — measurable on the task-submission hot
# path (reference keeps id generation cheap for the same reason). The 8-byte
# random prefix keeps cross-process collision odds at 2^-64 per pair;
# itertools.count is atomic under the GIL.
_RAND_BASE = os.urandom(16)
_RAND64 = int.from_bytes(_RAND_BASE[8:], "little")
_COUNTER = itertools.count(int.from_bytes(os.urandom(6), "little"))
_MASK64 = (1 << 64) - 1


def _reseed_after_fork() -> None:
    # A fork()ed child inherits _RAND_BASE and the counter position and
    # would emit the parent's exact id stream — silent ObjectID/TaskID
    # collisions. Redraw the per-process entropy in the child.
    global _RAND_BASE, _RAND64, _COUNTER
    _RAND_BASE = os.urandom(16)
    _RAND64 = int.from_bytes(_RAND_BASE[8:], "little")
    _COUNTER = itertools.count(int.from_bytes(os.urandom(6), "little"))


os.register_at_fork(after_in_child=_reseed_after_fork)


def _unique_bytes(n: int) -> bytes:
    c = next(_COUNTER) & _MASK64
    if n <= 8:
        # Small ids (JobID): fold per-process entropy into the counter —
        # bare counter bits would collide across processes at ~2^-(8n/2).
        return ((c ^ _RAND64) & _MASK64).to_bytes(8, "little")[:n]
    return _RAND_BASE[: n - 8] + c.to_bytes(8, "little")


class BaseID:
    """A fixed-length binary id with hex printing and value equality."""

    SIZE: ClassVar[int] = _UNIQUE_LEN
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = binary
        self._hash = None

    @classmethod
    def from_random(cls):
        return cls(_unique_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        h = self._hash
        if h is None:
            h = self._hash = hash((type(self).__name__, self._bytes))
        return h

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    """JobID (4) + unique (12)."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + _unique_bytes(cls.SIZE - JobID.SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class TaskID(BaseID):
    """JobID (4) + unique (12). Actor-creation/method tasks derive from ActorID."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "TaskID":
        return cls(job_id.binary() + _unique_bytes(cls.SIZE - JobID.SIZE))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID, seq_no: int, handle_nonce: bytes = b"") -> "TaskID":
        # Deterministic per (actor, handle, seq) so retries regenerate the same
        # id, while distinct handles (e.g. via get_actor) never collide.
        nonce = (handle_nonce + b"\x00" * 4)[:4]
        suffix = seq_no.to_bytes(8, "little")
        return cls(actor_id.binary()[:4] + nonce + suffix)

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class ObjectID(BaseID):
    """TaskID (16) + return-index (4): identifies the idx'th return of a task.

    Objects created by ``put`` use a synthetic "put task" counter per worker.
    The owner address is tracked alongside in the reference-table entry rather
    than packed into the id (the reference packs a flag; we keep the id pure
    and carry the owner in object metadata — simpler and equally capable).
    """

    SIZE = 20
    _put_lock = threading.Lock()
    _put_index = 0

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, worker_id: WorkerID) -> "ObjectID":
        with cls._put_lock:
            cls._put_index += 1
            idx = cls._put_index
        # Put-ids embed the worker (owner) plus a monotone counter.
        return cls(worker_id.binary()[:12] + idx.to_bytes(8, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE :], "little")


NIL_JOB_ID = JobID.nil()
NIL_NODE_ID = NodeID.nil()
NIL_ACTOR_ID = ActorID.nil()
