"""Object serialization for the in-process runtime's object store.

Port of ray_tpu/utils/serialization.py with the standard library's
``pickle`` in place of cloudpickle. The wire format is the same: a 1-byte
tag, then the payload: ``N`` a numpy array as a dtype/shape header and its
raw buffer, ``B`` a top-level ``bytes`` value as itself, ``P`` a pickle of
anything else. Values keep copy semantics: a loaded value is a new object.

**By reference.** What stdlib pickle cannot write is passed by reference:
functions and classes it cannot find under their qualified name (lambdas,
nested functions, locally defined classes) and open handles (files,
sockets, locks, threads, queues, generators, event loops, modules). The
pickler stores such an object in a process-local table and writes its key;
loading returns the very same object. That is exact for the in-process
runtime, whose tasks and actors are threads of this interpreter. Process
workers (ROADMAP Queue A item 7(b)) will need a by-value pickler for these
(cloudpickle's job in ray_tpu). The table holds its objects until
:func:`clear_local_objects`, which the runtime's ``shutdown`` calls.

**Tensors.** A torch tensor pickles by torch's own reduction: a CUDA
tensor that is ``put`` or returned is copied through host memory and
loaded back onto its device, as ray_tpu pickles a ``jax.Array`` through
numpy. Keep device tensors out of values that cross the store on a hot
path (train reports, say): send Python numbers.

ObjectRefs nested anywhere in a value are found in the same pickle pass
(``serialize_args``) or by a scan (``find_nested_refs``), as
``_extract_refs`` does in ray_tpu.
"""

from __future__ import annotations

import functools
import io
import itertools
import pickle
import sys
import threading
import types
from typing import Any

import numpy as np

# Wire format: 1-byte tag + payload.
_TAG_PICKLE = b"P"
_TAG_NDARRAY = b"N"
_TAG_BYTES = b"B"  # top-level bytes: payload IS the value


class _LocalObjects:
    """Process-local table of the objects pickled by reference: one key per
    object (kept while the table holds it, so an id is never reused)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[int, Any] = {}
        self._keys: dict[int, int] = {}  # id(obj) -> key
        self._next = itertools.count()

    def put(self, obj: Any) -> int:
        with self._lock:
            key = self._keys.get(id(obj))
            if key is None:
                key = next(self._next)
                self._keys[id(obj)] = key
                self._objects[key] = obj
            return key

    def get(self, key: int) -> Any:
        with self._lock:
            try:
                return self._objects[key]
            except KeyError:
                raise pickle.UnpicklingError(
                    f"object {key} passed by reference is gone: the "
                    "runtime that held it shut down") from None

    def clear(self) -> None:
        with self._lock:
            self._objects.clear()
            self._keys.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)


_local_objects = _LocalObjects()


def clear_local_objects() -> None:
    """Drop every object passed by reference (the runtime's shutdown)."""
    _local_objects.clear()


@functools.cache
def _handle_types() -> tuple:
    import asyncio
    import concurrent.futures
    import queue
    import socket
    import weakref

    return (io.IOBase, socket.socket, type(threading.Lock()),
            type(threading.RLock()), threading.Condition, threading.Event,
            threading.Semaphore, threading.Thread, threading.local,
            queue.Queue, concurrent.futures.Future, asyncio.Future,
            asyncio.AbstractEventLoop, weakref.ReferenceType,
            types.GeneratorType, types.CoroutineType,
            types.AsyncGeneratorType, types.ModuleType, types.FrameType,
            types.TracebackType)


def _importable(obj) -> bool:
    """Whether pickle finds ``obj`` (a function or class) by its name."""
    name = getattr(obj, "__qualname__", None)
    module = sys.modules.get(getattr(obj, "__module__", None) or "")
    if not name or module is None or "<" in name:  # <lambda>, <locals>
        return False
    found = module
    for part in name.split("."):
        found = getattr(found, part, None)
        if found is None:
            return False
    return found is obj


def _by_reference(obj) -> bool:
    if isinstance(obj, (types.FunctionType, type)):
        return not _importable(obj)
    return isinstance(obj, _handle_types())


_ref_cls = None  # ObjectRef, bound on first use (import cycle)


def _object_ref_cls():
    global _ref_cls
    if _ref_cls is None:
        from ray_tpu_torch.core.object_ref import ObjectRef

        _ref_cls = ObjectRef
    return _ref_cls


class _Pickler(pickle.Pickler):
    """Stdlib pickler that passes what it cannot write by reference and
    records the ObjectRefs that stream past (``refs``, when given)."""

    def __init__(self, file, refs: list | None = None):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._refs = refs

    def persistent_id(self, obj):  # noqa: N802 - pickle API name
        if self._refs is not None and isinstance(obj, _object_ref_cls()):
            self._refs.append(obj)
            return None  # pickled as usual; only observed
        if _by_reference(obj):
            return ("L", _local_objects.put(obj))
        return None


class _Scanner(pickle.Pickler):
    """Finds ObjectRefs without writing anything anywhere."""

    def __init__(self, found: list):
        super().__init__(io.BytesIO(), protocol=pickle.HIGHEST_PROTOCOL)
        self._found = found

    def persistent_id(self, obj):  # noqa: N802 - pickle API name
        if isinstance(obj, _object_ref_cls()):
            self._found.append(obj)
            return ("R", len(self._found) - 1)
        if _by_reference(obj):
            return ("S", 0)
        return None


class _Unpickler(pickle.Unpickler):
    def persistent_load(self, pid):  # noqa: N802 - pickle API name
        kind, key = pid
        if kind != "L":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        return _local_objects.get(key)


def _dumps(obj: Any, refs: list | None = None) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, refs).dump(obj)
    return buf.getvalue()


def _loads(data) -> Any:
    return _Unpickler(io.BytesIO(data)).load()


def _extract_refs(obj: Any) -> list:
    """Find ObjectRefs nested anywhere in ``obj`` (via pickle traversal)."""
    found: list = []
    _Scanner(found).dump(obj)
    return found


def find_nested_refs(obj: Any) -> list:
    try:
        return _extract_refs(obj)
    except Exception:  # noqa: BLE001 - an unpicklable value holds no ref we can see
        return []


def serialize_args(args_kwargs: tuple) -> tuple[bytes, list]:
    """Serialize ``(args, kwargs)`` and collect nested ObjectRefs in ONE
    pickle pass."""
    found: list = []
    return _TAG_PICKLE + _dumps(args_kwargs, found), found


def serialize(obj: Any) -> bytes:
    """Serialize ``obj`` to a self-describing byte string."""
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        header = pickle.dumps((obj.dtype.str, obj.shape))
        return b"".join((_TAG_NDARRAY, len(header).to_bytes(4, "little"),
                         header, np.ascontiguousarray(obj).tobytes()))
    if type(obj) is bytes:
        # bytes ONLY: bytearray must round-trip as bytearray.
        return _TAG_BYTES + obj
    return _TAG_PICKLE + _dumps(obj)


def deserialize(data) -> Any:
    """Deserialize from bytes or a memoryview. An array comes back as a
    writable copy."""
    tag, payload = bytes(data[:1]), data[1:]
    if tag == _TAG_NDARRAY:
        hlen = int.from_bytes(bytes(payload[:4]), "little")
        dtype_str, shape = pickle.loads(payload[4: 4 + hlen])
        return np.frombuffer(payload[4 + hlen:], dtype=np.dtype(
            dtype_str)).reshape(shape).copy()
    if tag == _TAG_PICKLE:
        return _loads(payload)
    if tag == _TAG_BYTES:
        return bytes(payload)
    raise ValueError(f"unknown serialization tag {tag!r}")

