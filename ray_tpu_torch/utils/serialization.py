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
runtime, whose tasks and actors are threads of this interpreter. The
table holds its objects until :func:`clear_local_objects`, which the
runtime's ``shutdown`` calls.

**By value.** A process that talks to worker processes (the cluster
runtime, and every worker) switches to by-value pickling
(:func:`set_by_value`), cloudpickle's job in ray_tpu: a function or class
pickle cannot find by name, or one defined in ``__main__``, is written
whole: its code (``marshal``), closure cells, defaults, the globals its
code names, and, for a class, its namespace. A skeleton is made first and
filled after, so recursive references (a recursive function, a method
whose ``super()`` names its class) resolve to the same object. Names a
module defines stay by reference, as do modules themselves (re-imported).
An open handle (lock, socket, file, thread, generator, ...) raises
``pickle.PicklingError`` at submit, and so does a device tensor a
function captures: pass such a tensor as an argument or ``put`` it.

**Tensors.** A top-level torch tensor is written as a ``T`` record: a
dtype/shape/device header and its raw bytes (``serialize_parts`` hands
the bytes over without a copy, for the shared-memory arena); a tensor
nested in a value pickles by torch's own reduction. Either way a CUDA
tensor that is ``put`` or returned is copied through host memory and
loaded back onto a card (the receiving process's current device), as
ray_tpu pickles a ``jax.Array`` through numpy. Keep device tensors out of values that cross the store on a hot
path (train reports, say): send Python numbers.

ObjectRefs nested anywhere in a value are found in the same pickle pass
(``serialize_args``) or by a scan (``find_nested_refs``), as
``_extract_refs`` does in ray_tpu.
"""

from __future__ import annotations

import builtins
import dataclasses
import functools
import importlib
import io
import itertools
import marshal
import pickle
import sys
import threading
import types
from typing import Any

import numpy as np

# Wire format: 1-byte tag + payload.
_TAG_PICKLE = b"P"
_TAG_NDARRAY = b"N"
_TAG_TENSOR = b"T"
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

# Whether this process pickles functions, classes and handles by value
# (it talks to worker processes) or by reference (the in-process runtime).
_by_value = False


def set_by_value(on: bool) -> None:
    """Pickle functions and classes by value (``True``: a cluster runtime
    or a worker process) or by reference into the local table
    (``False``: the in-process runtime)."""
    global _by_value
    _by_value = bool(on)


def by_value() -> bool:
    return _by_value


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


# -- by value ---------------------------------------------------------------

class _EmptyCell:
    """Marks a closure cell that held no value when it was pickled."""


def _write_by_value(obj) -> bool:
    """A function or class goes by value where another process could not
    import it by name: defined in ``__main__``, locally, or as a lambda."""
    return obj.__module__ == "__main__" or not _importable(obj)


def _code_names(code: types.CodeType, out: set) -> set:
    """Global names ``code`` and the code objects nested in it read."""
    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _code_names(const, out)
    return out


def _is_device_tensor(value) -> bool:
    torch = sys.modules.get("torch")
    return (torch is not None and isinstance(value, torch.Tensor)
            and value.device.type != "cpu")


def _make_function(code, base_globals: dict, name: str, ncells: int):
    base_globals.setdefault("__builtins__", builtins.__dict__)
    closure = tuple(types.CellType() for _ in range(ncells)) or None
    return types.FunctionType(code, base_globals, name, None, closure)


def _function_setstate(fn, state) -> None:
    (captured, defaults, kwdefaults, cells, attrs, qualname, module,
     doc) = state
    fn.__globals__.update(captured)
    fn.__defaults__ = defaults
    fn.__kwdefaults__ = kwdefaults
    for cell, value in zip(fn.__closure__ or (), cells):
        if value is not _EmptyCell:
            cell.cell_contents = value
    fn.__dict__.update(attrs)
    fn.__qualname__ = qualname
    fn.__module__ = module
    fn.__doc__ = doc


def _make_class(metaclass, name: str, bases: tuple, namespace: dict):
    return metaclass(name, bases, dict(namespace))


def _class_setstate(cls, state: dict) -> None:
    for key, value in state.items():
        setattr(cls, key, value)


def _make_field(kwargs: dict, name, type_, field_type):
    f = dataclasses.field(**kwargs)
    f.name, f.type, f._field_type = name, type_, field_type
    return f


# Objects whose identity matters (``is`` checks): pickled by name.
_DATACLASS_SENTINELS = ("MISSING", "_HAS_DEFAULT_FACTORY", "_FIELD",
                        "_FIELD_CLASSVAR", "_FIELD_INITVAR",
                        "_EMPTY_METADATA")
_CLASS_SKIP = ("__dict__", "__weakref__", "_abc_impl")


class _Pickler(pickle.Pickler):
    """Stdlib pickler that records the ObjectRefs that stream past
    (``refs``, when given) and writes what pickle cannot find by name
    either by reference (the in-process runtime) or by value (processes)."""

    def __init__(self, file, refs: list | None = None):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._refs = refs
        self._value = _by_value
        # One globals dict per source module and pickle, so functions of
        # one module sent together share their globals on the far side.
        self._globals: dict[int, dict] = {}
        self._sentinels = {id(getattr(dataclasses, n)): n
                           for n in _DATACLASS_SENTINELS
                           if hasattr(dataclasses, n)}

    def persistent_id(self, obj):  # noqa: N802 - pickle API name
        if self._refs is not None and isinstance(obj, _object_ref_cls()):
            self._refs.append(obj)
            return None  # pickled as usual; only observed
        if not self._value and _by_reference(obj):
            return ("L", _local_objects.put(obj))
        return None

    def reducer_override(self, obj):  # noqa: C901 - one dispatch
        if not self._value:
            return NotImplemented
        if isinstance(obj, types.FunctionType):
            return self._function(obj) if _write_by_value(obj) \
                else NotImplemented
        if isinstance(obj, type):
            return self._class(obj) if _write_by_value(obj) \
                else NotImplemented
        if isinstance(obj, types.CodeType):
            return marshal.loads, (marshal.dumps(obj),)
        if isinstance(obj, types.ModuleType):
            if obj.__name__ == "__main__":
                raise pickle.PicklingError(
                    "cannot send the module __main__ to another process; "
                    "send the names it defines instead")
            return importlib.import_module, (obj.__name__,)
        if id(obj) in self._sentinels:
            return getattr, (dataclasses, self._sentinels[id(obj)])
        if isinstance(obj, dataclasses.Field):
            kw = dict(default=obj.default,
                      default_factory=obj.default_factory, init=obj.init,
                      repr=obj.repr, hash=obj.hash, compare=obj.compare,
                      metadata=dict(obj.metadata) or None)
            if hasattr(obj, "kw_only"):
                kw["kw_only"] = obj.kw_only
            return _make_field, (kw, obj.name, obj.type, obj._field_type)
        if isinstance(obj, (classmethod, staticmethod)):
            return type(obj), (obj.__func__,)
        if isinstance(obj, property):
            return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        if isinstance(obj, types.MappingProxyType):
            return types.MappingProxyType, (dict(obj),)
        if isinstance(obj, _handle_types()):
            raise pickle.PicklingError(
                f"cannot send {type(obj).__name__} {obj!r} to another "
                "process: an open handle (lock, socket, file, thread, "
                "generator, ...) exists only in the process that made it; "
                "make it inside the task or actor instead")
        return NotImplemented

    def _function(self, fn: types.FunctionType):
        g = fn.__globals__
        names = _code_names(fn.__code__, set())
        captured = {n: g[n] for n in names if n in g}
        cells = []
        for cell in fn.__closure__ or ():
            try:
                cells.append(cell.cell_contents)
            except ValueError:
                cells.append(_EmptyCell)
        for where, value in [*captured.items(),
                             *((f"closure of {fn.__qualname__}", v)
                               for v in cells)]:
            if _is_device_tensor(value):
                raise pickle.PicklingError(
                    f"{fn.__qualname__} captures a tensor on "
                    f"{value.device} ({where}): a function sent to another "
                    "process does not carry device memory; pass the tensor "
                    "as an argument or put() it")
        base = self._globals.setdefault(
            id(g), {"__name__": g.get("__name__", fn.__module__)})
        state = (captured, fn.__defaults__, fn.__kwdefaults__, cells,
                 dict(fn.__dict__), fn.__qualname__, fn.__module__,
                 fn.__doc__)
        return (_make_function,
                (fn.__code__, base, fn.__name__, len(cells)),
                state, None, None, _function_setstate)

    def _class(self, cls: type):
        ns = {"__module__": cls.__module__, "__qualname__": cls.__qualname__}
        slots = cls.__dict__.get("__slots__")
        skip = set(_CLASS_SKIP) | {"__module__", "__qualname__"}
        if slots is not None:
            ns["__slots__"] = slots
            skip.update([slots] if isinstance(slots, str) else slots)
            skip.add("__slots__")
        state = {k: v for k, v in cls.__dict__.items() if k not in skip}
        return (_make_class, (type(cls), cls.__name__, cls.__bases__, ns),
                state, None, None, _class_setstate)


class _Scanner(_Pickler):
    """Finds ObjectRefs without writing anything anywhere."""

    def __init__(self, found: list):
        super().__init__(io.BytesIO())
        self._found = found

    def persistent_id(self, obj):  # noqa: N802 - pickle API name
        if isinstance(obj, _object_ref_cls()):
            self._found.append(obj)
            return ("R", len(self._found) - 1)
        if not self._value and _by_reference(obj):
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


def dumps(obj: Any) -> bytes:
    """Pickle ``obj`` as this process's mode says (by value or by
    reference); ``loads`` reads it back."""
    return _dumps(obj)


loads = _loads


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


def _is_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    return (torch is not None and type(obj) is torch.Tensor
            and not obj.requires_grad and obj.layout == torch.strided)


def serialize_parts(obj: Any, refs: list | None = None) -> list:
    """``serialize(obj)`` as a list of buffers whose concatenation is the
    record: an array's or a tensor's bytes are handed over as a view of
    its memory, so a caller that scatters them into the arena copies them
    once. ObjectRefs nested in a pickled value are appended to ``refs``
    (when given)."""
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        header = pickle.dumps((obj.dtype.str, obj.shape))
        return [_TAG_NDARRAY, len(header).to_bytes(4, "little"), header,
                memoryview(np.ascontiguousarray(obj)).cast("B")]
    if _is_tensor(obj):
        t = obj.detach()
        header = pickle.dumps((str(t.dtype).removeprefix("torch."),
                               tuple(t.shape), t.device.type))
        flat = t.contiguous().reshape(-1)
        if flat.device.type != "cpu":
            flat = flat.cpu()
        raw = flat.view(sys.modules["torch"].uint8).numpy()
        return [_TAG_TENSOR, len(header).to_bytes(4, "little"), header,
                memoryview(raw).cast("B")]
    if type(obj) is bytes:
        # bytes ONLY: bytearray must round-trip as bytearray.
        return [_TAG_BYTES, obj]
    return [_TAG_PICKLE, _dumps(obj, refs)]


def serialize(obj: Any) -> bytes:
    """Serialize ``obj`` to a self-describing byte string."""
    parts = serialize_parts(obj)
    return parts[0] + parts[1] if len(parts) == 2 and \
        isinstance(parts[1], bytes) else b"".join(parts)


def _load_tensor(payload):
    import torch

    hlen = int.from_bytes(bytes(payload[:4]), "little")
    dtype, shape, device = pickle.loads(payload[4: 4 + hlen])
    raw = np.frombuffer(payload[4 + hlen:], dtype=np.uint8).copy()
    t = torch.from_numpy(raw).view(getattr(torch, dtype)).reshape(shape)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA tensor reached a process that sees no card: "
                "run the task or actor with num_gpus")
        t = t.to("cuda")
    return t


def deserialize(data) -> Any:
    """Deserialize from bytes or a memoryview. An array or tensor comes
    back as a writable copy."""
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
    if tag == _TAG_TENSOR:
        return _load_tensor(payload)
    raise ValueError(f"unknown serialization tag {tag!r}")
