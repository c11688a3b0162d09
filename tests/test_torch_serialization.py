"""ray_tpu_torch's by-value pickler (``utils/serialization.py``) on the CPU.

What pickle cannot find by name (local functions and classes, lambdas,
anything defined in ``__main__``) is written whole when a process talks
to worker processes. Each case here is pickled in this process and loaded
in a fresh ``python -c`` interpreter, which has never seen the
definitions: closures over closures, a recursive function, a class whose
method calls ``super()``, ``functools.partial``, a dataclass defined in
``__main__`` (its generated ``__init__``, ``__repr__`` and ``__eq__``
included), a ``__slots__`` class with a property, a staticmethod and a
classmethod, and a function whose globals hold a CPU tensor (copied).
An open handle (lock, file, socket, thread, generator) and a function
that captures a device tensor raise ``pickle.PicklingError`` at once.
The fresh interpreter imports neither JAX nor ray_tpu nor cloudpickle.
The in-process runtime keeps passing such objects by reference.
"""

import dataclasses
import functools
import os
import pickle
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch.utils import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def by_value():
    serialization.set_by_value(True)
    try:
        yield serialization
    finally:
        serialization.set_by_value(False)


def _cases():
    k = 3

    def add(x):
        return x + k

    def twice(x):
        return add(add(x))

    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    class Base:
        def hello(self):
            return "base"

    class Child(Base):
        def hello(self):
            return "child+" + super().hello()

    class Slotted:
        __slots__ = ("a",)

        def __init__(self):
            self.a = 5

        @property
        def b(self):
            return self.a * 2

        @staticmethod
        def s():
            return 7

        @classmethod
        def c(cls):
            return cls.__name__

    weights = torch.arange(4, dtype=torch.float32)

    def dot(x):
        return float((weights * x).sum())

    return {"closure": (twice, 1), "recursive": (fact, 5),
            "lambda": (lambda v: v * np.float32(2), 4),
            "partial": (functools.partial(pow, 2), 10),
            "tensor_global": (dot, 2.0), "child": Child,
            "slotted": Slotted}


_MAIN_SRC = '''
import dataclasses

@dataclasses.dataclass
class Pt:
    x: int
    y: list = dataclasses.field(default_factory=list)

    def norm(self):
        return self.x + len(self.y)
'''


def _main_dataclass():
    ns = {"__name__": "__main__"}
    exec(_MAIN_SRC, ns)
    return ns["Pt"]


_LOADER = '''
import sys
sys.path.insert(0, {root!r})
from ray_tpu_torch.utils import serialization as S
S.set_by_value(True)
d = S.loads(sys.stdin.buffer.read())
out = {{k: f(a) for k, (f, a) in d["cases"].items()}}
out["child"] = d["child"]().hello()
s = d["slotted"]()
out["slotted"] = (s.a, s.b, s.s(), s.c())
pt = d["pt"]
out["pt"] = (pt.norm(), pt == type(pt)(1, [2, 3]), repr(pt),
             type(pt)(4).y)
out["loaded"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle"))
print(repr(out))
'''


def test_by_value_cases_load_in_a_fresh_interpreter(by_value):
    cases = _cases()
    Pt = _main_dataclass()
    blob = serialization.dumps({
        "cases": {k: v for k, v in cases.items() if isinstance(v, tuple)},
        "child": cases["child"], "slotted": cases["slotted"],
        "pt": Pt(1, [2, 3])})
    proc = subprocess.run([sys.executable, "-c", _LOADER.format(root=ROOT)],
                          input=blob, capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    import ast

    out = ast.literal_eval(proc.stdout.decode().strip().replace(
        "np.float32(8.0)", "8.0"))
    assert out == {"closure": 7, "recursive": 120, "lambda": 8.0,
                   "partial": 1024, "tensor_global": 12.0,
                   "child": "child+base", "slotted": (5, 10, 7, "Slotted"),
                   "pt": (3, True, "Pt(x=1, y=[2, 3])", []), "loaded": []}


@pytest.mark.parametrize("handle", ["lock", "file", "socket", "thread",
                                    "generator"])
def test_open_handles_raise_at_pickling(by_value, handle):
    make = {"lock": threading.Lock, "file": lambda: open(os.devnull),
            "socket": socket.socket,
            "thread": lambda: threading.Thread(target=print),
            "generator": lambda: (i for i in range(2))}[handle]
    obj = make()
    try:
        with pytest.raises(pickle.PicklingError, match="open handle"):
            serialization.serialize_args((((lambda: obj),), {}))
        with pytest.raises(pickle.PicklingError, match="open handle"):
            serialization.serialize({"h": obj})
    finally:
        if hasattr(obj, "close"):
            obj.close()


def test_a_captured_device_tensor_raises(by_value):
    fake = torch.empty(2, device="meta")

    def uses():
        return fake.shape

    with pytest.raises(pickle.PicklingError, match="put\\(\\) it"):
        serialization.dumps(uses)


def test_module_level_names_stay_by_reference(by_value):
    blob = serialization.dumps([np.add, dataclasses.field, serialization])
    assert b"_make_function" not in blob
    assert serialization.loads(blob) == [np.add, dataclasses.field,
                                         serialization]


def test_the_in_process_runtime_keeps_passing_by_reference():
    assert not serialization.by_value()
    lock = threading.Lock()
    fn = lambda: lock  # noqa: E731 - a lambda is the case
    assert serialization.loads(serialization.dumps(fn)) is fn
    serialization.clear_local_objects()
