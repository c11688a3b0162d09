"""ray_tpu_torch's in-process runtime and host collective against ray_tpu's,
on the CPU.

Each program runs twice in one test: under ``ray_tpu.init`` first, then
under ``ray_tpu_torch.init``, each runtime shut down before the next
starts (they never nest). Results must be equal and exceptions of the same
class name. Every ``get`` passes a timeout, so a deadlock fails the test
instead of hanging the run. ``num_tpus`` on ray_tpu's side is ``num_gpus``
on the port's.
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.collective as jax_col
import ray_tpu_torch
import ray_tpu_torch.collective as torch_col
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.utils import serialization

T = 30  # seconds: every get's timeout

SIDES = (("jax", ray_tpu, jax_col, "num_tpus"),
         ("torch", ray_tpu_torch, torch_col, "num_gpus"))


def both(program, **init_kw):
    """program(rt, col, accel_option) under each runtime in turn."""
    out = {}
    for name, rt, col, accel in SIDES:
        rt.shutdown()
        rt.init(**init_kw)
        try:
            out[name] = program(rt, col, accel)
        finally:
            rt.shutdown()
    return out["jax"], out["torch"]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is compared
        return e
    raise AssertionError("expected an exception")


def test_tasks_put_get_wait():
    def program(rt, col, accel):
        @rt.remote
        def square(x):
            return x * x

        @rt.remote
        def slow(x):
            time.sleep(1.5)  # still running when both waits look
            return x

        @rt.remote(num_returns=2)
        def pair(x):
            return x, -x

        vals = rt.get([square.remote(i) for i in range(5)], timeout=T)
        ref = rt.put(np.arange(6, dtype=np.float32).reshape(2, 3))
        arr = rt.get(square.remote(ref), timeout=T)
        a, b = pair.remote(7)
        fast = [square.remote(i) for i in range(3)]
        rt.get(fast, timeout=T)
        ready, pending = rt.wait(fast + [slow.remote(9)], num_returns=2,
                                 timeout=T)
        r_all, p_all = rt.wait(fast + [slow.remote(9)], num_returns=4,
                               timeout=0.05)
        return (vals, arr.tolist(), rt.get([a, b], timeout=T), len(ready),
                len(pending), len(r_all), len(p_all))

    want, got = both(program, num_cpus=8)
    assert got == want
    assert got[3:] == (3, 1, 3, 1)  # one scan takes every ready ref


def test_actor_state_named_actor_and_get_actor():
    def program(rt, col, accel):
        @rt.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def add(self, k=1):
                self.n += k
                return self.n

        c = Counter.remote(10)
        seq = rt.get([c.add.remote() for _ in range(5)], timeout=T)
        named = Counter.options(name="ctr").remote(0)
        rt.get(named.add.remote(3), timeout=T)
        again = rt.get_actor("ctr")
        dup = _raised(lambda: Counter.options(name="ctr").remote(0))
        missing = _raised(lambda: rt.get_actor("nope"))
        return (seq, rt.get(again.add.remote(2), timeout=T),
                type(dup).__name__, type(missing).__name__)

    want, got = both(program, num_cpus=4)
    assert got == want == ([11, 12, 13, 14, 15], 5, "ValueError",
                           "ValueError")


def test_max_concurrency_and_async_actor():
    def program(rt, col, accel):
        @rt.remote
        class Meet:
            def __init__(self):
                self.barrier = threading.Barrier(2, timeout=10)

            def arrive(self, i):
                self.barrier.wait()  # both calls must run at once
                return i

        @rt.remote
        class Gate:
            def __init__(self):
                import asyncio

                self.event = asyncio.Event()

            async def wait_open(self):
                await self.event.wait()
                return "opened"

            async def open(self):
                self.event.set()
                return True

        m = Meet.options(max_concurrency=2).remote()
        met = rt.get([m.arrive.remote(0), m.arrive.remote(1)], timeout=T)
        g = Gate.remote()
        waiting = g.wait_open.remote()
        ready, _ = rt.wait([waiting], timeout=0.2)
        opened = rt.get(g.open.remote(), timeout=T)
        return met, len(ready), opened, rt.get(waiting, timeout=T)

    want, got = both(program, num_cpus=4)
    assert got == want == ([0, 1], 0, True, "opened")


def test_task_error_carries_remote_traceback_and_kill_ends_actor():
    def program(rt, col, accel):
        @rt.remote
        def fails_deep(x):
            raise ValueError(f"bad input {x}")

        @rt.remote
        class A:
            def ping(self):
                return "pong"

        err = _raised(lambda: rt.get(fails_deep.remote(3), timeout=T))
        a = A.remote()
        before = rt.get(a.ping.remote(), timeout=T)
        rt.kill(a)
        died = _raised(lambda: rt.get(a.ping.remote(), timeout=T))
        return (type(err).__name__, type(err.cause).__name__,
                "fails_deep" in err.remote_tb, "bad input 3" in str(err),
                before, type(died).__name__)

    want, got = both(program, num_cpus=4)
    assert got == want == ("TaskError", "ValueError", True, True, "pong",
                           "ActorDiedError")


def test_nested_refs_in_arguments():
    def program(rt, col, accel):
        @rt.remote
        def total(items):
            # refs nested in a container arrive as refs
            return sum(rt.get(items["refs"], timeout=T)) + items["k"]

        @rt.remote
        def inc(x):
            return x + 1

        refs = [rt.put(i) for i in range(4)]
        out = rt.get(total.remote({"refs": refs, "k": 100}), timeout=T)
        chained = rt.get(inc.remote(inc.remote(rt.put(1))), timeout=T)
        return out, chained

    want, got = both(program, num_cpus=4)
    assert got == want == (106, 3)


def test_infeasible_accelerator_demand_raises_not_blocks():
    def program(rt, col, accel):
        @rt.remote
        def f():
            return 1

        @rt.remote
        class A:
            def ping(self):
                return 1

        t0 = time.monotonic()
        err = _raised(lambda: rt.get(f.options(**{accel: 1}).remote(),
                                     timeout=T))
        a = A.options(**{accel: 1}).remote()
        died = _raised(lambda: rt.get(a.ping.remote(), timeout=T))
        return (type(err).__name__, type(err.cause).__name__,
                "infeasible" in str(err), type(died).__name__,
                time.monotonic() - t0 < 10)

    want, got = both(program, num_cpus=4)
    assert got == want == ("TaskError", "ValueError", True,
                           "ActorDiedError", True)


def test_port_num_gpus_demands_the_gpu_resource():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, resources={"GPU": 2})
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        def assigned():
            return ray_tpu_torch.get_runtime_context().get_assigned_resources()

        assert ray_tpu_torch.get(assigned.remote(), timeout=T) == {
            "CPU": 1.0, "GPU": 1.0}
        assert ray_tpu_torch.cluster_resources() == {"CPU": 2.0, "GPU": 2.0}
    finally:
        ray_tpu_torch.shutdown()


def test_lambda_and_local_class_arguments():
    def program(rt, col, accel):
        class Point:  # defined locally: stdlib pickle cannot name it
            def __init__(self, x, y):
                self.x, self.y = x, y

            def norm2(self):
                return self.x ** 2 + self.y ** 2

        @rt.remote
        def apply(fn, p):
            return fn(p), type(p).__name__

        @rt.remote
        def make(cls, x):
            return cls(x, x)

        val = rt.get(apply.remote(lambda p: p.norm2() + 1, Point(3, 4)),
                     timeout=T)
        made = rt.get(make.remote(Point, 2), timeout=T)
        return val, made.norm2()

    want, got = both(program, num_cpus=4)
    assert got == want == ((26, "Point"), 8)


def test_port_passes_functions_classes_and_handles_by_reference():
    class Local:
        pass

    lock = threading.Lock()
    fn = lambda: 0  # noqa: E731
    for obj in (fn, Local, lock):
        assert serialization.deserialize(serialization.serialize(obj)) is obj
    # values keep copy semantics, and a local class's instance keeps its class
    inst = Local()
    inst.data = [1, 2]
    back = serialization.deserialize(serialization.serialize(inst))
    assert back is not inst and type(back) is Local and back.data == [1, 2]
    assert len(serialization._local_objects) >= 2
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        def locked(l):
            with l:  # the caller's own lock, not a copy
                return l is lock

        assert ray_tpu_torch.get(locked.remote(lock), timeout=T)
    finally:
        ray_tpu_torch.shutdown()
    assert len(serialization._local_objects) == 0  # freed by shutdown


def test_port_serialization_paths_and_nested_ref_scan():
    arr = np.arange(12, dtype=np.float16).reshape(3, 4)
    blob = serialization.serialize(arr)
    assert blob[:1] == b"N"
    back = serialization.deserialize(blob)
    assert back.dtype == arr.dtype and np.array_equal(back, arr)
    assert back.flags.writeable
    assert serialization.serialize(b"xyz") == b"Bxyz"
    assert serialization.deserialize(serialization.serialize(
        bytearray(b"ab"))) == bytearray(b"ab")
    t = torch.arange(4, dtype=torch.bfloat16)
    t2 = serialization.deserialize(serialization.serialize(t))
    assert t2.dtype == torch.bfloat16 and torch.equal(t2, t)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1)
    try:
        r1, r2 = ray_tpu_torch.put(1), ray_tpu_torch.put(2)
        found = serialization.find_nested_refs(
            {"a": [r1, (lambda: None,)], "b": {"c": r2}})
        assert found == [r1, r2]
    finally:
        ray_tpu_torch.shutdown()


def test_port_init_refuses_an_address():
    ray_tpu_torch.shutdown()
    for address in ("local-cluster", "auto", "127.0.0.1:6379"):
        with pytest.raises(NotImplementedError, match="7\\(b\\)"):
            ray_tpu_torch.init(address=address)
    assert not ray_tpu_torch.is_initialized()


def test_port_refuses_force_cancel_and_kill_with_restart():
    ray_tpu_torch.init(num_cpus=1)
    try:
        @ray_tpu_torch.remote
        class A:
            def ping(self):
                return 1

        a = A.remote()
        with pytest.raises(NotImplementedError, match="threads"):
            ray_tpu_torch.cancel(a.ping.remote(), force=True)
        with pytest.raises(NotImplementedError, match="max_restarts"):
            ray_tpu_torch.kill(a, no_restart=False)
    finally:
        ray_tpu_torch.shutdown()


def test_port_options_refuse_what_the_runtime_does_not_honour():
    def f():
        return 1

    with pytest.raises(NotImplementedError, match="runtime_env"):
        ray_tpu_torch.remote(runtime_env={"env_vars": {"A": "1"}})(f)
    with pytest.raises(NotImplementedError, match="placement"):
        ray_tpu_torch.remote(scheduling_strategy=object())(f)
    with pytest.raises(ValueError, match="streaming"):
        ray_tpu_torch.remote(num_returns="stream")(f)
    with pytest.raises(ValueError, match="num_tpus"):
        ray_tpu_torch.remote(num_tpus=1)(f)


def test_streaming_returns_match_ray_tpu():
    """num_returns="streaming" on a task and on an actor method: the same
    items in the same order, an error raised mid-stream at the same item,
    a stalled stream's _next(timeout) raising the same way."""
    def program(rt, col, accel):
        @rt.remote(num_returns="streaming")
        def squares(n):
            for i in range(n):
                yield i * i

        @rt.remote(num_returns="streaming")
        def breaks(n):
            for i in range(n):
                yield {"i": i}
            raise ValueError("mid-stream")

        @rt.remote(num_returns="streaming")
        def stalls():
            yield "first"
            time.sleep(1.0)
            yield "late"

        @rt.remote
        class Letters:
            def stream(self, n):
                for i in range(n):
                    yield chr(65 + i)

        items = [rt.get(r, timeout=T) for r in squares.remote(6)]
        a = Letters.remote()
        letters = [rt.get(r, timeout=T) for r in
                   a.stream.options(num_returns="streaming").remote(4)]
        seen, err = [], None
        gen = breaks.remote(3)
        try:
            for r in gen:
                seen.append(rt.get(r, timeout=T))
        except Exception as e:  # noqa: BLE001 - the class name is compared
            err = (type(e).__name__, "mid-stream" in str(e))
        s = stalls.remote()
        first = rt.get(next(s), timeout=T)
        stalled = type(_raised(lambda: s._next(0.2))).__name__
        late = rt.get(next(s), timeout=T)
        return (items, letters, seen, err, first, stalled, late,
                next(s, "end"))

    want, got = both(program, num_cpus=4)
    assert got == want == (
        [0, 1, 4, 9, 16, 25], ["A", "B", "C", "D"],
        [{"i": 0}, {"i": 1}, {"i": 2}], ("TaskError", True), "first",
        "TimeoutError", "late", "end")


def test_port_stream_dropped_by_its_consumer_stops_and_frees():
    """A generator dropped mid-stream stops its producer at the next yield
    (its finally runs) and the items nobody read are freed."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    rt = global_worker.runtime
    try:
        @ray_tpu_torch.remote
        class Source:
            def __init__(self):
                self.produced = 0
                self.closed = threading.Event()

            def stream(self):
                try:
                    while True:
                        self.produced += 1
                        yield np.zeros(1000)
                        time.sleep(0.005)
                finally:
                    self.closed.set()

            def report(self):
                return self.produced, self.closed.is_set()

        src = Source.options(max_concurrency=2).remote()
        gen = src.stream.options(num_returns="streaming").remote()
        assert ray_tpu_torch.get(next(gen), timeout=T).shape == (1000,)
        time.sleep(0.1)  # some items pile up unread
        del gen
        deadline = time.monotonic() + 10
        produced, closed = ray_tpu_torch.get(src.report.remote(), timeout=T)
        while not closed and time.monotonic() < deadline:
            time.sleep(0.02)
            produced, closed = ray_tpu_torch.get(src.report.remote(),
                                                 timeout=T)
        assert closed and produced > 2
        time.sleep(0.05)
        with rt.store._lock:
            left = len(rt.store._objects)
        assert left <= 1  # the report's reply at most
        assert rt._streams_closed == {} and rt._streams_ended == {}
    finally:
        ray_tpu_torch.shutdown()


def test_port_shutdown_joins_threads_even_with_a_rank_left_waiting():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    rt = global_worker.runtime

    @ray_tpu_torch.remote
    def lonely_rank():
        g = torch_col.init_collective_group(2, 0, backend="host",
                                            group_name="lonely")
        return g.allreduce(np.ones(2))  # rank 1 never comes

    @ray_tpu_torch.remote
    class Sleeper:
        def nap(self):
            return 1

    ref = lonely_rank.remote()
    s = Sleeper.options(max_concurrency=2).remote()
    ray_tpu_torch.get(s.nap.remote(), timeout=T)
    time.sleep(0.3)  # the rank is waiting in the coordinator now
    t0 = time.monotonic()
    assert rt.shutdown(timeout=10) == []
    ray_tpu_torch.shutdown()
    assert time.monotonic() - t0 < 10
    assert not [t for t in threading.enumerate()
                if t.name.startswith(rt._thread_prefix)]
    del ref


# -- the host collective ------------------------------------------------------

def _inputs(world):
    rng = np.random.default_rng(world)
    return [rng.standard_normal((6, 3)).astype(np.float32)
            for _ in range(world)]


def _collective_program(world, make_input=None):
    def program(rt, col, accel):
        xs = _inputs(world)

        @rt.remote
        def rank_main(rank, x):
            g = col.init_collective_group(world, rank, backend="host",
                                          group_name=f"g{world}")
            x = make_input(x) if make_input else x
            out = {"sum": g.allreduce(x), "max": g.allreduce(x, op="max"),
                   "gather": g.allgather(x), "rs": g.reducescatter(x),
                   "bcast": g.broadcast(x, src_rank=world - 1)}
            if make_input is None:  # the rest of the API, numpy only
                g.barrier()
                out["a2a"] = g.alltoall(x)
                out["reduce"] = g.reduce(x, dst_rank=0, op="min")
                if rank == 0:
                    g.send(x * 2, dst_rank=world - 1)
                if rank == world - 1:
                    out["recv"] = g.recv(x.shape, x.dtype, src_rank=0)
            return out

        return rt.get([rank_main.remote(r, xs[r]) for r in range(world)],
                      timeout=T)

    return program


@pytest.mark.parametrize("world", [2, 3])
def test_host_collective_matches_ray_tpu_bit_for_bit(world):
    want, got = both(_collective_program(world), num_cpus=8)
    for w_rank, g_rank in zip(want, got):
        for op in w_rank:
            assert g_rank[op].dtype == w_rank[op].dtype, op
            np.testing.assert_array_equal(g_rank[op], w_rank[op], err_msg=op)
    # every rank got the same reduction; reducescatter gave each its rows
    assert all(np.array_equal(r["sum"], got[0]["sum"]) for r in got)
    np.testing.assert_array_equal(
        np.concatenate([r["rs"] for r in got]), got[0]["sum"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_collective_takes_tensors_and_returns_their_dtype(dtype):
    """Tensors reduce on the host in their own dtype and rank order, and
    come back as tensors of that dtype: against ray_tpu's ``_combine`` on
    the same values as numpy (ml_dtypes' bfloat16 rounds after every add,
    as torch's does; ray_tpu's store cannot carry a bfloat16 array, so its
    coordinator's arithmetic is called directly)."""
    from ray_tpu.collective.host_backend import _GroupCoordinator

    world = 3
    xs = _inputs(world)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    coord = _GroupCoordinator(world)
    parts = {r: x.astype(np_dtype) for r, x in enumerate(xs)}
    rs = coord._combine(parts, "reducescatter:sum")
    want = [{"sum": coord._combine(parts, "sum"),
             "max": coord._combine(parts, "max"),
             "gather": coord._combine(parts, "gather"), "rs": rs[r],
             "bcast": coord._combine(parts, f"broadcast:{world - 1}")}
            for r in range(world)]
    to_t = (lambda x: torch.from_numpy(x).to(getattr(torch, dtype)))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    try:
        got = _collective_program(world, to_t)(ray_tpu_torch, torch_col,
                                               "num_gpus")
    finally:
        ray_tpu_torch.shutdown()
    for w_rank, g_rank in zip(want, got):
        for op, w in w_rank.items():
            g = g_rank[op]
            assert isinstance(g, torch.Tensor), op
            assert g.dtype == getattr(torch, dtype), op
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(w, dtype=np.float32),
                err_msg=op)


def test_host_collective_refuses_device_backends():
    for backend in ("xla", "nccl", "mpi"):
        with pytest.raises(NotImplementedError, match="item 7"):
            torch_col.init_collective_group(1, 0, backend=backend,
                                            group_name=backend)


def test_import_is_cheap_and_loads_no_jax_ray_tpu_or_cloudpickle():
    """Importing the package and the runtime's modules starts no thread,
    loads no torch (the runtime needs none) and nothing of JAX, ray_tpu or
    cloudpickle; the trainer's modules load torch but none of those."""
    import subprocess
    import sys

    code = (
        "import sys, threading\n"
        "import ray_tpu_torch, ray_tpu_torch.collective, ray_tpu_torch.serve\n"
        "print(threading.active_count(), 'torch' in sys.modules)\n"
        "import ray_tpu_torch.train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'ray_tpu', 'cloudpickle'))\n"
        "print(threading.active_count(), repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split("\n")[:2] == ["1 False", "1 []"], out.stdout
