"""A worker process: runs the tasks and the actor a lease sends it.

Port of ray_tpu/core/cluster/worker_main.py. Started by a node daemon as
``python -m ray_tpu_torch.core.cluster.worker_main --daemon H:P --head
H:P --node-id N --worker-id W --shm NAME``. It pickles by value, attaches
to the node's arena, serves RPCs on one port (the executor's below, and
its ``ClusterRuntime``'s owner RPCs for the tasks it submits itself),
registers with its daemon over a connection it keeps open, and exits at
once when that connection closes.

- ``execute``: one task. Its function comes from the cache
  (``fn_registry.FnCache``), fetched from the head's KV on a miss; the
  refs passed as arguments arrive resolved (their values, or their arena
  locations); the results go back in the reply, inline when small and
  through the arena otherwise. A streaming task's yields go back as
  ``stream_item`` notes before the reply.
- ``create_actor`` / ``actor_call``: the actor this worker hosts. Calls
  run in arrival order on ``max_concurrency`` threads (one: strictly one
  after another); a coroutine method runs on the actor's own event loop.
- ``cancel_task``: raises TaskCancelledError in the thread running the
  task. ``close_stream``: a stream's consumer is gone.

Nothing here imports torch: a task that uses it imports it, after the
daemon has set ``CUDA_VISIBLE_DEVICES`` to the cards its lease holds.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import ctypes
import inspect
import os
import sys
import threading

from ray_tpu_torch.core import fn_registry
from ray_tpu_torch.core.cluster.protocol import (AsyncRpcClient,
                                                 EventLoopThread, RpcServer)
from ray_tpu_torch.core.cluster.runtime import (_RAISED, ClusterRuntime,
                                                _Chain, shm_record)
from ray_tpu_torch.core.exceptions import TaskCancelledError, TaskError
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.worker import global_worker, set_task_context
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import get_config
from ray_tpu_torch.utils.ids import (ActorID, JobID, NodeID, ObjectID,
                                     TaskID, WorkerID)


class Executor:
    def __init__(self, node_id: str, daemon_addr: tuple):
        self.node_id = node_id
        self.daemon_addr = daemon_addr
        self.runtime: ClusterRuntime | None = None
        self.fns = fn_registry.FnCache(get_config().fn_cache_max_bytes)
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="rtpt-task")
        self.running: dict[bytes, int] = {}  # task id -> thread ident
        self.closed_streams: set[bytes] = set()
        self.actor = None
        self.actor_id: ActorID | None = None
        self.actor_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self.actor_loop: asyncio.AbstractEventLoop | None = None
        self.actor_resources: dict = {}

    # -- pieces --------------------------------------------------------------
    def _fn(self, fid: str):
        fn = self.fns.get(fid)
        if fn is None:
            blob = self.runtime.kv_get(fid, ns=fn_registry.FN_NS)
            if blob is None:
                raise RuntimeError(f"definition {fid[:12]} was never exported")
            fn = serialization.deserialize(blob)
            self.fns.put(fid, fn, len(blob))
        return fn

    def _args(self, args_blob: bytes, arg_values: dict):
        args, kwargs = serialization.deserialize(args_blob)

        def resolve(v):
            if not isinstance(v, ObjectRef):
                return v
            rec = arg_values.get(v.id.binary())
            value = self.runtime.read_record(v.id, rec) if rec is not None \
                else self.runtime.get([v])[0]
            if isinstance(value, _RAISED):
                raise value
            return value

        return (tuple(resolve(a) for a in args),
                {k: resolve(v) for k, v in kwargs.items()})

    def _record(self, oid: ObjectID, value) -> bytes:
        rt = self.runtime
        found: list = []
        parts = serialization.serialize_parts(value, found)
        rt._pin(found)
        size = sum(len(memoryview(p).cast("B")) for p in parts)
        if rt.shm is not None and size > get_config().inline_object_max_bytes:
            rt.shm.put_parts(oid.binary(), parts)
            return shm_record(self.node_id, self.daemon_addr, size)
        return b"".join(memoryview(p).cast("B") for p in parts)

    def _results(self, task_id: TaskID, num_returns, result) -> list:
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(f"task declared num_returns={num_returns} "
                                 f"but returned {len(values)}")
        out = []
        for i, v in enumerate(values):
            if isinstance(v, ObjectRef):
                v = self.runtime.get([v])[0]  # a returned ref forwards its value
            out.append(self._record(ObjectID.for_task_return(task_id, i), v))
        return out

    def _stream(self, conn, task_id: TaskID, gen) -> int:
        n = 0
        tid = task_id.binary()
        for v in gen:
            rec = self._record(ObjectID.for_task_return(task_id, n), v)
            conn.notify("stream_item", task_id=tid, index=n, rec=rec)
            n += 1
            if tid in self.closed_streams:
                close = getattr(gen, "close", None)
                if close is not None:
                    close()
                break
        return n

    def _run(self, conn, task_id: TaskID, name: str, call, num_returns,
             resources: dict, actor_id=None) -> dict:
        """Run ``call()`` on this thread as task ``task_id``; the reply."""
        tid = task_id.binary()
        self.running[tid] = threading.get_ident()
        set_task_context(task_id, actor_id, resources)
        app_error = False
        try:
            try:
                result = call()
                if num_returns == "streaming":
                    result = self._stream(conn, task_id, result)
                    num_returns = 1
                results = self._results(task_id, num_returns, result)
            except _RAISED as e:
                results = [serialization.serialize(e)]
            except Exception as e:  # noqa: BLE001 - the task's own error
                app_error = True
                results = [serialization.serialize(TaskError(e, name))]
        finally:
            self.running.pop(tid, None)
            set_task_context(None, None, None)
        if len(results) == 1 and not isinstance(num_returns, str) \
                and num_returns > 1:
            results = results * num_returns
        return {"results": results, "app_error": app_error}

    # -- RPCs ----------------------------------------------------------------
    async def _handle_execute(self, conn, task_id: bytes, name: str,
                              fn_id: str, args_blob: bytes, arg_values: dict,
                              num_returns, resources: dict, job_id: bytes,
                              trace_ctx=None) -> dict:
        tid = TaskID(task_id)
        global_worker.job_id = JobID(job_id)

        def call():
            fn = self._fn(fn_id)
            args, kwargs = self._args(args_blob, arg_values)
            return fn(*args, **kwargs)

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.pool, self._run, conn, tid, name, call, num_returns,
            resources)

    async def _handle_create_actor(self, conn, actor_id: str, fn_id: str,
                                   args_blob: bytes, arg_values: dict,
                                   max_concurrency: int, job_id: bytes,
                                   resources: dict) -> bool:
        global_worker.job_id = JobID(job_id)
        self.actor_id = ActorID.from_hex(actor_id)
        self.actor_resources = resources
        self.actor_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, int(max_concurrency)),
            thread_name_prefix="rtpt-actor")

        def make():
            set_task_context(None, self.actor_id, resources)
            try:
                cls = self._fn(fn_id)
                args, kwargs = self._args(args_blob, arg_values)
                return cls(*args, **kwargs)
            finally:
                set_task_context(None, None, None)

        loop = asyncio.get_running_loop()
        self.actor = await loop.run_in_executor(self.actor_pool, make)
        return True

    def _actor_loop(self) -> asyncio.AbstractEventLoop:
        if self.actor_loop is None:
            self.actor_loop = asyncio.new_event_loop()
            threading.Thread(target=self.actor_loop.run_forever, daemon=True,
                             name="rtpt-actor-loop").start()
        return self.actor_loop

    async def _handle_actor_call(self, conn, actor_id: str, task_id: bytes,
                                 method: str, args_blob: bytes,
                                 arg_values: dict, num_returns,
                                 trace_ctx=None) -> dict:
        tid = TaskID(task_id)
        bound = getattr(self.actor, method)

        def call():
            args, kwargs = self._args(args_blob, arg_values)
            if inspect.iscoroutinefunction(bound):
                return asyncio.run_coroutine_threadsafe(
                    bound(*args, **kwargs), self._actor_loop()).result()
            return bound(*args, **kwargs)

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.actor_pool, self._run, conn, tid, method, call, num_returns,
            self.actor_resources, self.actor_id)

    def _handle_cancel_task(self, conn, task_id: bytes) -> None:
        ident = self.running.get(task_id)
        if ident is not None:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError))

    def _handle_close_stream(self, conn, task_id: bytes) -> None:
        self.closed_streams.add(task_id)

    def _handle_ping(self, conn) -> dict:
        return {"pid": os.getpid()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--daemon", required=True)
    p.add_argument("--head", required=True)
    p.add_argument("--node-id", required=True)
    p.add_argument("--worker-id", required=True)
    p.add_argument("--shm", required=True)
    a = p.parse_args(argv)
    serialization.set_by_value(True)
    io = EventLoopThread.get()
    dhost, dport = a.daemon.rsplit(":", 1)
    hhost, hport = a.head.rsplit(":", 1)
    executor = Executor(a.node_id, (dhost, int(dport)))
    server = RpcServer(None, "127.0.0.1", 0)
    io.run(server.start(), 30)
    rt = ClusterRuntime(hhost, int(hport), a.node_id, (dhost, int(dport)),
                        a.shm, worker_id=WorkerID.from_hex(a.worker_id),
                        server=server)
    server.handler = _Chain(executor, rt)
    executor.runtime = rt
    global_worker.runtime = rt
    global_worker.worker_id = rt.worker_id
    global_worker.node_id = NodeID.from_random()
    global_worker.mode = "worker"
    gone = threading.Event()

    async def register():
        c = await AsyncRpcClient(dhost, int(dport),
                                 on_close=gone.set).connect()
        await c.call("register_worker", worker_id=a.worker_id,
                     addr=server.address, pid=os.getpid())
        return c

    daemon = io.run(register(), 60)  # held: the connection lives with it
    gone.wait()
    del daemon
    # The daemon is gone: so is this worker (no teardown: its threads may
    # be inside a task).
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
