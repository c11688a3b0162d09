"""In-process runtime: executes the full tasks/actors/objects semantics inside
one process, with threads standing in for workers.

Port of ray_tpu/core/local_runtime.py: resource-aware scheduling with
dependency resolution *before* resource acquisition, ordered actor
mailboxes with optional concurrency/async execution, named actors, restarts
of a failed ``__init__``, error propagation into result objects, and the
KV. An infeasible demand (more of a resource than the runtime has at all,
e.g. ``num_gpus=1`` on a runtime started without ``resources={"GPU": n}``)
raises at once instead of waiting.

Streaming returns (``num_returns="streaming"``): the executor drives the
task's generator, each yield becomes an object the consumer's
ObjectRefGenerator picks up, and the item count (or the producer's error)
lands under STREAM_END_INDEX.

Out: the flight recorder, placement groups, runtime envs, the function
registry, compiled-graph hooks and the state API's snapshot. Added:
``shutdown`` stops every thread the runtime started (its task pool, actor
threads and their pools and event loops): waiting ``get``s and ``wait``s
end, pending coroutines of async actors are cancelled, and the threads are
joined within a deadline. A killed or ended actor's instance is dropped, so
what it holds (device memory) can be freed; ``wait_actor_released`` waits
until its thread has given its resources back and dropped it. A stream whose consumer
dropped its generator stops at the producer's next yield (``close_stream``).
"""

from __future__ import annotations

import asyncio
import contextlib
import inspect
import itertools
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.core.events import global_event_buffer, task_execution
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    OutOfMemoryError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.store import LocalObjectStore, ReferenceCounter
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskSpec
from ray_tpu_torch.core.worker import _task_context, set_task_context
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.ids import ActorID, ObjectID, WorkerID

# Execution-thread pool cap AND the overflow threshold in submit_task: past
# this many in-flight tasks, new submissions get dedicated threads so pool
# threads blocked in nested get() can never starve the tasks they wait on.
_TASK_POOL_SIZE = 64

# How long shutdown() waits, in all, for the runtime's threads to end.
SHUTDOWN_JOIN_S = 10.0

_runtime_ids = itertools.count()


class _ResourcePool:
    """Blocking counted-resource pool (CPU/GPU/custom), FIFO-fair."""

    def __init__(self, totals: dict[str, float]):
        self._avail = dict(totals)
        self._totals = dict(totals)
        self._cv = threading.Condition()
        self._closed = False

    def acquire(self, demand: dict[str, float], timeout: float | None = None) -> bool:
        if not demand:
            return True
        with self._cv:
            def fits():
                return self._closed or all(
                    self._avail.get(k, 0.0) >= v for k, v in demand.items())

            for k, v in demand.items():
                if self._totals.get(k, 0.0) < v:
                    raise ValueError(
                        f"infeasible resource demand {k}={v} (total {self._totals.get(k, 0.0)})"
                    )
            if not self._cv.wait_for(fits, timeout) or self._closed:
                return False
            for k, v in demand.items():
                self._avail[k] = self._avail.get(k, 0.0) - v
            return True

    def release(self, demand: dict[str, float]) -> None:
        if not demand:
            return
        with self._cv:
            for k, v in demand.items():
                self._avail[k] = self._avail.get(k, 0.0) + v
            self._cv.notify_all()

    def close(self) -> None:
        """Fail every waiting and later acquire (the runtime's shutdown)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def available(self) -> dict[str, float]:
        with self._cv:
            return dict(self._avail)

    def totals(self) -> dict[str, float]:
        with self._cv:
            return dict(self._totals)


@dataclass
class _ActorState:
    spec: ActorCreationSpec
    instance: Any = None
    mailbox: "queue.Queue[TaskSpec | None]" = None
    dead: bool = False
    death_reason: str = ""
    restarts_used: int = 0
    loop: asyncio.AbstractEventLoop | None = None
    pool: ThreadPoolExecutor | None = None
    # Set once the actor's thread has released its resources and dropped
    # its instance (wait_actor_released).
    ended: threading.Event = field(default_factory=threading.Event)


async def _cancel_all_tasks() -> None:
    """Cancel every other task on this loop and wait until they end (their
    callers' ``fut.result()`` then raise instead of waiting forever)."""
    me = asyncio.current_task()
    tasks = [t for t in asyncio.all_tasks() if t is not me]
    for task in tasks:
        task.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


class LocalRuntime:
    """Single-process implementation of the Runtime interface."""

    def __init__(self, num_cpus: float = 8, resources: dict[str, float] | None = None):
        totals = {"CPU": float(num_cpus)}
        totals.update(resources or {})
        self.worker_id = WorkerID.from_random()
        # Every thread this runtime starts carries this prefix, so
        # shutdown() can find and join them all.
        self._thread_prefix = f"rtt{next(_runtime_ids)}-"
        self.store = LocalObjectStore()
        # Event-driven wait(): seals notify the condition so wait() wakes
        # immediately instead of polling.
        self._wait_cond = threading.Condition()

        def _notify():
            with self._wait_cond:
                self._wait_cond.notify_all()

        self.store.on_seal = _notify
        self._task_pool = ThreadPoolExecutor(
            max_workers=_TASK_POOL_SIZE,
            thread_name_prefix=self._thread_prefix + "task")
        self._tasks_inflight = 0  # includes tasks blocked in nested get()
        self._inflight_lock = threading.Lock()
        self._released: set[ObjectID] = set()
        # container object -> ObjectIDs nested inside its stored value
        # (reference semantics: nested refs keep the inner object alive
        # until the outer object is GC'd)
        self._nested: dict[ObjectID, list[ObjectID]] = {}
        self.refs = ReferenceCounter(on_release=self._on_release)
        self.resources = _ResourcePool(totals)
        self._actors: dict[ActorID, _ActorState] = {}
        self._named_actors: dict[tuple[str, str], ActorID] = {}
        self._cancelled: set[ObjectID] = set()
        self._kv: dict[str, dict[str, bytes]] = {}
        # Streams whose consumer is gone (task id -> first unread index),
        # and streams that ended before their consumer went (task id ->
        # item count); each entry is popped by whichever side comes second.
        self._streams_closed: dict = {}
        self._streams_ended: dict = {}
        self._lock = threading.RLock()
        self._shutdown = False

    def _start_thread(self, target, args: tuple, name: str) -> threading.Thread:
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=self._thread_prefix + name)
        t.start()
        return t

    def _on_release(self, oid: ObjectID) -> None:
        # Tombstone so a result landing after all refs died is dropped, not
        # stored forever (fire-and-forget tasks).
        self._released.add(oid)
        self.store.delete(oid)
        for nid in self._nested.pop(oid, ()):  # release refs the value held
            self.refs.remove_local_ref(nid)

    def _register_nested(self, oid: ObjectID, value: Any) -> None:
        """Refs nested in a stored value are held by the container object."""
        nested = serialization.find_nested_refs(value)
        if nested:
            for r in nested:
                self.refs.add_local_ref(r.id)
            self._nested[oid] = [r.id for r in nested]

    # ------------------------------------------------------------------ put/get
    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.for_put(self.worker_id)
        self.store.put(oid, serialization.serialize(value), self.worker_id)
        self.refs.add_owned(oid, local_refs=1)
        self._register_nested(oid, value)
        return ObjectRef.counted(oid, self.worker_id)

    @contextlib.contextmanager
    def _yield_task_resources(self):
        """Release the calling task's acquired resources for the duration of
        a blocking get()/wait() and re-acquire afterwards (a worker blocked
        in get returns its CPU so the tasks it waits on can run). Actors
        hold their resources for their lifetime — only plain tasks yield."""
        res = getattr(_task_context, "resources", None)
        if not res or getattr(_task_context, "actor_id", None) is not None:
            yield
            return
        self.resources.release(res)
        try:
            yield
        finally:
            self.resources.acquire(res, timeout=None)

    def get(self, refs: list[ObjectRef], timeout: float | None = None) -> list[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        with self._yield_task_resources():
            for ref in refs:
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                try:
                    data = self.store.get(ref.id, timeout=remaining)
                except TimeoutError:
                    raise GetTimeoutError(f"get() timed out waiting for {ref}") from None
                value = serialization.deserialize(data)
                if isinstance(value, (TaskError, ActorDiedError, TaskCancelledError,
                          OutOfMemoryError)):
                    raise value
                out.append(value)
        return out

    def wait(
        self,
        refs: list[ObjectRef],
        num_returns: int = 1,
        timeout: float | None = None,
        fetch_local: bool = True,
    ) -> tuple[list[ObjectRef], list[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._yield_task_resources():
            return self._wait_loop([], list(refs), num_returns, deadline)

    def _wait_loop(self, ready, pending, num_returns, deadline):
        while len(ready) < num_returns and not self._shutdown:
            progressed = False
            still = []
            for r in pending:
                if self.store.contains(r.id):
                    ready.append(r)
                    progressed = True
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if not progressed:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                with self._wait_cond:
                    # Recheck under the lock: a seal between the scan above
                    # and this acquire would otherwise be a lost wakeup.
                    if not any(self.store.contains(r.id) for r in pending):
                        self._wait_cond.wait(
                            0.05 if remaining is None else min(remaining, 0.05))
        return ready, pending

    # ------------------------------------------------------------------ tasks
    def submit_task(self, spec: TaskSpec) -> list[ObjectRef]:
        return_ids = spec.return_ids()
        for oid in return_ids:
            self.refs.add_owned(oid, local_refs=1)
        self.refs.on_task_submitted(spec.arg_ref_ids)
        global_event_buffer().record(
            spec.task_id.hex(), spec.name, "SUBMITTED",
            worker_id=self.worker_id.hex(), job_id=spec.job_id.hex())
        # Pooled execution threads, with overflow: when every pool thread is
        # occupied (possibly all blocked in nested gets), new submissions
        # get dedicated threads instead of queueing behind the blocked ones.
        with self._inflight_lock:
            self._tasks_inflight += 1
            overflow = self._tasks_inflight > _TASK_POOL_SIZE
        if overflow:
            self._start_thread(self._run_pooled, (spec, return_ids),
                               f"task-ovf-{spec.name[:20]}")
        else:
            self._task_pool.submit(self._run_pooled, spec, return_ids)
        return [ObjectRef.counted(oid, self.worker_id) for oid in return_ids]

    def _run_pooled(self, spec: TaskSpec, return_ids: list[ObjectID]) -> None:
        try:
            self._run_normal_task(spec, return_ids)
        finally:
            with self._inflight_lock:
                self._tasks_inflight -= 1

    def _run_normal_task(self, spec: TaskSpec, return_ids: list[ObjectID]) -> None:
        wid = self.worker_id.hex()
        attempts = 0
        try:
            while True:
                if return_ids[0] in self._cancelled:
                    self._store_error(return_ids, TaskCancelledError(spec.name))
                    global_event_buffer().record(
                        spec.task_id.hex(), spec.name, "CANCELLED", worker_id=wid)
                    return
                try:
                    fn = serialization.deserialize(spec.fn_blob)
                    args, kwargs = self._resolve_args(spec)
                    if not self.resources.acquire(spec.resources, timeout=None):
                        raise RuntimeError("resource acquisition failed: the "
                                           "runtime is shutting down")
                    set_task_context(spec.task_id, None, spec.resources)
                    try:
                        with task_execution(spec, wid):
                            result = fn(*args, **kwargs)
                    finally:
                        set_task_context(None, None, None)
                        self.resources.release(spec.resources)
                    self._store_results(spec, return_ids, result)
                    return
                except (TaskError, ActorDiedError, TaskCancelledError) as e:
                    # dependency failed: propagate, don't retry (errors in
                    # args poison downstream tasks)
                    self._store_error(return_ids, e)
                    return
                except BaseException as e:  # noqa: BLE001 - stored, raised at get()
                    attempts += 1
                    if spec.retry_exceptions and attempts <= spec.max_retries:
                        continue
                    self._store_error(return_ids, TaskError(e, task_desc=spec.name))
                    return
        finally:
            # Exactly once per task, regardless of retries.
            self.refs.on_task_finished(spec.arg_ref_ids)

    def _resolve_args(self, spec: TaskSpec) -> tuple[tuple, dict]:
        args, kwargs = serialization.deserialize(spec.args_blob)
        return self._replace_refs(args), self._replace_refs(kwargs)

    def _replace_refs(self, obj: Any) -> Any:
        # Top-level ObjectRefs in args are resolved to values. Nested refs
        # inside containers are passed through un-resolved, as in the
        # reference.
        if isinstance(obj, ObjectRef):
            return self.get([obj])[0]
        if isinstance(obj, tuple):
            return tuple(self._replace_refs(o) if isinstance(o, ObjectRef) else o for o in obj)
        if isinstance(obj, dict):
            return {k: (self._replace_refs(v) if isinstance(v, ObjectRef) else v) for k, v in obj.items()}
        return obj

    def _store_results(self, spec: TaskSpec, return_ids: list[ObjectID], result: Any) -> None:
        if spec.num_returns == "streaming":
            self._drive_stream(spec, result)
            return
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                self._store_error(
                    return_ids,
                    TaskError(
                        ValueError(
                            f"task declared num_returns={spec.num_returns} but returned {len(values)}"
                        ),
                        task_desc=spec.name,
                    ),
                )
                return
        for oid, v in zip(return_ids, values):
            if isinstance(v, ObjectRef):
                # Returning a ref forwards the underlying value.
                v = self.get([v])[0]
            if oid not in self._released:
                self.store.put(oid, serialization.serialize(v), self.worker_id)
                self._register_nested(oid, v)

    def _drive_stream(self, spec: TaskSpec, gen: Any) -> None:
        """Executor side of a streaming task: store each yield as return
        index i, then the count (or the producer's error) under
        STREAM_END_INDEX. A consumer that went away (close_stream) stops
        the drive at the next yield; the producer is closed there, so its
        ``finally`` blocks run."""
        from ray_tpu_torch.core.object_ref import STREAM_END_INDEX

        tid = spec.task_id
        n = 0
        end_value: Any
        try:
            for v in gen:
                oid = ObjectID.for_task_return(tid, n)
                self.store.put(oid, serialization.serialize(v), self.worker_id)
                self.refs.add_owned(oid)
                n += 1
                if tid in self._streams_closed:
                    close = getattr(gen, "close", None)
                    if close is not None:
                        close()
                    break
            end_value = n
        except BaseException as e:  # noqa: BLE001 - stream error -> end marker
            end_value = TaskError(e, task_desc=spec.name)
        with self._lock:
            first_unread = self._streams_closed.pop(tid, None)
            if first_unread is None:
                self._streams_ended[tid] = n
        if first_unread is not None:
            self._drop_stream_items(tid, first_unread, n)
        end = ObjectID.for_task_return(tid, STREAM_END_INDEX)
        if end not in self._released:
            self.store.put(end, serialization.serialize(end_value),
                           self.worker_id)

    def close_stream(self, task_id, first_unread: int) -> None:
        """The consumer dropped its ObjectRefGenerator: items it never read
        are freed, and a stream still running stops at its next yield."""
        with self._lock:
            count = self._streams_ended.pop(task_id, None)
            if count is None:
                self._streams_closed[task_id] = first_unread
                return
        self._drop_stream_items(task_id, first_unread, count)

    def _drop_stream_items(self, task_id, start: int, stop: int) -> None:
        for i in range(start, stop):
            oid = ObjectID.for_task_return(task_id, i)
            self.refs.add_local_ref(oid)  # released at once: deletes it
            self.refs.remove_local_ref(oid)

    def _store_error(self, return_ids: list[ObjectID], err: BaseException) -> None:
        blob = serialization.serialize(err)
        for oid in return_ids:
            if oid not in self._released:
                self.store.put(oid, blob, self.worker_id)

    def cancel(self, ref: ObjectRef) -> None:
        self._cancelled.add(ref.id)

    # ------------------------------------------------------------------ actors
    def create_actor(self, spec: ActorCreationSpec) -> None:
        state = _ActorState(spec=spec, mailbox=queue.Queue())
        with self._lock:
            if spec.name:
                key = (spec.namespace, spec.name)
                if key in self._named_actors:
                    raise ValueError(f"actor name {spec.name!r} already taken in {spec.namespace!r}")
                self._named_actors[key] = spec.actor_id
            self._actors[spec.actor_id] = state
        self._start_thread(
            self._actor_main, (state,), f"actor-{spec.actor_id.hex()[:8]}")

    def _actor_main(self, state: _ActorState) -> None:
        try:
            self._actor_run(state)
        finally:
            state.ended.set()

    def _actor_run(self, state: _ActorState) -> None:
        spec = state.spec
        try:
            if not self.resources.acquire(spec.resources, timeout=None):
                raise RuntimeError("the runtime is shutting down")
        except (ValueError, RuntimeError) as e:
            self._mark_actor_dead(state, f"resource acquisition failed: {e}")
            return
        # Restart-on-init-failure up to max_restarts.
        while True:
            try:
                self._actor_init(state)
                break
            except BaseException as e:  # noqa: BLE001 - the actor dies with its reason
                if state.restarts_used < spec.max_restarts:
                    state.restarts_used += 1
                    continue
                self.resources.release(spec.resources)
                self._mark_actor_dead(state, f"__init__ failed: {e!r}")
                return
        if state.spec.max_concurrency > 1:
            state.pool = ThreadPoolExecutor(
                max_workers=state.spec.max_concurrency,
                thread_name_prefix=self._thread_prefix + "actor-pool")
        try:
            while True:
                item = state.mailbox.get()
                if item is None:
                    break
                self._execute_actor_task(state, item)
        finally:
            if state.pool:
                state.pool.shutdown(wait=False)
            if state.loop:
                state.loop.call_soon_threadsafe(state.loop.stop)
            self.resources.release(spec.resources)
            # A process exit frees what the actor held; here the instance
            # is dropped instead (calls still running keep their own
            # reference until they return).
            state.instance = None

    def _actor_init(self, state: _ActorState) -> None:
        cls = serialization.deserialize(state.spec.cls_blob)
        args, kwargs = serialization.deserialize(state.spec.args_blob)
        args = self._replace_refs(args)
        kwargs = self._replace_refs(kwargs)
        state.instance = cls(*args, **kwargs)
        # Async actor: any coroutine method => dedicated event loop thread.
        if any(
            inspect.iscoroutinefunction(getattr(type(state.instance), m, None))
            for m in dir(type(state.instance))
            if not m.startswith("__")
        ):
            state.loop = asyncio.new_event_loop()
            self._start_thread(state.loop.run_forever, (), "actor-loop")

    def _execute_actor_task(self, state: _ActorState, spec: TaskSpec) -> None:
        return_ids = spec.return_ids()

        def run():
            try:
                set_task_context(spec.task_id, state.spec.actor_id, state.spec.resources)
                args, kwargs = self._resolve_args(spec)
                instance = state.instance
                if instance is None:  # the actor ended while this call queued
                    raise ActorDiedError(state.spec.actor_id.hex(),
                                         state.death_reason or "actor ended")
                method = getattr(instance, spec.method_name)
                with task_execution(spec, self.worker_id.hex()):
                    if inspect.iscoroutinefunction(method):
                        fut = asyncio.run_coroutine_threadsafe(method(*args, **kwargs), state.loop)
                        result = fut.result()
                    else:
                        result = method(*args, **kwargs)
                self._store_results(spec, return_ids, result)
            except (TaskError, ActorDiedError, TaskCancelledError) as e:
                self._store_error(return_ids, e)
            except BaseException as e:  # noqa: BLE001 - stored, raised at get()
                self._store_error(return_ids, TaskError(e, task_desc=f"{spec.method_name}"))
            finally:
                set_task_context(None, None, None)
                self.refs.on_task_finished(spec.arg_ref_ids)

        if state.loop is not None and inspect.iscoroutinefunction(
            getattr(state.instance, spec.method_name, None)
        ):
            # Async actor methods interleave on the loop; completion is out
            # of band.
            self._start_thread(run, (), "actor-async")
        elif state.pool is not None:
            state.pool.submit(run)
        else:
            run()

    def submit_actor_task(self, spec: TaskSpec) -> list[ObjectRef]:
        return_ids = spec.return_ids()
        for oid in return_ids:
            self.refs.add_owned(oid, local_refs=1)
        global_event_buffer().record(
            spec.task_id.hex(), spec.name, "SUBMITTED",
            worker_id=self.worker_id.hex(),
            actor_id=spec.actor_id.hex() if spec.actor_id else "",
            job_id=spec.job_id.hex())
        # The call's ref arguments stay alive until it has run (as a
        # task's do), whatever the caller drops meanwhile.
        self.refs.on_task_submitted(spec.arg_ref_ids)
        with self._lock:
            state = self._actors.get(spec.actor_id)
        if state is None or state.dead:
            reason = state.death_reason if state else "unknown actor"
            # The call never entered the mailbox: flagged never_sent.
            err = ActorDiedError(spec.actor_id.hex() if spec.actor_id else "",
                                 reason, never_sent=True)
            self._store_error(return_ids, err)
            self.refs.on_task_finished(spec.arg_ref_ids)
        else:
            state.mailbox.put(spec)
        return [ObjectRef.counted(oid, self.worker_id) for oid in return_ids]

    def kill_actor(self, actor_id: ActorID) -> None:
        with self._lock:
            state = self._actors.get(actor_id)
        if state is None:
            return
        self._mark_actor_dead(state, "killed via kill()")
        state.mailbox.put(None)

    def wait_actor_released(self, actor_id: ActorID,
                            timeout: float | None = None) -> bool:
        """Block until the actor's thread has ended: its resources are back
        in the pool and its instance is dropped. ``kill`` stays
        asynchronous; callers that hand the resources on (Serve's
        controller, the data executor's pools) wait here after it. False
        if ``timeout`` passed first (a call still running on the actor)."""
        with self._lock:
            state = self._actors.get(actor_id)
        return state is None or state.ended.wait(timeout)

    def _mark_actor_dead(self, state: _ActorState, reason: str) -> None:
        state.dead = True
        state.death_reason = reason
        with self._lock:
            if state.spec.name:
                self._named_actors.pop((state.spec.namespace, state.spec.name), None)
        # Fail everything still queued. Queued-but-unstarted calls are
        # never_sent: they provably did not execute on the dead actor.
        try:
            while True:
                item = state.mailbox.get_nowait()
                if item is not None:
                    self._store_error(
                        item.return_ids(),
                        ActorDiedError(state.spec.actor_id.hex(), reason,
                                       never_sent=True)
                    )
                    self.refs.on_task_finished(item.arg_ref_ids)
        except queue.Empty:
            pass

    def get_named_actor(self, name: str, namespace: str = "default") -> ActorID | None:
        with self._lock:
            return self._named_actors.get((namespace, name))

    # ------------------------------------------------------------------ KV
    def kv_put(self, key: str, value: bytes, ns: str = "default",
               overwrite: bool = True) -> bool:
        with self._lock:
            table = self._kv.setdefault(ns, {})
            if not overwrite and key in table:
                return False
            table[key] = value
            return True

    def kv_get(self, key: str, ns: str = "default") -> bytes | None:
        with self._lock:
            return self._kv.get(ns, {}).get(key)

    def kv_del(self, key: str, ns: str = "default") -> None:
        with self._lock:
            self._kv.get(ns, {}).pop(key, None)

    def kv_keys(self, prefix: str = "", ns: str = "default") -> list[str]:
        with self._lock:
            return [k for k in self._kv.get(ns, {}) if k.startswith(prefix)]

    # ------------------------------------------------------------------ misc
    def cluster_resources(self) -> dict[str, float]:
        return self.resources.totals()

    def available_resources(self) -> dict[str, float]:
        return self.resources.available()

    def shutdown(self, timeout: float = SHUTDOWN_JOIN_S) -> list[str]:
        """Stop the runtime and join its threads within ``timeout`` s in
        all. Returns the names of threads still running then (user code
        that blocks outside the runtime's waits: they are daemon threads
        and are left to end on their own)."""
        if self._shutdown:
            return []
        self._shutdown = True
        with self._lock:
            actors = list(self._actors.values())
        deadline = time.monotonic() + timeout
        for st in actors:
            if st.loop is not None and st.loop.is_running():
                cancel = asyncio.run_coroutine_threadsafe(_cancel_all_tasks(),
                                                          st.loop)
                with contextlib.suppress(Exception):
                    cancel.result(max(0.0, deadline - time.monotonic()))
            st.mailbox.put(None)
        self.resources.close()
        self.store.close()
        with self._wait_cond:
            self._wait_cond.notify_all()
        self._task_pool.shutdown(wait=False, cancel_futures=True)
        me = threading.current_thread()

        def ours():
            return [t for t in threading.enumerate() if t is not me
                    and t.name.startswith(self._thread_prefix)]

        live = ours()
        while live and time.monotonic() < deadline:
            for t in live:
                t.join(max(0.0, deadline - time.monotonic()))
            live = ours()  # threads started while joining too
        for st in actors:
            if st.loop is not None and not st.loop.is_running():
                st.loop.close()
        serialization.clear_local_objects()
        return [t.name for t in live]
