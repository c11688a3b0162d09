"""ClusterRuntime: a driver's or worker's view of the cluster.

Port of ray_tpu/core/cluster/runtime.py (the core worker's part). Every
process that submits work runs one: the driver, and each worker (for
nested tasks). It has the in-process runtime's surface (``put``, ``get``,
``wait``, ``submit_task``, actors, ``cancel``, the KV), so the public API
and ``ObjectRefGenerator`` run on either.

- **Ownership.** The submitter owns what a task returns and what it
  ``put``s: the value sits in its ``store`` (``core/store.py``) when it
  is small (``inline_object_max_bytes``), else in the node's shared-memory
  arena, and the store keeps a location record for it (``S``). A process
  that receives a ref it does not own asks the owner
  (``get_object``, the owner's address from the head). Every live ref and
  every pending task that takes one holds a count
  (``ReferenceCounter``); at zero the owner frees the value, in the arena
  too. A value that holds refs this process owns pins them for the
  process's life (the borrower protocol is out).
- **Tasks.** A task waits for the refs passed to it as arguments, then
  for a lease (the head's ``request_lease`` for its resource shape),
  and is pushed to the leased worker with those values (or their arena
  locations) attached. A lease is kept while work of its shape is queued
  and returned after ``lease_keepalive_s`` idle. A worker that dies
  mid-task is retried on a new lease while ``max_retries`` allows;
  ``retry_exceptions`` retries a task that raised.
- **Lineage.** A task return that lived only in an arena and is lost
  (the arena entry gone, its node dead) is made again by running its
  task again; a ``put`` object has no lineage and raises
  ObjectLostError.
- **Actors.** Calls from one caller reach the actor in submission
  order over one connection. Calls in flight when its process dies raise
  ActorDiedError; later ones wait while the head restarts it
  (``max_restarts``) and raise once it is dead.
- **Cancel.** A queued task never runs; a running one is interrupted in
  its worker (TaskCancelledError raised in the executing thread), or with
  ``force=True`` its worker process is killed.
- **Streams.** A streaming task's worker pushes each yield back as a
  note on the task's connection.

Out (ROADMAP Queue A item 7(b)): the native transfer plane (objects
between two nodes go through the holder daemon's RPC chunks),
placement groups and scheduling strategies, runtime envs, telemetry,
profiling and chaos RPCs, DAG channels, and head fault tolerance.
"""

from __future__ import annotations

import asyncio
import pickle
import threading
import time
from collections import deque
from typing import Any

from ray_tpu_torch.core import fn_registry
from ray_tpu_torch.core.cluster.protocol import (AsyncRpcClient,
                                                 EventLoopThread, RpcClient,
                                                 RpcServer, spawn)
from ray_tpu_torch.core.exceptions import (ActorDiedError, GetTimeoutError,
                                           ObjectLostError,
                                           OutOfMemoryError,
                                           TaskCancelledError, TaskError)
from ray_tpu_torch.core.object_ref import STREAM_END_INDEX, ObjectRef
from ray_tpu_torch.core.store import LocalObjectStore, ReferenceCounter
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import get_config
from ray_tpu_torch.utils.ids import ObjectID, WorkerID

_TAG_SHM = b"S"
_RAISED = (TaskError, ActorDiedError, TaskCancelledError, OutOfMemoryError,
           ObjectLostError)


def shm_record(node_id: str, daemon_addr: tuple, size: int) -> bytes:
    """The store's record of a value that lives in a node's arena."""
    return _TAG_SHM + pickle.dumps((node_id, tuple(daemon_addr), size))


class WorkerCrashedError(RuntimeError):
    """The worker process running a task died (its retries used up)."""


class _Leased:
    def __init__(self, grant: dict, client: AsyncRpcClient):
        self.lease_id = grant["lease_id"]
        self.worker_id = grant["worker_id"]
        self.node_id = grant["node_id"]
        self.addr = tuple(grant["addr"])
        self.client = client
        self.item: _Item | None = None
        self.idle_since = time.monotonic()


class _DepRef:
    """An argument's ref as the submitter saw it, without a count of its
    own (the pending task holds one)."""

    __slots__ = ("id", "owner_id")

    def __init__(self, oid: ObjectID, owner_id):
        self.id = oid
        self.owner_id = owner_id

    def hex(self) -> str:
        return self.id.hex()

    def __repr__(self) -> str:
        return f"ObjectRef({self.id.hex()[:16]})"


class _Item:
    def __init__(self, spec, return_ids):
        self.spec = spec
        self.return_ids = return_ids
        self.arg_values: dict = {}
        self.cancelled = False
        self.worker: _Leased | None = None
        self.attempts = 0
        self.finished = False


class _Key:
    def __init__(self, resources: dict):
        self.resources = resources
        self.queue: deque[_Item] = deque()
        self.workers: list[_Leased] = []
        self.requesting = 0


class _ActorState:
    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self.queue: deque[_Item] = deque()
        self.client: AsyncRpcClient | None = None
        self.pumping = False
        self.dead: str | None = None
        self.inflight: dict[bytes, _Item] = {}


class _Chain:
    """Dispatches RPCs to the first of several handler objects that has
    the method (a worker's executor, then its runtime)."""

    def __init__(self, *handlers):
        self._handlers = handlers

    def __getattr__(self, name):
        for h in self._handlers:
            fn = getattr(h, name, None)
            if fn is not None:
                return fn
        raise AttributeError(name)


class ClusterRuntime:
    def __init__(self, head_host: str, head_port: int, node_id: str | None,
                 daemon_addr: tuple | None, shm_name: str | None,
                 worker_id: WorkerID | None = None,
                 server: RpcServer | None = None):
        serialization.set_by_value(True)
        self.io = EventLoopThread.get()
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id = node_id
        self.daemon_addr = tuple(daemon_addr) if daemon_addr else None
        self.head_addr = (head_host, int(head_port))
        self.head = RpcClient(head_host, head_port)
        self.shm = None
        if shm_name is not None:
            from ray_tpu_torch.core.shm_store import SharedMemoryStore

            self.shm = SharedMemoryStore(shm_name, create=False)
        self.store = LocalObjectStore()
        self._wait_cond = threading.Condition()

        def _notify():
            with self._wait_cond:
                self._wait_cond.notify_all()

        self.store.on_seal = _notify
        self.refs = ReferenceCounter(on_release=self._on_release)
        self._lock = threading.RLock()
        self._keys: dict[tuple, _Key] = {}
        self._items: dict[ObjectID, _Item] = {}  # return id -> live item
        self._lineage: dict[ObjectID, _Item] = {}
        self._recoveries: dict[ObjectID, int] = {}
        self._actors: dict[str, _ActorState] = {}
        self._exported: set[str] = set()
        self._fn_ids: dict[int, tuple[bytes, str]] = {}
        self._streams_closed: set = set()
        self._owner_addrs: dict[str, tuple] = {}
        self._peers: dict[tuple, RpcClient] = {}
        self._pinned: list[ObjectRef] = []
        self._shutdown = False
        self._own_server = server is None
        self.server = server or RpcServer(self)
        if self._own_server:
            self.io.run(self.server.start(), 30)
        self.head.call("register_owner", worker_id=self.worker_id.hex(),
                       addr=self.server.address)
        self._reaper = self.io.submit(self._lease_reaper())

    # ------------------------------------------------------------ objects
    def _cfg(self):
        return get_config()

    def _store_value(self, oid: ObjectID, value: Any) -> None:
        found: list = []
        parts = serialization.serialize_parts(value, found)
        self._pin(found)
        size = sum(len(memoryview(p).cast("B")) for p in parts)
        if self.shm is not None and size > self._cfg().inline_object_max_bytes:
            self.shm.put_parts(oid.binary(), parts)
            self.store.put(oid, shm_record(self.node_id, self.daemon_addr,
                                           size), self.worker_id)
        else:
            self.store.put(oid, b"".join(memoryview(p).cast("B")
                                         for p in parts), self.worker_id)

    def _pin(self, refs: list) -> None:
        """Refs this process owns that leave it inside a value stay
        alive for the process's life."""
        mine = [r for r in refs if r.owner_id == self.worker_id]
        if mine:
            with self._lock:
                self._pinned.extend(ObjectRef(r.id, r.owner_id)
                                    for r in mine)

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.for_put(self.worker_id)
        self.refs.add_owned(oid, local_refs=1)
        self._store_value(oid, value)
        return ObjectRef.counted(oid, self.worker_id)

    def _on_release(self, oid: ObjectID) -> None:
        rec = None
        if self.store.contains(oid):
            try:
                rec = self.store.get(oid, timeout=0)
            except Exception:  # noqa: BLE001 - raced with a delete
                rec = None
        self.store.delete(oid)
        with self._lock:
            self._lineage.pop(oid, None)
            self._recoveries.pop(oid, None)
        if rec is not None and rec[:1] == _TAG_SHM:
            self._free_shm(oid, rec)

    def _free_shm(self, oid: ObjectID, rec: bytes) -> None:
        node_id, daemon_addr, _ = pickle.loads(rec[1:])
        if node_id == self.node_id and self.shm is not None:
            try:
                self.shm.delete(oid.binary())
            except Exception:  # noqa: BLE001 - pinned by a reader or gone
                pass
        elif not self._shutdown:
            async def free():
                try:
                    c = await AsyncRpcClient(*daemon_addr).connect()
                    c.notify("free_objects", oids=[oid.binary()])
                    await c.close()
                except Exception:  # noqa: BLE001 - the node is gone
                    pass

            self.io.submit(free())

    def read_record(self, oid: ObjectID, rec) -> Any:
        """The value a store record stands for (an arena record read from
        this node's arena or pulled in chunks from the holder's daemon).
        Raises ObjectLostError when the arena copy is gone."""
        if rec[:1] != _TAG_SHM:
            return serialization.deserialize(rec)
        node_id, daemon_addr, size = pickle.loads(rec[1:])
        if node_id == self.node_id and self.shm is not None:
            try:
                view = self.shm.get(oid.binary())
            except KeyError:
                raise ObjectLostError(oid.hex(), "its arena copy is gone") \
                    from None
            try:
                return serialization.deserialize(view)
            finally:
                view.release()
                self.shm.release(oid.binary())
        return serialization.deserialize(self._pull(oid, daemon_addr))

    def _pull(self, oid: ObjectID, daemon_addr: tuple) -> bytearray:
        try:
            peer = self._peer(daemon_addr)
            out = bytearray()
            total = None
            while total is None or len(out) < total:
                got = peer.call("get_object_chunk", oid=oid.binary(),
                                offset=len(out))
                if got is None:
                    break
                total, chunk = got
                out += chunk
            if total is None or len(out) < total:
                raise ObjectLostError(oid.hex(), "its arena copy is gone")
            return out
        except (ConnectionError, OSError):
            raise ObjectLostError(oid.hex(), "the node holding it is gone") \
                from None

    def _peer(self, addr: tuple) -> RpcClient:
        addr = tuple(addr)
        with self._lock:
            c = self._peers.get(addr)
            if c is not None and not c.closed:
                return c
        c = RpcClient(*addr)
        with self._lock:
            self._peers[addr] = c
        return c

    def _owner(self, ref: ObjectRef) -> RpcClient:
        hexid = ref.owner_id.hex()
        addr = self._owner_addrs.get(hexid)
        if addr is None:
            addr = self.head.call("owner_addr", worker_id=hexid)
            if addr is None:
                raise ObjectLostError(ref.hex(), "its owner is unknown")
            self._owner_addrs[hexid] = tuple(addr)
        return self._peer(addr)

    def _owns(self, ref: ObjectRef) -> bool:
        return ref.owner_id is None or ref.owner_id == self.worker_id

    def _record(self, ref: ObjectRef, deadline: float | None) -> bytes:
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        if self._owns(ref) or self.store.contains(ref.id):
            try:
                return self.store.get(ref.id, timeout=left)
            except TimeoutError:
                raise GetTimeoutError(f"get() timed out waiting for {ref}") \
                    from None
        try:
            rec = self._owner(ref).call("get_object", oid=ref.id.binary(),
                                        timeout=left)
        except (ConnectionError, OSError):
            raise ObjectLostError(ref.hex(), "its owner died") from None
        if rec is None:
            raise GetTimeoutError(f"get() timed out waiting for {ref}")
        if rec == b"lost":
            raise ObjectLostError(ref.hex(), "its owner no longer holds it")
        return rec

    def _value(self, ref: ObjectRef, deadline: float | None) -> Any:
        while True:
            rec = self._record(ref, deadline)
            try:
                return self.read_record(ref.id, rec)
            except ObjectLostError:
                if self._shutdown or not self._owns(ref) or \
                        not self._recover(ref.id):
                    raise

    def _recover(self, oid: ObjectID) -> bool:
        """Run the task that made ``oid`` again (its lineage). False when
        it has none (a ``put``) or recovery was tried too often."""
        with self._lock:
            item = self._lineage.get(oid)
            if item is None or self._recoveries.get(oid, 0) >= 3:
                return False
            if item.finished:
                self._recoveries[oid] = self._recoveries.get(oid, 0) + 1
                for rid in item.return_ids:
                    self.store.delete(rid)
                fresh = _Item(item.spec, item.return_ids)
                for rid in item.return_ids:
                    self._lineage[rid] = fresh
                self.refs.on_task_submitted(item.spec.arg_ref_ids)
                self.io.call_soon(self._admit, fresh)
        return True

    def get(self, refs: list[ObjectRef], timeout: float | None = None) -> list:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            value = self._value(ref, deadline)
            if isinstance(value, _RAISED):
                raise value
            out.append(value)
        return out

    def _ready(self, ref: ObjectRef) -> bool:
        if self.store.contains(ref.id):
            return True
        if self._owns(ref):
            return False
        try:
            return self._owner(ref).call("contains", oid=ref.id.binary())
        except Exception:  # noqa: BLE001 - owner gone: get() will say so
            return True

    def wait(self, refs, num_returns: int = 1, timeout: float | None = None,
             fetch_local: bool = True):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready, pending = [], list(refs)
        while len(ready) < num_returns and pending and not self._shutdown:
            still = []
            for r in pending:
                (ready if self._ready(r) else still).append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            with self._wait_cond:
                self._wait_cond.wait(0.01)
        return ready, pending

    # owner RPCs ------------------------------------------------------------
    async def _handle_get_object(self, conn, oid: bytes,
                                 timeout: float | None = None):
        o = ObjectID(oid)
        if not self.store.contains(o) and not self.refs.has(o):
            return b"lost"
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(
                None, lambda: self.store.get(o, timeout=timeout))
        except TimeoutError:
            return None
        except ObjectLostError:
            return b"lost"

    def _handle_contains(self, conn, oid: bytes) -> bool:
        return self.store.contains(ObjectID(oid))

    # ------------------------------------------------------------- tasks
    def _export(self, blob: bytes) -> str:
        key = id(blob)
        hit = self._fn_ids.get(key)
        if hit is not None and hit[0] is blob:
            return hit[1]
        fid = fn_registry.fn_id(blob)
        if fid not in self._exported:
            self.head.call("kv_put", key=fid, value=blob,
                           ns=fn_registry.FN_NS)
            self._exported.add(fid)
        self._fn_ids[key] = (blob, fid)
        return fid

    def submit_task(self, spec) -> list[ObjectRef]:
        return_ids = spec.return_ids()
        for oid in return_ids:
            self.refs.add_owned(oid, local_refs=1)
        self.refs.on_task_submitted(spec.arg_ref_ids)
        spec.fn_id = self._export(spec.fn_blob)
        item = _Item(spec, return_ids)
        with self._lock:
            for oid in return_ids:
                self._items[oid] = item
        self.io.call_soon(self._admit, item)
        return [ObjectRef.counted(oid, self.worker_id) for oid in return_ids]

    def _admit(self, item: _Item) -> None:
        spawn(self._resolve_then_queue(item))

    async def _dep_values(self, spec) -> dict:
        """Each ref passed as an argument: its store record, once ready."""
        loop = asyncio.get_running_loop()
        out = {}
        for oid, owner in spec.dep_ids:
            dep = _DepRef(oid, owner)
            out[oid.binary()] = await loop.run_in_executor(
                None, self._record, dep, None)
        return out

    async def _resolve_then_queue(self, item: _Item) -> None:
        try:
            item.arg_values = await self._dep_values(item.spec)
        except Exception as e:  # noqa: BLE001 - a lost or timed-out dep
            self._finish(item, [serialization.serialize(
                e if isinstance(e, _RAISED) else TaskError(e, item.spec.name))
            ] * len(item.return_ids))
            return
        if item.cancelled:
            self._cancelled(item)
            return
        key = tuple(sorted(item.spec.resources.items()))
        ks = self._keys.get(key)
        if ks is None:
            ks = self._keys[key] = _Key(dict(item.spec.resources))
        ks.queue.append(item)
        self._pump(ks)

    def _pump(self, ks: _Key) -> None:
        while ks.queue:
            idle = next((w for w in ks.workers
                         if w.item is None and not w.client.closed), None)
            if idle is None:
                break
            item = ks.queue.popleft()
            if item.cancelled:
                self._cancelled(item)
                continue
            self._dispatch(ks, idle, item)
        want = len(ks.queue) - ks.requesting
        for _ in range(max(0, want)):
            ks.requesting += 1
            spawn(self._lease(ks))

    async def _lease(self, ks: _Key) -> None:
        try:
            grant = await self.head.aclient.call(
                "request_lease", resources=ks.resources,
                prefer_node=self.node_id)
        except Exception as e:  # noqa: BLE001 - infeasible or head gone
            ks.requesting -= 1
            while ks.queue:
                item = ks.queue.popleft()
                self._finish(item, [serialization.serialize(
                    TaskError(e, item.spec.name))] * len(item.return_ids))
            return
        ks.requesting -= 1
        w = None
        try:
            holder: list = []
            client = await AsyncRpcClient(
                *grant["addr"],
                on_note=lambda m, kw: self._on_note(m, kw),
                on_close=lambda: self._worker_lost(ks, holder[0])).connect()
            w = _Leased(grant, client)
            holder.append(w)
        except Exception:  # noqa: BLE001 - the worker died at once
            await self._return_lease(grant["lease_id"], kill=True)
            if ks.queue:
                self._pump(ks)
            return
        ks.workers.append(w)
        self._pump(ks)
        if not ks.queue and w.item is None:
            w.idle_since = time.monotonic()

    def _dispatch(self, ks: _Key, w: _Leased, item: _Item) -> None:
        w.item = item
        item.worker = w
        item.attempts += 1
        spec = item.spec
        fut = w.client.send(
            "execute", task_id=spec.task_id.binary(), name=spec.name,
            fn_id=spec.fn_id, args_blob=spec.args_blob,
            arg_values=item.arg_values, num_returns=spec.num_returns,
            resources=spec.resources, job_id=spec.job_id.binary(),
            trace_ctx=spec.trace_ctx)
        fut.add_done_callback(lambda f: self._done(ks, w, item, f))

    def _done(self, ks: _Key, w: _Leased, item: _Item, fut) -> None:
        w.item = None
        w.idle_since = time.monotonic()
        exc = fut.exception()
        if isinstance(exc, ConnectionError):
            return  # the worker died: _worker_lost decides
        if exc is not None:  # the worker could not run the task at all
            self._finish(item, [serialization.serialize(TaskError(
                exc, item.spec.name))] * len(item.return_ids))
            self._pump(ks)
            return
        reply = fut.result()
        spec = item.spec
        if reply.get("app_error") and spec.retry_exceptions and \
                item.attempts <= spec.max_retries and not item.cancelled:
            ks.queue.appendleft(item)
        else:
            self._finish(item, reply["results"], w.node_id)
        self._pump(ks)

    def _worker_lost(self, ks: _Key, w: _Leased) -> None:
        if w in ks.workers:
            ks.workers.remove(w)
        item, w.item = w.item, None
        if item is not None and not item.finished:
            if item.cancelled:
                self._cancelled(item)
            elif item.attempts <= item.spec.max_retries:
                ks.queue.appendleft(item)
            else:
                self._finish(item, [serialization.serialize(TaskError(
                    WorkerCrashedError(
                        f"the worker running {item.spec.name} died"),
                    item.spec.name))] * len(item.return_ids))
        self._pump(ks)

    def _finish(self, item: _Item, results: list, node_id: str | None = None
                ) -> None:
        if item.finished:
            return
        item.finished = True
        spec = item.spec
        with self._lock:
            for oid in item.return_ids:
                self._items.pop(oid, None)
        for oid, rec in zip(item.return_ids, results):
            if rec[:1] == _TAG_SHM and spec.actor_id is None:
                with self._lock:
                    self._lineage[oid] = item
            if self.refs.has(oid):
                self.store.put(oid, rec, self.worker_id)
            elif rec[:1] == _TAG_SHM:
                self._free_shm(oid, rec)
        self.refs.on_task_finished(spec.arg_ref_ids)

    def _cancelled(self, item: _Item) -> None:
        self._finish(item, [serialization.serialize(
            TaskCancelledError(item.spec.name))] * len(item.return_ids))

    def _on_note(self, method: str, kw: dict) -> None:
        if method != "stream_item":
            return
        from ray_tpu_torch.utils.ids import TaskID

        tid = TaskID(kw["task_id"])
        oid = ObjectID.for_task_return(tid, kw["index"])
        if tid in self._streams_closed:
            if kw["rec"][:1] == _TAG_SHM:
                self._free_shm(oid, kw["rec"])
            return
        self.refs.add_owned(oid)
        self.store.put(oid, kw["rec"], self.worker_id)

    def close_stream(self, task_id, first_unread: int) -> None:
        """The consumer dropped its generator: later items are dropped as
        they come (the producer stops at its next yield), and the ones it
        never read are freed."""
        self._streams_closed.add(task_id)
        end = ObjectID.for_task_return(task_id, STREAM_END_INDEX)
        item = self._items.get(end)
        if item is not None and item.worker is not None:
            item.worker.client.notify("close_stream",
                                      task_id=task_id.binary())
        i = first_unread
        while True:
            oid = ObjectID.for_task_return(task_id, i)
            if not self.store.contains(oid):
                break
            self.refs.add_local_ref(oid)
            self.refs.remove_local_ref(oid)
            i += 1

    async def _return_lease(self, lease_id: str, kill: bool = False) -> None:
        try:
            await self.head.aclient.call("return_lease", lease_id=lease_id,
                                         kill=kill)
        except Exception:  # noqa: BLE001 - the head is gone
            pass

    async def _lease_reaper(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(0.2)
            keep = self._cfg().lease_keepalive_s
            now = time.monotonic()
            for ks in list(self._keys.values()):
                for w in list(ks.workers):
                    if w.item is None and not ks.queue and \
                            now - w.idle_since > keep:
                        ks.workers.remove(w)
                        await w.client.close()
                        await self._return_lease(w.lease_id)

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        item = self._items.get(ref.id)
        if item is None or item.finished:
            return
        item.cancelled = True
        w = item.worker
        if w is None or w.item is not item:
            return  # queued: dropped where it is picked up
        if force:
            self.head.call("kill_worker", node_id=w.node_id,
                           worker_id=w.worker_id)
        else:
            self.io.call_soon(lambda: w.client.notify(
                "cancel_task", task_id=item.spec.task_id.binary()))

    # ------------------------------------------------------------ actors
    def create_actor(self, spec) -> None:
        deps = self._resolve_sync(spec)
        self.head.call(
            "create_actor", actor_id=spec.actor_id.hex(),
            spec={"fn_id": self._export(spec.cls_blob),
                  "args_blob": spec.args_blob, "arg_values": deps,
                  "max_concurrency": spec.max_concurrency,
                  "job_id": spec.job_id.binary(),
                  "resources": spec.resources},
            resources=spec.resources, max_restarts=spec.max_restarts,
            name=spec.name, namespace=spec.namespace)

    def _resolve_sync(self, spec) -> dict:
        return {oid.binary(): self._record(_DepRef(oid, owner), None)
                for oid, owner in spec.dep_ids}

    def submit_actor_task(self, spec) -> list[ObjectRef]:
        return_ids = spec.return_ids()
        for oid in return_ids:
            self.refs.add_owned(oid, local_refs=1)
        self.refs.on_task_submitted(spec.arg_ref_ids)
        item = _Item(spec, return_ids)
        aid = spec.actor_id.hex()
        with self._lock:
            for oid in return_ids:
                self._items[oid] = item
            st = self._actors.get(aid)
            if st is None:
                st = self._actors[aid] = _ActorState(aid)
        self.io.call_soon(self._actor_enqueue, st, item)
        return [ObjectRef.counted(oid, self.worker_id) for oid in return_ids]

    def _actor_enqueue(self, st: _ActorState, item: _Item) -> None:
        st.queue.append(item)
        if not st.pumping:
            st.pumping = True
            spawn(self._actor_pump(st))

    def _actor_died(self, st: _ActorState, item: _Item, reason: str) -> None:
        self._finish(item, [serialization.serialize(ActorDiedError(
            st.actor_id, reason))] * len(item.return_ids))

    async def _actor_pump(self, st: _ActorState) -> None:
        try:
            while st.queue:
                if st.dead is not None:
                    while st.queue:
                        self._actor_died(st, st.queue.popleft(), st.dead)
                    return
                if st.client is None or st.client.closed:
                    if not await self._actor_connect(st):
                        continue
                item = st.queue[0]
                try:
                    item.arg_values = await self._dep_values(item.spec)
                except Exception as e:  # noqa: BLE001 - a lost dep
                    st.queue.popleft()
                    self._finish(item, [serialization.serialize(
                        e if isinstance(e, _RAISED)
                        else TaskError(e, item.spec.name))]
                        * len(item.return_ids))
                    continue
                if st.client.closed:
                    continue
                st.queue.popleft()
                if item.cancelled:
                    self._cancelled(item)
                    continue
                spec = item.spec
                client = st.client
                st.inflight[spec.task_id.binary()] = item
                fut = client.send(
                    "actor_call", actor_id=st.actor_id,
                    task_id=spec.task_id.binary(), method=spec.method_name,
                    args_blob=spec.args_blob, arg_values=item.arg_values,
                    num_returns=spec.num_returns, trace_ctx=spec.trace_ctx)
                fut.add_done_callback(
                    lambda f, it=item: self._actor_done(st, it, f))
        finally:
            st.pumping = False

    async def _actor_connect(self, st: _ActorState) -> bool:
        info = await self.head.aclient.call("actor_info",
                                            actor_id=st.actor_id,
                                            timeout=30.0)
        if info is None:
            st.dead = "the actor is unknown to the head"
            return False
        if info["state"] == "DEAD":
            st.dead = info["death_reason"] or "the actor is dead"
            return False
        if info["state"] != "ALIVE":
            return False
        try:
            st.client = await AsyncRpcClient(
                *info["addr"], on_note=lambda m, kw: self._on_note(m, kw),
                on_close=lambda: self._actor_conn_lost(st)).connect()
        except (ConnectionError, OSError):
            await asyncio.sleep(0.05)
            return False
        return True

    def _actor_done(self, st: _ActorState, item: _Item, fut) -> None:
        st.inflight.pop(item.spec.task_id.binary(), None)
        exc = fut.exception()
        if isinstance(exc, ConnectionError):
            self._actor_died(st, item, "its worker process died while the "
                             "call was in flight")
        elif exc is not None:  # the worker could not run the call at all
            self._finish(item, [serialization.serialize(TaskError(
                exc, item.spec.name))] * len(item.return_ids))
        else:
            self._finish(item, fut.result()["results"])

    def _actor_conn_lost(self, st: _ActorState) -> None:
        for item in list(st.inflight.values()):
            self._actor_died(st, item, "its worker process died while the "
                             "call was in flight")
        st.inflight.clear()
        if st.queue and not st.pumping:
            st.pumping = True
            spawn(self._actor_pump(st))

    def kill_actor(self, actor_id, no_restart: bool = True) -> None:
        aid = actor_id.hex()
        if no_restart:
            with self._lock:
                st = self._actors.get(aid)
                if st is None:
                    st = self._actors[aid] = _ActorState(aid)
            st.dead = "killed by kill()"
        self.head.call("kill_actor", actor_id=aid, no_restart=no_restart)

    def wait_actor_released(self, actor_id, timeout: float | None = 30.0
                            ) -> bool:
        deadline = time.monotonic() + (timeout or 0)
        while True:
            info = self.head.call("actor_info", actor_id=actor_id.hex())
            if info is None or info["state"] == "DEAD":
                return True
            if timeout is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def get_named_actor(self, name: str, namespace: str = "default"):
        from ray_tpu_torch.utils.ids import ActorID

        aid = self.head.call("get_named_actor", name=name,
                             namespace=namespace)
        return None if aid is None else ActorID.from_hex(aid)

    # ---------------------------------------------------------------- KV
    def kv_put(self, key: str, value: bytes, ns: str = "default",
               overwrite: bool = True) -> bool:
        return self.head.call("kv_put", key=key, value=value, ns=ns,
                              overwrite=overwrite)

    def kv_get(self, key: str, ns: str = "default") -> bytes | None:
        return self.head.call("kv_get", key=key, ns=ns)

    def kv_del(self, key: str, ns: str = "default") -> None:
        self.head.call("kv_del", key=key, ns=ns)

    def kv_keys(self, prefix: str = "", ns: str = "default") -> list[str]:
        return self.head.call("kv_keys", prefix=prefix, ns=ns)

    def cluster_resources(self) -> dict[str, float]:
        return self.head.call("cluster_resources")

    def available_resources(self) -> dict[str, float]:
        return self.head.call("available_resources")

    def list_nodes(self) -> dict:
        return self.head.call("list_nodes")

    # ---------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True

        async def close_all():
            for ks in self._keys.values():
                for w in ks.workers:
                    await w.client.close()
                    await self._return_lease(w.lease_id)
                ks.workers.clear()
            for st in self._actors.values():
                if st.client is not None:
                    await st.client.close()
            if self._own_server:
                await self.server.stop()

        try:
            self.io.run(close_all(), 30)
        except Exception:  # noqa: BLE001 - the head or loop is gone
            pass
        self._reaper.cancel()
        for c in list(self._peers.values()):
            c.close()
        self.head.close()
        self.store.close()
        with self._wait_cond:
            self._wait_cond.notify_all()
        if self.shm is not None:
            self.shm.close()
        serialization.set_by_value(False)
