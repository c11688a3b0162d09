"""The node daemon: one per node, owner of its workers and its arena.

Port of ray_tpu/core/cluster/node_daemon.py (the raylet's part): the
daemon creates the node's shared-memory arena (``core/shm_store.py``;
where the native store does not build, the daemon raises: there is no
RPC-only mode), registers with the head over a connection it keeps open,
beats every ``health_check_period_s``, and runs the worker pool.

- **Workers** are fresh interpreters, ``python -m
  ray_tpu_torch.core.cluster.worker_main``, never a fork of a process that
  may hold CUDA. Each gets ``PYTHONPATH`` (this checkout first, then the
  daemon's own import path) and the cards its lease holds first in
  ``CUDA_VISIBLE_DEVICES`` (``accelerators/gpu.py``; none: it sees no
  card), and writes its output to a log file
  under the config's ``temp_dir``. A worker registers back over a
  connection it keeps open; when that closes, or the process exits, the
  daemon reaps it and tells the head (``worker_died``). A worker whose
  daemon goes exits too.
- **Leases.** ``lease_worker`` hands out an idle worker started for the
  same cards, or starts one. A returned task worker goes back to the
  pool and is reaped after ``worker_idle_ttl_s`` idle; an actor's worker
  (``dedicated``) is never reused: it is killed and reaped before the
  return is answered. ``kill_worker`` SIGKILLs one (force-cancel,
  ``kill``).
- **Objects.** Other nodes read this node's arena through
  ``get_object_chunk``; owners free objects here with ``free_objects``.

``stop`` kills every worker and waits for each, closes the head
connection and destroys the arena. Out: the native transfer plane, the
prestart pool, memory monitors, runtime envs and the log streaming to
the driver.
"""

from __future__ import annotations

import asyncio
import math
import os
import signal
import subprocess
import sys
import time
import uuid
from dataclasses import dataclass, field

from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager
from ray_tpu_torch.core.cluster.protocol import (AsyncRpcClient, RpcServer,
                                                 spawn)
from ray_tpu_torch.utils.config import get_config

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
CHUNK = 8 << 20


@dataclass
class _Worker:
    worker_id: str
    proc: subprocess.Popen
    gpu_ids: tuple
    log_path: str
    addr: tuple | None = None
    conn: object = None
    ready: asyncio.Future | None = None
    lease_id: str | None = None
    dedicated: bool = False
    idle_since: float = field(default_factory=time.monotonic)


def worker_pythonpath() -> str:
    """This checkout, then every directory on this process's import path
    (a test's own directory included), then the caller's PYTHONPATH."""
    parts = [_REPO_ROOT]
    for p in sys.path:
        if p and os.path.isdir(p) and p not in parts:
            parts.append(os.path.abspath(p))
    old = os.environ.get("PYTHONPATH")
    if old:
        parts.append(old)
    return os.pathsep.join(parts)


class NodeDaemon:
    def __init__(self, head_host: str, head_port: int, node_id: str,
                 resources: dict[str, float],
                 labels: dict[str, str] | None = None,
                 host: str = "127.0.0.1", gpu_ids: list[str] | None = None):
        self.head_addr = (head_host, int(head_port))
        self.node_id = node_id
        self.resources = dict(resources)
        self.labels = dict(labels or {})
        self.rpc = RpcServer(self, host, 0)
        ngpu = int(math.ceil(self.resources.get("GPU", 0.0)))
        if gpu_ids is None:
            seen = GpuAcceleratorManager().visible_ids()
            gpu_ids = seen[:ngpu] if len(seen) >= ngpu else \
                [str(i) for i in range(ngpu)]
        self.gpu_ids: list[str] = list(gpu_ids)[:ngpu]
        self.free_gpus: list[str] = list(self.gpu_ids)
        self.workers: dict[str, _Worker] = {}
        self._unregistered: list[_Worker] = []
        self.shm = None
        self.shm_name = f"rtpt-{os.getpid()}-{uuid.uuid4().hex[:10]}"
        self.head: AsyncRpcClient | None = None
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        self._env = dict(os.environ)
        self._env["PYTHONPATH"] = worker_pythonpath()

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        from ray_tpu_torch.core.shm_store import SharedMemoryStore

        self.shm = SharedMemoryStore(self.shm_name,
                                     get_config().object_store_memory_bytes)
        await self.rpc.start()
        self.head = await AsyncRpcClient(*self.head_addr).connect()
        await self.head.call(
            "register_node", node_id=self.node_id, addr=self.rpc.address,
            resources=self.resources, labels=self.labels,
            shm_name=self.shm_name)
        self._tasks = [spawn(self._beat()),
                       spawn(self._reap())]

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        procs = [w.proc for w in [*self.workers.values(),
                                  *self._unregistered]]
        for p in procs:
            if p.poll() is None:
                p.kill()
        loop = asyncio.get_running_loop()
        for p in procs:
            try:
                await loop.run_in_executor(None, p.wait, 10)
            except subprocess.TimeoutExpired:
                pass
        self.workers.clear()
        self._unregistered.clear()
        if self.head is not None:
            await self.head.close()
        await self.rpc.stop()
        if self.shm is not None:
            self.shm.destroy()

    async def _beat(self) -> None:
        period = get_config().health_check_period_s
        while not self._stopped:
            if self.head.closed:
                return
            self.head.notify("heartbeat", node_id=self.node_id)
            await asyncio.sleep(period)

    async def _reap(self) -> None:
        """Notice exited workers and reap idle ones past their TTL."""
        cfg = get_config()
        while not self._stopped:
            await asyncio.sleep(0.1)
            now = time.monotonic()
            for w in list(self.workers.values()) + list(self._unregistered):
                if w.proc.poll() is not None:
                    await self._worker_gone(w, f"worker process exited with "
                                               f"code {w.proc.returncode}")
                elif (w.lease_id is None and w.addr is not None
                      and now - w.idle_since > cfg.worker_idle_ttl_s):
                    w.proc.kill()

    async def _worker_gone(self, w: _Worker, reason: str) -> None:
        known = self.workers.pop(w.worker_id, None) is not None
        if w in self._unregistered:
            self._unregistered.remove(w)
        if w.proc.poll() is None:
            w.proc.kill()
        if w.ready is not None and not w.ready.done():
            w.ready.set_exception(RuntimeError(
                f"worker died before it registered ({reason}); its log: "
                f"{w.log_path}"))
        self.free_gpus.extend(g for g in w.gpu_ids if g not in self.free_gpus)
        w.gpu_ids = ()
        if known and self.head is not None and not self.head.closed:
            try:
                await self.head.call("worker_died", node_id=self.node_id,
                                     worker_id=w.worker_id, reason=reason)
            except Exception:  # noqa: BLE001 - the head is gone
                pass

    # -- workers -----------------------------------------------------------
    def _spawn(self, gpu_ids: tuple) -> _Worker:
        wid = uuid.uuid4().hex
        logs = os.path.join(get_config().temp_dir, "logs")
        os.makedirs(logs, exist_ok=True)
        log_path = os.path.join(logs, f"worker-{wid[:12]}.log")
        env = dict(self._env)
        env.update(GpuAcceleratorManager.set_visible_accelerator_ids(
            list(gpu_ids), self.gpu_ids))
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.cluster.worker_main",
               "--daemon", f"{self.rpc.host}:{self.rpc.port}",
               "--head", f"{self.head_addr[0]}:{self.head_addr[1]}",
               "--node-id", self.node_id, "--worker-id", wid,
               "--shm", self.shm_name]
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    stdin=subprocess.DEVNULL,
                                    start_new_session=True)
        w = _Worker(wid, proc, gpu_ids, log_path)
        w.ready = asyncio.get_running_loop().create_future()
        self._unregistered.append(w)
        return w

    def _handle_register_worker(self, conn, worker_id: str, addr,
                                pid: int) -> dict:
        w = next((x for x in self._unregistered if x.worker_id == worker_id),
                 None)
        if w is None:
            raise ValueError(f"unknown worker {worker_id}")
        self._unregistered.remove(w)
        w.addr, w.conn = tuple(addr), conn
        self.workers[worker_id] = w
        conn.on_close.append(lambda _c: self._worker_gone(
            w, "its connection to the node closed"))
        if not w.ready.done():
            w.ready.set_result(True)
        return {"node_id": self.node_id}

    async def _handle_lease_worker(self, conn, lease_id: str,
                                   resources: dict,
                                   dedicated: bool = False) -> dict:
        ngpu = int(math.ceil(resources.get("GPU", 0.0)))
        if ngpu > len(self.free_gpus):
            raise RuntimeError(f"node {self.node_id[:8]} has "
                               f"{len(self.free_gpus)} free cards, {ngpu} "
                               "asked for")
        gpus = tuple(self.free_gpus[:ngpu])
        w = None
        if not dedicated:
            w = next((x for x in self.workers.values()
                      if x.lease_id is None and not x.dedicated
                      and x.gpu_ids == gpus and x.proc.poll() is None), None)
        if w is None:
            w = self._spawn(gpus)
        w.lease_id = lease_id
        w.dedicated = dedicated
        for g in gpus:
            self.free_gpus.remove(g)
        try:
            await asyncio.wait_for(asyncio.shield(w.ready),
                                   get_config().worker_start_timeout_s)
        except BaseException:
            w.proc.kill()
            raise
        return {"worker_id": w.worker_id, "addr": w.addr, "pid": w.proc.pid,
                "gpu_ids": list(gpus)}

    async def _handle_return_worker(self, conn, lease_id: str,
                                    kill: bool = False) -> None:
        w = next((x for x in self.workers.values() if x.lease_id == lease_id),
                 None)
        if w is None:
            return
        w.lease_id = None
        w.idle_since = time.monotonic()
        if kill or w.dedicated:
            w.proc.kill()
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, w.proc.wait, 10)
            except subprocess.TimeoutExpired:
                pass
            await self._worker_gone(w, "killed at its lease's return")
            return
        # The worker keeps its cards' visibility; they are free to lease
        # again (to this worker, or to a new one when it is reaped).
        self.free_gpus.extend(g for g in w.gpu_ids if g not in self.free_gpus)

    def _handle_kill_worker(self, conn, worker_id: str) -> bool:
        w = self.workers.get(worker_id)
        if w is None or w.proc.poll() is not None:
            return False
        w.proc.send_signal(signal.SIGKILL)
        return True

    def _handle_node_info(self, conn) -> dict:
        return {"node_id": self.node_id, "shm_name": self.shm_name,
                "workers": {wid: {"pid": w.proc.pid, "lease": w.lease_id,
                                  "gpu_ids": list(w.gpu_ids)}
                            for wid, w in self.workers.items()}}

    # -- objects -----------------------------------------------------------
    def _handle_get_object_chunk(self, conn, oid: bytes, offset: int):
        """(total size, bytes from ``offset``) of an arena object, or None
        when it is not here."""
        try:
            view = self.shm.get(oid)
        except KeyError:
            return None
        try:
            return len(view), bytes(view[offset:offset + CHUNK])
        finally:
            view.release()
            self.shm.release(oid)

    def _handle_free_objects(self, conn, oids: list) -> None:
        for oid in oids:
            try:
                self.shm.delete(oid)
            except Exception:  # noqa: BLE001 - pinned or gone: nothing to free
                pass

    def all_pids(self) -> list[int]:
        return [w.proc.pid for w in [*self.workers.values(),
                                     *self._unregistered]]
