"""The head: the cluster's control plane.

Port of ray_tpu/core/cluster/head.py (the GCS's part): node registration
and liveness, resource accounting and worker leases, the actor table
(named actors, restarts), the KV (which also holds exported function
definitions, ``fn_registry.FN_NS``) and the table of object owners'
addresses.

- **Nodes.** A node daemon registers over a connection it keeps open and
  sends a heartbeat every ``health_check_period_s``. The node is dead when
  that connection closes or after ``health_check_failure_threshold``
  missed beats; its leases are dropped and its actors restarted elsewhere
  (or declared dead).
- **Leases.** ``request_lease(resources)`` debits a node that fits the
  demand now (the caller's node first), asks its daemon for a worker and
  returns the worker's address; a demand that fits some node but none now
  waits, FIFO, until a lease returns; one no node could ever hold raises
  ``ValueError`` at once, as the in-process runtime does. A returned
  lease is credited once its daemon has the worker back (a killed one
  reaped), so no later grant finds its cards still held.
- **Actors.** ``create_actor`` registers the actor (a taken name raises)
  and schedules it on a dedicated lease; ``actor_info`` waits while it is
  pending or restarting. A worker that dies restarts its actor while
  ``max_restarts`` allows (-1: always); ``kill_actor`` kills the process
  and, with ``no_restart=False``, restarts it under the same budget.

Out (each absent, ROADMAP Queue A item 7(b)): persistence, the WAL and
head fault tolerance; telemetry, watchdogs and the goodput rule;
placement groups and scheduling strategies; gossip, relays and locality
leases; profiling RPCs and chaos.
"""

from __future__ import annotations

import asyncio
import itertools
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.core.cluster.protocol import (AsyncRpcClient, RpcServer,
                                                 spawn)
from ray_tpu_torch.utils.config import get_config

PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


def _fits(avail: dict, demand: dict) -> bool:
    return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in demand.items())


@dataclass
class _Node:
    node_id: str
    addr: tuple
    total: dict
    avail: dict
    labels: dict
    shm_name: str | None
    conn: Any = None
    client: AsyncRpcClient | None = None
    alive: bool = True
    last_beat: float = field(default_factory=time.monotonic)

    def info(self) -> dict:
        return {"node_id": self.node_id, "addr": self.addr,
                "alive": self.alive, "resources": dict(self.total),
                "available": dict(self.avail), "labels": dict(self.labels),
                "shm_name": self.shm_name}


@dataclass
class _Lease:
    lease_id: str
    node_id: str
    resources: dict
    worker_id: str


@dataclass
class _Actor:
    actor_id: str
    spec: dict
    resources: dict
    max_restarts: int
    name: str | None
    namespace: str
    state: str = PENDING
    addr: tuple | None = None
    worker_id: str | None = None
    node_id: str | None = None
    pid: int | None = None
    lease_id: str | None = None
    num_restarts: int = 0
    incarnation: int = 0
    death_reason: str = ""
    changed: asyncio.Event = field(default_factory=asyncio.Event)

    def info(self) -> dict:
        return {"actor_id": self.actor_id, "state": self.state,
                "addr": self.addr, "worker_id": self.worker_id,
                "node_id": self.node_id, "pid": self.pid,
                "num_restarts": self.num_restarts,
                "incarnation": self.incarnation,
                "death_reason": self.death_reason, "name": self.name,
                "namespace": self.namespace}


class HeadServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.rpc = RpcServer(self, host, port)
        self.nodes: dict[str, _Node] = {}
        self.owners: dict[str, tuple] = {}
        self.actors: dict[str, _Actor] = {}
        self.named: dict[tuple[str, str], str] = {}
        self.kv: dict[str, dict[str, bytes]] = {}
        self.leases: dict[str, _Lease] = {}
        self._lease_ids = itertools.count()
        self._released: asyncio.Event | None = None
        self._monitor: asyncio.Task | None = None
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._released = asyncio.Event()
        await self.rpc.start()
        self._monitor = spawn(self._health_loop())

    async def stop(self) -> None:
        self._stopped = True
        if self._monitor is not None:
            self._monitor.cancel()
        for node in self.nodes.values():
            if node.client is not None:
                await node.client.close()
        await self.rpc.stop()

    @property
    def address(self) -> str:
        return f"{self.rpc.host}:{self.rpc.port}"

    # -- nodes -------------------------------------------------------------
    async def _handle_register_node(self, conn, node_id: str, addr, resources,
                                    labels=None, shm_name=None) -> dict:
        node = _Node(node_id, tuple(addr), dict(resources), dict(resources),
                     dict(labels or {}), shm_name, conn=conn)
        node.client = await AsyncRpcClient(*node.addr).connect()
        self.nodes[node_id] = node
        conn.on_close.append(lambda _c: self._node_died(node_id,
                                                        "connection closed"))
        self._wake()
        return {"ok": True}

    def _handle_heartbeat(self, conn, node_id: str) -> None:
        node = self.nodes.get(node_id)
        if node is not None and node.alive:
            node.last_beat = time.monotonic()

    def _handle_list_nodes(self, conn) -> dict:
        return {nid: n.info() for nid, n in self.nodes.items()}

    async def _health_loop(self) -> None:
        cfg = get_config()
        while not self._stopped:
            await asyncio.sleep(cfg.health_check_period_s)
            limit = cfg.health_check_period_s * \
                cfg.health_check_failure_threshold
            now = time.monotonic()
            for nid, node in list(self.nodes.items()):
                if node.alive and now - node.last_beat > limit:
                    self._node_died(nid, "missed heartbeats")

    def _node_died(self, node_id: str, reason: str) -> None:
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return
        node.alive = False
        for lease in [l for l in self.leases.values()
                      if l.node_id == node_id]:
            self.leases.pop(lease.lease_id, None)
        for actor in self.actors.values():
            if actor.node_id == node_id and actor.state in (ALIVE, PENDING):
                self._actor_lost(actor, f"node {node_id[:8]} died: {reason}")
        if node.client is not None:
            spawn(node.client.close())

    def _handle_cluster_resources(self, conn) -> dict:
        return self._sum("total")

    def _handle_available_resources(self, conn) -> dict:
        return self._sum("avail")

    def _sum(self, which: str) -> dict:
        out: dict[str, float] = {}
        for node in self.nodes.values():
            if node.alive:
                for k, v in getattr(node, which).items():
                    out[k] = out.get(k, 0.0) + v
        return out

    # -- owners ------------------------------------------------------------
    def _handle_register_owner(self, conn, worker_id: str, addr) -> None:
        self.owners[worker_id] = tuple(addr)

    def _handle_owner_addr(self, conn, worker_id: str):
        return self.owners.get(worker_id)

    # -- leases ------------------------------------------------------------
    def _wake(self) -> None:
        if self._released is not None:
            self._released.set()

    def _pick(self, demand: dict, prefer: str | None) -> _Node | None:
        order = sorted(self.nodes.values(),
                       key=lambda n: n.node_id != prefer)
        for node in order:
            if node.alive and _fits(node.avail, demand):
                return node
        return None

    def _feasible(self, demand: dict) -> None:
        if not any(n.alive and _fits(n.total, demand)
                   for n in self.nodes.values()):
            have = self._sum("total")
            raise ValueError(f"infeasible resource demand {demand} (the "
                             f"cluster's alive nodes hold {have} in all)")

    async def _lease(self, demand: dict, prefer: str | None,
                     dedicated: bool = False) -> dict:
        while True:
            self._feasible(demand)
            node = self._pick(demand, prefer)
            if node is not None:
                break
            self._released.clear()
            try:
                await asyncio.wait_for(self._released.wait(), 1.0)
            except asyncio.TimeoutError:
                pass
        for k, v in demand.items():
            node.avail[k] = node.avail.get(k, 0.0) - v
        lease_id = f"{uuid.uuid4().hex[:12]}-{next(self._lease_ids)}"
        try:
            worker = await node.client.call(
                "lease_worker", lease_id=lease_id, resources=demand,
                dedicated=dedicated)
        except BaseException:
            self._credit(node.node_id, demand)
            raise
        self.leases[lease_id] = _Lease(lease_id, node.node_id, demand,
                                       worker["worker_id"])
        return {"lease_id": lease_id, "node_id": node.node_id,
                "daemon_addr": node.addr, "shm_name": node.shm_name,
                **worker}

    def _credit(self, node_id: str, demand: dict) -> None:
        node = self.nodes.get(node_id)
        if node is not None and node.alive:
            for k, v in demand.items():
                node.avail[k] = node.avail.get(k, 0.0) + v
        self._wake()

    async def _handle_request_lease(self, conn, resources: dict,
                                    prefer_node: str | None = None) -> dict:
        lease = await self._lease(dict(resources), prefer_node)
        # A caller gone before the grant would strand the lease.
        if conn.closed:
            await self._return(lease["lease_id"], kill=False)
        return lease

    async def _return(self, lease_id: str, kill: bool) -> None:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        node = self.nodes.get(lease.node_id)
        if node is not None and node.alive:
            try:
                # Credited once the daemon has the worker back (a killed
                # one reaped): a lease granted sooner could find its
                # cards still held.
                await node.client.call("return_worker", lease_id=lease_id,
                                       kill=kill)
            except Exception:  # noqa: BLE001 - the node is going
                pass
        self._credit(lease.node_id, lease.resources)

    async def _handle_return_lease(self, conn, lease_id: str,
                                   kill: bool = False) -> None:
        await self._return(lease_id, kill)

    def _handle_worker_died(self, conn, node_id: str, worker_id: str,
                            reason: str = "") -> None:
        for lease in [l for l in self.leases.values()
                      if l.worker_id == worker_id]:
            self.leases.pop(lease.lease_id, None)
            self._credit(lease.node_id, lease.resources)
        for actor in self.actors.values():
            if actor.worker_id == worker_id and actor.state == ALIVE:
                self._actor_lost(actor, reason or "its worker died")

    def _handle_kill_worker(self, conn, node_id: str, worker_id: str):
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return False
        return node.client.call("kill_worker", worker_id=worker_id)

    # -- actors ------------------------------------------------------------
    def _set(self, actor: _Actor, state: str, reason: str = "") -> None:
        actor.state = state
        if reason:
            actor.death_reason = reason
        actor.changed.set()
        actor.changed = asyncio.Event()

    def _handle_create_actor(self, conn, actor_id: str, spec: dict,
                             resources: dict, max_restarts: int,
                             name: str | None, namespace: str) -> None:
        if name is not None:
            holder = self.named.get((namespace, name))
            if holder is not None and self.actors[holder].state != DEAD:
                raise ValueError(f"an actor named {name!r} already exists "
                                 f"in namespace {namespace!r}")
        self._feasible(resources)
        actor = _Actor(actor_id, spec, dict(resources), max_restarts, name,
                       namespace)
        self.actors[actor_id] = actor
        if name is not None:
            self.named[(namespace, name)] = actor_id
        spawn(self._schedule(actor))

    async def _schedule(self, actor: _Actor) -> None:
        while actor.state in (PENDING, RESTARTING):
            try:
                lease = await self._lease(actor.resources, None,
                                          dedicated=True)
            except Exception as e:  # noqa: BLE001 - infeasible now
                self._set(actor, DEAD, f"could not be scheduled: {e}")
                return
            if actor.state == DEAD:  # killed while it waited
                await self._return(lease["lease_id"], kill=True)
                return
            client = None
            try:
                client = await AsyncRpcClient(*lease["addr"]).connect()
                await client.call("create_actor", actor_id=actor.actor_id,
                                  **actor.spec)
            except Exception as e:  # noqa: BLE001 - __init__ raised or died
                await self._return(lease["lease_id"], kill=True)
                if actor.max_restarts < 0 or \
                        actor.num_restarts < actor.max_restarts:
                    actor.num_restarts += 1
                    continue
                self._set(actor, DEAD, f"__init__ failed: {e}")
                return
            finally:
                if client is not None:
                    await client.close()
            actor.addr = tuple(lease["addr"])
            actor.worker_id = lease["worker_id"]
            actor.node_id = lease["node_id"]
            actor.pid = lease["pid"]
            actor.lease_id = lease["lease_id"]
            actor.incarnation += 1
            if actor.state == DEAD:
                await self._return(lease["lease_id"], kill=True)
                return
            self._set(actor, ALIVE)

    def _actor_lost(self, actor: _Actor, reason: str) -> None:
        if actor.lease_id is not None:
            lease = self.leases.pop(actor.lease_id, None)
            if lease is not None:
                self._credit(lease.node_id, lease.resources)
        actor.addr = actor.worker_id = actor.lease_id = None
        if actor.max_restarts < 0 or actor.num_restarts < actor.max_restarts:
            actor.num_restarts += 1
            self._set(actor, RESTARTING)
            spawn(self._schedule(actor))
        else:
            self._set(actor, DEAD, reason)

    async def _handle_actor_info(self, conn, actor_id: str,
                                 timeout: float = 0.0) -> dict | None:
        actor = self.actors.get(actor_id)
        if actor is None:
            return None
        deadline = time.monotonic() + timeout
        while actor.state in (PENDING, RESTARTING):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                await asyncio.wait_for(actor.changed.wait(), left)
            except asyncio.TimeoutError:
                break
        return actor.info()

    async def _handle_kill_actor(self, conn, actor_id: str,
                                 no_restart: bool = True) -> None:
        actor = self.actors.get(actor_id)
        if actor is None or actor.state == DEAD:
            return
        worker, node_id = actor.worker_id, actor.node_id
        if no_restart:
            lease_id = actor.lease_id
            actor.addr = actor.worker_id = actor.lease_id = None
            self._set(actor, DEAD, "killed by kill()")
            if lease_id is not None:
                await self._return(lease_id, kill=True)
            return
        if worker is not None:
            node = self.nodes.get(node_id)
            if node is not None and node.alive:
                # The daemon sees the worker die and reports it, which
                # restarts the actor (worker_died).
                await node.client.call("kill_worker", worker_id=worker)

    def _handle_get_named_actor(self, conn, name: str,
                                namespace: str = "default") -> str | None:
        aid = self.named.get((namespace, name))
        if aid is None or self.actors[aid].state == DEAD:
            return None
        return aid

    # -- KV ----------------------------------------------------------------
    def _handle_kv_put(self, conn, key: str, value: bytes,
                       ns: str = "default", overwrite: bool = True) -> bool:
        table = self.kv.setdefault(ns, {})
        if not overwrite and key in table:
            return False
        table[key] = value
        return True

    def _handle_kv_get(self, conn, key: str, ns: str = "default"):
        return self.kv.get(ns, {}).get(key)

    def _handle_kv_del(self, conn, key: str, ns: str = "default") -> None:
        self.kv.get(ns, {}).pop(key, None)

    def _handle_kv_keys(self, conn, prefix: str = "",
                        ns: str = "default") -> list[str]:
        return [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]
