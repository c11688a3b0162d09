"""In-process multi-node test cluster.

Port of ray_tpu/cluster_utils.py: the head and node daemons run on this
process's io loop while every worker is a real process, so scheduling,
spillback and failures cross true process boundaries. Out: the head's
chaos (restart, kill, revive, partitions), which needs head fault
tolerance (ROADMAP Queue A item 7(b)).
"""

from __future__ import annotations

import signal
import uuid

from ray_tpu_torch.core.cluster.client import (connect_node, start_head,
                                               start_node)
from ray_tpu_torch.core.cluster.node_daemon import NodeDaemon
from ray_tpu_torch.core.cluster.protocol import EventLoopThread
from ray_tpu_torch.core.cluster.runtime import ClusterRuntime


class Cluster:
    def __init__(self):
        self._io = EventLoopThread.get()
        self.head = start_head()
        self.nodes: list[NodeDaemon] = []

    @property
    def address(self) -> str:
        return f"{self.head.rpc.host}:{self.head.rpc.port}"

    def add_node(self, num_cpus: float = 1, resources: dict | None = None,
                 labels: dict | None = None,
                 node_id: str | None = None) -> NodeDaemon:
        totals = {"CPU": float(num_cpus)}
        totals.update(resources or {})
        daemon = start_node(self.head.rpc.host, self.head.rpc.port, totals,
                            labels, node_id or uuid.uuid4().hex)
        self.nodes.append(daemon)
        return daemon

    def remove_node(self, daemon: NodeDaemon, graceful: bool = True) -> None:
        """Stop a node: its workers die with it."""
        self._io.run(daemon.stop(), 60)
        if daemon in self.nodes:
            self.nodes.remove(daemon)

    def kill_workers(self, node: NodeDaemon | None = None) -> int:
        """SIGKILL every worker process on a node (all nodes by default);
        returns how many were killed."""
        n = 0
        for d in ([node] if node else list(self.nodes)):
            for w in list(d.workers.values()) + list(d._unregistered):
                if w.proc.poll() is None:
                    w.proc.send_signal(signal.SIGKILL)
                    n += 1
        return n

    def worker_pids(self) -> list[int]:
        return [pid for d in self.nodes for pid in d.all_pids()]

    def connect(self, node: NodeDaemon | None = None) -> ClusterRuntime:
        target = node or (self.nodes[0] if self.nodes else None)
        return connect_node(self.head.rpc.host, self.head.rpc.port, target)

    def shutdown(self) -> None:
        for d in list(self.nodes):
            try:
                self._io.run(d.stop(), 60)
            except Exception:  # noqa: BLE001 - already stopped
                pass
        self.nodes.clear()
        try:
            self._io.run(self.head.stop(), 30)
        except Exception:  # noqa: BLE001 - already stopped
            pass
