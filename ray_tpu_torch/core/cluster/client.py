"""Driver-side cluster bootstrap.

Port of ray_tpu/core/cluster/client.py: ``address="local-cluster"`` starts
a head and one node daemon on this process's io loop (the daemon's
workers are real processes) and connects to them; ``"host:port"``
attaches to a running head (``python -m ray_tpu_torch start``) and
adopts its first alive node as the one it leases from and whose arena it
attaches to; ``"auto"`` reads that address from the file ``start``
writes (``scripts/start.py``).
"""

from __future__ import annotations

import uuid

from ray_tpu_torch.core.cluster.head import HeadServer
from ray_tpu_torch.core.cluster.node_daemon import NodeDaemon
from ray_tpu_torch.core.cluster.protocol import EventLoopThread, RpcClient
from ray_tpu_torch.core.cluster.runtime import ClusterRuntime


def start_head(host: str = "127.0.0.1", port: int = 0) -> HeadServer:
    head = HeadServer(host, port)
    EventLoopThread.get().run(head.start(), 30)
    return head


def start_node(head_host: str, head_port: int, resources: dict[str, float],
               labels: dict[str, str] | None = None,
               node_id: str | None = None) -> NodeDaemon:
    daemon = NodeDaemon(head_host, head_port, node_id or uuid.uuid4().hex,
                        resources, labels)
    EventLoopThread.get().run(daemon.start(), 60)
    return daemon


def connect_node(head_host: str, head_port: int,
                 daemon: NodeDaemon | None) -> ClusterRuntime:
    return ClusterRuntime(
        head_host, head_port,
        daemon.node_id if daemon else None,
        daemon.rpc.address if daemon else None,
        daemon.shm_name if daemon else None)


def connect_cluster(address: str, num_cpus: float | None = None,
                    resources: dict[str, float] | None = None
                    ) -> ClusterRuntime:
    if address == "local-cluster":
        totals = {"CPU": float(num_cpus if num_cpus is not None else 8)}
        totals.update(resources or {})
        head = start_head()
        daemon = start_node(head.rpc.host, head.rpc.port, totals)
        rt = connect_node(head.rpc.host, head.rpc.port, daemon)
        _own(rt, head, [daemon])
        return rt
    if address == "auto":
        from ray_tpu_torch.scripts.start import read_address

        address = read_address()
    host, port = address.rsplit(":", 1)
    probe = RpcClient(host, int(port))
    try:
        nodes = probe.call("list_nodes", _timeout=30)
    finally:
        probe.close()
    node = next((n for n in nodes.values() if n["alive"]), None)
    return ClusterRuntime(host, int(port),
                          node["node_id"] if node else None,
                          tuple(node["addr"]) if node else None,
                          node["shm_name"] if node else None)


def _own(rt: ClusterRuntime, head: HeadServer, daemons: list) -> None:
    """The runtime's shutdown stops the head and daemons it started."""
    io = EventLoopThread.get()
    inner = rt.shutdown

    def shutdown():
        inner()
        for d in daemons:
            try:
                io.run(d.stop(), 60)
            except Exception:  # noqa: BLE001 - already stopped
                pass
        try:
            io.run(head.stop(), 30)
        except Exception:  # noqa: BLE001 - already stopped
            pass

    rt.shutdown = shutdown
    rt.local_cluster = (head, daemons)
