"""Collective communication API.

Port of ray_tpu/collective/collective.py with its host backend only:
``init_collective_group(world_size, rank, backend="host", group_name)``,
then allreduce, allgather, reducescatter, alltoall, broadcast, reduce,
barrier, send and recv over the group's coordination actor. The ops take
numpy arrays or torch tensors (host_backend.py). A device backend
(``"nccl"``, or ray_tpu's ``"xla"``) raises ``NotImplementedError``: it is
ROADMAP Queue A item 7. Out: the per-op latency and payload metrics.
"""

from __future__ import annotations

import threading
from typing import Any

from ray_tpu_torch.collective.host_backend import HostCollectiveGroup

_HOST_BACKENDS = ("host", "cpu", "gloo")


class GroupManager:
    """Per-process registry of live collective groups."""

    def __init__(self):
        self._groups: dict[Any, Any] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(group_name: str) -> tuple:
        # Ranks are threads sharing this module, so the executing
        # train-session or task id disambiguates them.
        from ray_tpu_torch.core.worker import _task_context
        from ray_tpu_torch.train import session as train_session

        ctx = getattr(train_session._local, "ctx", None)
        if ctx is not None:
            return (group_name, f"train:{ctx.world_rank}:{ctx.restart_count}")
        tid = getattr(_task_context, "task_id", None)
        return (group_name, tid.hex() if tid else None)

    def create(self, backend: str, world_size: int, rank: int, group_name: str):
        if backend not in _HOST_BACKENDS:
            raise NotImplementedError(
                f"collective backend {backend!r}: only the host backend "
                f"({'/'.join(_HOST_BACKENDS)}) is ported; a device backend "
                "over NCCL is ROADMAP Queue A item 7")
        key = self._key(group_name)
        with self._lock:
            if key in self._groups:
                raise ValueError(f"collective group {group_name!r} already exists")
            group = HostCollectiveGroup(world_size, rank, group_name)
            self._groups[key] = group
            return group

    def get(self, group_name: str):
        with self._lock:
            g = self._groups.get(self._key(group_name))
        if g is None:
            raise ValueError(f"no collective group {group_name!r}; call init_collective_group")
        return g

    def destroy(self, group_name: str):
        with self._lock:
            g = self._groups.pop(self._key(group_name), None)
        if g is not None:
            g.destroy()


_manager = GroupManager()


def init_collective_group(world_size: int = 1, rank: int = 0,
                          backend: str = "host", group_name: str = "default"):
    """Create a named group for this rank (a train worker or a task)."""
    return _manager.create(backend, world_size, rank, group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy(group_name)


def get_group(group_name: str = "default"):
    return _manager.get(group_name)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).allreduce(tensor, op=op)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).reducescatter(tensor, op=op)


def alltoall(tensor, group_name: str = "default"):
    return _manager.get(group_name).alltoall(tensor)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank=src_rank)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).reduce(tensor, dst_rank=dst_rank, op=op)


def barrier(group_name: str = "default"):
    return _manager.get(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default"):
    return _manager.get(group_name).send(tensor, dst_rank)


def recv(tensor_shape, dtype, src_rank: int, group_name: str = "default"):
    return _manager.get(group_name).recv(tensor_shape, dtype, src_rank)
