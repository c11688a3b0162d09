"""Per-process worker singleton: the façade all API calls go through.

Port of ray_tpu/core/worker.py: holds the in-process runtime, the
job/worker identity, and the thread-local task context that
``get_runtime_context`` reads.
"""

from __future__ import annotations

import threading
from typing import Any

from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.utils.ids import ActorID, JobID, NodeID, TaskID, WorkerID


class RuntimeContext:
    """What `get_runtime_context()` exposes inside tasks/actors."""

    def __init__(self, worker: "Worker"):
        self._worker = worker

    @property
    def job_id(self) -> JobID:
        return self._worker.job_id

    @property
    def node_id(self) -> NodeID:
        return self._worker.node_id

    @property
    def worker_id(self) -> WorkerID:
        return self._worker.worker_id

    def get_actor_id(self) -> str | None:
        aid = getattr(_task_context, "actor_id", None)
        return aid.hex() if aid else None

    def get_task_id(self) -> str | None:
        tid = getattr(_task_context, "task_id", None)
        return tid.hex() if tid else None

    def get_assigned_resources(self) -> dict[str, float]:
        return getattr(_task_context, "resources", {}) or {}


_task_context = threading.local()


def set_task_context(task_id: TaskID | None, actor_id: ActorID | None, resources: dict | None):
    _task_context.task_id = task_id
    _task_context.actor_id = actor_id
    _task_context.resources = resources


class Worker:
    def __init__(self):
        self.runtime = None  # the LocalRuntime
        self.job_id = JobID.nil()
        self.worker_id = WorkerID.nil()
        self.node_id = NodeID.nil()
        self.mode: str | None = None  # "local" | None

    @property
    def connected(self) -> bool:
        return self.runtime is not None

    def check_connected(self):
        if self.runtime is None:
            import ray_tpu_torch

            ray_tpu_torch.init()

    # thin delegation -------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        self.check_connected()
        return self.runtime.put(value)

    def get(self, refs: list[ObjectRef], timeout: float | None = None) -> list[Any]:
        self.check_connected()
        return self.runtime.get(refs, timeout=timeout)


global_worker = Worker()


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(global_worker)
