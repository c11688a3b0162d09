"""Task/actor specifications — the unit of scheduling.

Port of ray_tpu/core/task_spec.py for the in-process runtime: a task names
a serialized function, serialized args with out-of-band ObjectRefs, a
resource-shape demand, a retry policy and the submitter's tracing context
(``trace_ctx``). Out: the cluster's scheduling
strategies, runtime envs and the function registry's content ids (the
in-process runtime places every task on its one node).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.utils.ids import ActorID, JobID, ObjectID, TaskID


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    fn_blob: bytes  # the pickled callable (empty for actor tasks)
    args_blob: bytes  # serialized (args, kwargs)
    arg_ref_ids: list[ObjectID] = field(default_factory=list)
    num_returns: int | str = 1  # int, or "streaming" (generator task)
    resources: dict[str, float] = field(default_factory=dict)
    max_retries: int = 3
    retry_exceptions: bool = False
    name: str = ""
    trace_ctx: dict[str, Any] | None = None  # propagated tracing context

    # actor-task fields
    actor_id: ActorID | None = None
    method_name: str | None = None

    def return_ids(self) -> list[ObjectID]:
        if self.num_returns == "streaming":
            # The stream-end marker is the task's one pre-declared return:
            # errors land there and the consumer's generator raises them.
            from ray_tpu_torch.core.object_ref import STREAM_END_INDEX

            return [ObjectID.for_task_return(self.task_id, STREAM_END_INDEX)]
        return [ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)]


@dataclass
class ActorCreationSpec:
    actor_id: ActorID
    job_id: JobID
    cls_blob: bytes  # the pickled class
    args_blob: bytes
    arg_ref_ids: list[ObjectID] = field(default_factory=list)
    resources: dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0  # restarts of a failed __init__
    max_concurrency: int = 1
    name: str | None = None  # named-actor registration
    namespace: str = "default"
