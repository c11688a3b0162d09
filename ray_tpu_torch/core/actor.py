"""Actor classes and handles.

Port of ray_tpu/core/actor.py: ``@remote`` on a class yields an
ActorClass; ``.remote(...)`` creates the actor and returns an ActorHandle
whose method accessors submit ordered actor tasks. Named actors,
max_restarts (of ``__init__``; on a cluster also of a worker process
that died or was killed with ``no_restart=False``), max_concurrency,
async actors and
options() per-instantiation overrides; ``num_gpus`` demands the ``"GPU"``
resource; ``method.options(num_returns="streaming")`` streams a generator
method's yields. Out: DAG ``.bind`` and the internal ``__rtpu_call_fn__`` hook
(compiled graphs, ROADMAP Queue A item 7's MPMD pipelines);
``max_task_retries`` and ``lifetime`` (a process
runtime's notions) are unknown options; ``runtime_env`` and
placement-group strategies raise as for tasks.
"""

from __future__ import annotations

import itertools
import os
from typing import Any

from ray_tpu_torch.core.object_ref import ObjectRefGenerator
from ray_tpu_torch.core.remote_function import (_build_resources,
                                                check_options, dep_ids)
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskSpec
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.ids import ActorID, TaskID


_DEFAULT_ACTOR_OPTIONS = dict(
    # Actors default to ZERO lifetime CPUs (reference: actors without an
    # explicit num_cpus use 0 while running, so any number of actors can
    # share a node and never starve task submission).
    num_cpus=0,
    num_gpus=0,
    resources=None,
    max_restarts=0,
    max_concurrency=1,
    name=None,
    namespace="default",
    scheduling_strategy=None,
    runtime_env=None,
)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, num_returns: int | str = 1):
        check_options({"num_returns": num_returns}, {"num_returns": 1})
        return ActorMethod(self._handle, self._method_name, num_returns)

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._method_name, args, kwargs, num_returns=self._num_returns
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; use .remote()"
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_names: list[str] | None = None):
        self._actor_id = actor_id
        self._method_names = method_names or []
        # Atomic under the GIL: handles are shared across threads, and a
        # racy `+= 1` would mint duplicate seq_nos (duplicate task ids and
        # colliding return object ids).
        self._seq = itertools.count(1)
        # Distinguishes task ids from different handles to the same actor.
        self._handle_nonce = os.urandom(4)

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _submit_method(self, method_name: str, args: tuple, kwargs: dict,
                       num_returns: int | str = 1):
        worker = global_worker
        worker.check_connected()
        seq_no = next(self._seq)
        args_blob, arg_refs = serialization.serialize_args((args, kwargs))
        spec = TaskSpec(
            task_id=TaskID.for_actor_task(self._actor_id, seq_no, self._handle_nonce),
            job_id=worker.job_id,
            fn_blob=b"",
            args_blob=args_blob,
            arg_ref_ids=[r.id for r in arg_refs],
            dep_ids=dep_ids(args, kwargs),
            num_returns=num_returns,
            actor_id=self._actor_id,
            method_name=method_name,
            name=f"{method_name}",
            trace_ctx=tracing.inject(),
        )
        refs = worker.runtime.submit_actor_task(spec)
        if num_returns == "streaming":
            return ObjectRefGenerator(spec.task_id, worker.worker_id,
                                      end_ref=refs[0])
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_names))

    def __repr__(self) -> str:
        return f"ActorHandle({self._actor_id.hex()[:12]})"


class ActorClass:
    def __init__(self, cls: type, options: dict[str, Any]):
        check_options(options, _DEFAULT_ACTOR_OPTIONS)
        self._cls = cls
        self._options = {**_DEFAULT_ACTOR_OPTIONS, **options}
        self._cls_blob: bytes | None = None

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote(...)"
        )

    def options(self, **overrides) -> "ActorClass":
        new = ActorClass(self._cls, {**self._options, **overrides})
        new._cls_blob = self._cls_blob
        return new

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = global_worker
        worker.check_connected()
        if self._cls_blob is None:
            self._cls_blob = serialization.serialize(self._cls)
        opts = self._options
        actor_id = ActorID.of(worker.job_id)
        args_blob, arg_refs = serialization.serialize_args((args, kwargs))
        spec = ActorCreationSpec(
            actor_id=actor_id,
            job_id=worker.job_id,
            cls_blob=self._cls_blob,
            args_blob=args_blob,
            arg_ref_ids=[r.id for r in arg_refs],
            dep_ids=dep_ids(args, kwargs),
            resources=_build_resources(opts),
            max_restarts=opts["max_restarts"],
            max_concurrency=opts["max_concurrency"],
            name=opts["name"],
            namespace=opts["namespace"],
        )
        worker.runtime.create_actor(spec)
        method_names = [m for m in dir(self._cls) if not m.startswith("_")]
        return ActorHandle(actor_id, method_names)
