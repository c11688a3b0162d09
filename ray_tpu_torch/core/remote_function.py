"""`@remote` functions.

Port of ray_tpu/core/remote_function.py for the in-process runtime:
decorating a function yields a handle whose ``.remote(...)`` submits a task
and returns ObjectRef(s); ``.options(...)`` overrides resources,
num_returns and retries per call site. ``num_gpus`` is the counterpart of
``num_tpus``: it demands the ``"GPU"`` resource.

Out (each raises ``NotImplementedError``): ``runtime_env`` and
placement-group strategies (ROADMAP Queue A item 7(b)).
``num_returns="streaming"`` returns an ObjectRefGenerator over the task's
yields. Each task carries the submitter's tracing context
(``util.tracing.inject()``), which the worker span parents under.
"""

from __future__ import annotations

import functools
from typing import Any

from ray_tpu_torch.core.object_ref import ObjectRefGenerator
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.ids import TaskID


_DEFAULT_TASK_OPTIONS = dict(
    num_cpus=1,
    num_gpus=0,
    resources=None,
    num_returns=1,
    max_retries=3,
    retry_exceptions=False,
    scheduling_strategy=None,
    runtime_env=None,
    name=None,
)


def check_options(opts: dict[str, Any], known: dict[str, Any]) -> None:
    """Refuse an option this runtime does not know or does not honour."""
    unknown = sorted(set(opts) - set(known))
    if unknown:
        raise ValueError(f"unknown option(s) {unknown}; known: {sorted(known)}")
    if opts.get("runtime_env"):
        raise NotImplementedError(
            "runtime_env is not ported (ROADMAP Queue A item 7(b)): every "
            "worker runs in the driver's environment")
    strategy = opts.get("scheduling_strategy")
    if strategy is not None and strategy not in ("DEFAULT", "SPREAD"):
        raise NotImplementedError(
            f"scheduling strategy {strategy!r}: placement groups and node "
            "affinity are not ported (ROADMAP Queue A item 7(b))")
    n = opts.get("num_returns", 1)
    if n != "streaming" and not (isinstance(n, int) and n >= 1):
        raise ValueError(
            f"num_returns must be a positive int or 'streaming', got {n!r}")


def dep_ids(args: tuple, kwargs: dict) -> list[tuple]:
    """(object id, owner id) of each ref passed as an argument itself."""
    from ray_tpu_torch.core.object_ref import ObjectRef

    return [(a.id, a.owner_id) for a in (*args, *kwargs.values())
            if isinstance(a, ObjectRef)]


def _build_resources(opts: dict[str, Any]) -> dict[str, float]:
    res: dict[str, float] = {}
    if opts.get("num_cpus"):
        res["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    for k, v in (opts.get("resources") or {}).items():
        res[k] = float(v)
    return res


class RemoteFunction:
    def __init__(self, fn, options: dict[str, Any]):
        check_options(options, _DEFAULT_TASK_OPTIONS)
        self._fn = fn
        self._options = {**_DEFAULT_TASK_OPTIONS, **options}
        self._fn_blob: bytes | None = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called directly; "
            f"use {self._fn.__name__}.remote(...)"
        )

    def options(self, **overrides) -> "RemoteFunction":
        # Share the serialized definition: an options() copy that only
        # changes resources must not re-pickle it.
        new = RemoteFunction(self._fn, {**self._options, **overrides})
        new._fn_blob = self._fn_blob
        return new

    def remote(self, *args, **kwargs):
        worker = global_worker
        worker.check_connected()
        if self._fn_blob is None:
            self._fn_blob = serialization.serialize(self._fn)
        opts = self._options
        args_blob, arg_refs = serialization.serialize_args((args, kwargs))
        spec = TaskSpec(
            task_id=TaskID.of(worker.job_id),
            job_id=worker.job_id,
            fn_blob=self._fn_blob,
            args_blob=args_blob,
            arg_ref_ids=[r.id for r in arg_refs],
            dep_ids=dep_ids(args, kwargs),
            num_returns=opts["num_returns"],
            resources=_build_resources(opts),
            max_retries=opts["max_retries"],
            retry_exceptions=bool(opts["retry_exceptions"]),
            name=opts["name"] or self._fn.__name__,
            trace_ctx=tracing.inject(),
        )
        refs = worker.runtime.submit_task(spec)
        if opts["num_returns"] == "streaming":
            return ObjectRefGenerator(spec.task_id, worker.worker_id,
                                      end_ref=refs[0])
        if opts["num_returns"] == 1:
            return refs[0]
        return refs


def remote(*args, **kwargs):
    """`@remote` / `@remote(num_cpus=2, ...)` for functions and classes."""
    from ray_tpu_torch.core.actor import ActorClass

    def decorate(target, options):
        if isinstance(target, type):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return decorate(args[0], {})
    if args:
        raise TypeError("remote() takes keyword options only, e.g. @remote(num_cpus=2)")

    def wrapper(target):
        return decorate(target, kwargs)

    return wrapper
