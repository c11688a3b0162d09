"""Top-level public API: init/shutdown, get/put/wait, remote, actors.

Port of ray_tpu/api.py. ``init()`` with no address starts the in-process
runtime (threads as workers, full task/actor/object semantics);
``init(address=...)`` connects to a cluster whose tasks and actors run in
worker processes (``core/cluster/``): ``"local-cluster"`` starts a head
and one node in this process, ``"host:port"`` attaches to a head that
``python -m ray_tpu_torch start --head`` runs, and ``"auto"`` reads that
address from the file ``start`` wrote. ``"client://"`` (``util/client``)
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Sequence

from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.utils.ids import JobID, NodeID


def init(
    address: str | None = None,
    *,
    num_cpus: float | None = None,
    resources: dict[str, float] | None = None,
    ignore_reinit_error: bool = True,
) -> None:
    """Start the in-process runtime with ``num_cpus`` CPUs (default 8) and
    the given custom ``resources`` (``{"GPU": n}`` for tasks and actors
    that ask for ``num_gpus``), or connect to a cluster at ``address``
    (``"local-cluster"`` takes the same ``num_cpus`` and ``resources`` for
    its one node)."""
    if address is not None and address.startswith("client://"):
        raise NotImplementedError(
            f"init(address={address!r}): the remote-driver client "
            "(util/client) is not ported (ROADMAP Queue A item 7(b))")
    if global_worker.connected:
        if ignore_reinit_error:
            return
        raise RayTpuError("already initialized; call shutdown() first")
    global_worker.job_id = JobID.from_random()
    if address is None:
        from ray_tpu_torch.core.local_runtime import LocalRuntime

        cpus = num_cpus if num_cpus is not None else 8
        global_worker.runtime = LocalRuntime(num_cpus=cpus,
                                             resources=resources)
        global_worker.node_id = NodeID.from_random()
        global_worker.mode = "local"
    else:
        from ray_tpu_torch.core.cluster.client import connect_cluster

        global_worker.runtime = connect_cluster(address, num_cpus=num_cpus,
                                                resources=resources)
        global_worker.node_id = NodeID.from_random()
        global_worker.mode = "cluster"
    global_worker.worker_id = global_worker.runtime.worker_id


def is_initialized() -> bool:
    return global_worker.connected


def shutdown() -> None:
    """Stop the runtime: its threads are joined (LocalRuntime.shutdown)."""
    if global_worker.runtime is not None:
        global_worker.runtime.shutdown()
    global_worker.runtime = None
    global_worker.mode = None


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return global_worker.put(value)


def get(refs: ObjectRef | Sequence[ObjectRef], *, timeout: float | None = None):
    single = isinstance(refs, ObjectRef)
    try:
        ref_list = [refs] if single else list(refs)
    except TypeError:
        raise TypeError(
            f"get() expects an ObjectRef or a sequence of ObjectRefs, got {type(refs).__name__}"
        ) from None
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = global_worker.get(ref_list, timeout=timeout)
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    global_worker.check_connected()
    if num_returns > len(refs):
        raise ValueError("num_returns cannot exceed the number of refs")
    return global_worker.runtime.wait(
        list(refs), num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """Kill an actor. ``no_restart=False`` (a cluster) kills its worker
    process and lets the actor restart within its ``max_restarts``."""
    global_worker.check_connected()
    if not no_restart:
        if global_worker.mode != "cluster":
            raise NotImplementedError(
                "kill(no_restart=False): the in-process runtime restarts "
                "an actor only when its __init__ fails (max_restarts); a "
                "cluster (init(address=...)) restarts a killed one")
        global_worker.runtime.kill_actor(actor.actor_id, no_restart=False)
        return
    global_worker.runtime.kill_actor(actor.actor_id)


def wait_released(actor: ActorHandle, timeout: float | None = 30.0) -> bool:
    """Wait until a killed actor's thread has ended: its resources are back
    and its instance is dropped (``kill`` itself returns at once). False if
    ``timeout`` passed first."""
    global_worker.check_connected()
    return global_worker.runtime.wait_actor_released(actor.actor_id, timeout)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel a task: it then raises TaskCancelledError at get. A queued
    task never runs. On a cluster a running task is interrupted in its
    worker, and ``force=True`` kills the worker process; the in-process
    runtime's started tasks run on, and it refuses ``force``."""
    global_worker.check_connected()
    if global_worker.mode == "cluster":
        global_worker.runtime.cancel(ref, force=force)
        return
    if force:
        raise NotImplementedError(
            "cancel(force=True) kills the worker running the task; the "
            "in-process runtime's workers are threads, which cannot be "
            "killed (init(address=...) runs tasks in worker processes)")
    global_worker.runtime.cancel(ref)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    global_worker.check_connected()
    actor_id = global_worker.runtime.get_named_actor(name, namespace)
    if actor_id is None:
        raise ValueError(f"no actor named {name!r} in namespace {namespace!r}")
    return ActorHandle(actor_id)


def cluster_resources() -> dict[str, float]:
    global_worker.check_connected()
    return global_worker.runtime.cluster_resources()


def available_resources() -> dict[str, float]:
    global_worker.check_connected()
    return global_worker.runtime.available_resources()
