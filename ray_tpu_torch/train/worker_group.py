"""Worker group: one actor per training worker.

Port of ray_tpu/train/worker_group.py for the in-process runtime: each
worker is a ``TrainWorker`` actor whose train function runs on a thread of
its own, so ``poll`` stays responsive; ``poll_status`` tells a worker that
died (its actor is gone) from one whose train function raised; a group
can be built from recycled spare actors (``SparePool``). ``_actor_options``
maps ``"GPU"`` to ``num_gpus``.

Added for the port: the train function's thread takes the worker's device
as its current CUDA device (PyTorch's current device is per thread, so the
backend's hooks, which run on the actor's threads, cannot set it for the
train function), and ``WorkerGroup.shutdown`` joins the train threads
(within ``JOIN_S``) before it kills the actors, so a failed attempt's
state is freed before the next attempt allocates its own. A failed
attempt keeps only its formatted traceback, never the exception or its
frames. Out: the ``guarded_by`` lint annotation, dataset shards, a
worker's ``env`` (a thread shares its process's environment) and the
unused ``results``/``get_result``/``ping``.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import GetTimeoutError
from ray_tpu_torch.train.session import TrainContext, drain_reports, set_context

# How long a group's shutdown waits for its train threads to end (seconds).
JOIN_S = 10.0


class TrainWorker:
    """Actor hosting one training worker; the user's train_fn runs on a
    dedicated thread so poll() stays responsive (max_concurrency=4)."""

    def __init__(self, rank: int, world_size: int, experiment: str,
                 storage_path: str | None):
        self.ctx = TrainContext(
            world_rank=rank, world_size=world_size, experiment_name=experiment,
            storage_path=storage_path, local_rank=max(rank, 0),
        )
        self._thread: threading.Thread | None = None
        self._status = "IDLE"  # IDLE | RUNNING | FINISHED | ERRORED
        # Status handoff train-fn thread -> actor-call thread: poll() must
        # never see an error without its status.
        self._res_lock = threading.Lock()
        self._error: str | None = None

    def reconfigure(self, rank: int, world_size: int, experiment: str,
                    storage_path: str | None) -> bool:
        """Re-rank a spare (or a finished worker) into a new group: fresh
        context, clean status."""
        if self._status == "RUNNING":
            raise RuntimeError("cannot reconfigure a running worker")
        with self._res_lock:
            self.ctx = TrainContext(
                world_rank=rank, world_size=world_size,
                experiment_name=experiment,
                storage_path=storage_path, local_rank=rank,
            )
            self._thread = None
            self._status = "IDLE"
            self._error = None
        return True

    def setup_env(self, coordinator_addr: str | None, restart_count: int,
                  latest_checkpoint: str | None):
        self.ctx.coordinator_addr = coordinator_addr
        self.ctx.restart_count = restart_count
        self.ctx.latest_checkpoint = latest_checkpoint
        return True

    def set_dataset_shards(self, shards: dict) -> bool:
        self.ctx.dataset_shards = dict(shards)
        return True

    def set_device(self, device, rank: int | None = None) -> bool:
        """The device the train function runs on: ``device`` itself, or,
        with ``rank``, that rank's card of those this process sees
        (``backend.rank_device``)."""
        if rank is not None:
            from ray_tpu_torch.train.backend import rank_device

            device = rank_device(device, rank)
        self.ctx.device = device
        return True

    def run(self, train_fn: Callable, config: dict | None) -> bool:
        if self._status == "RUNNING":
            raise RuntimeError("worker already running")
        self._status = "RUNNING"
        ctx = self.ctx

        def main():
            import inspect

            set_context(ctx)
            try:
                if ctx.device is not None and ctx.device.type == "cuda":
                    import torch

                    torch.cuda.set_device(ctx.device)
                # The return value is dropped (nothing reads it), so it
                # holds no memory past the run.
                if len(inspect.signature(train_fn).parameters) >= 1:
                    train_fn(config if config is not None else {})
                else:
                    train_fn()
                with self._res_lock:
                    self._status = "FINISHED"
            except BaseException:  # noqa: BLE001 - reported through poll()
                with self._res_lock:
                    self._error = traceback.format_exc()
                    self._status = "ERRORED"
            finally:
                set_context(None)

        self._thread = threading.Thread(target=main, daemon=True,
                                        name=f"train-fn-{ctx.world_rank}")
        self._thread.start()
        return True

    def poll(self) -> dict:
        return {
            "rank": self.ctx.world_rank,
            "status": self._status,
            "reports": drain_reports(self.ctx),
            "error": self._error,
        }

    def join(self, timeout: float) -> bool:
        """Wait up to ``timeout`` s for the train thread; True once it has
        ended (or never started)."""
        t = self._thread
        if t is not None:
            t.join(timeout)
        return t is None or not t.is_alive()

    def exec_fn(self, fn, *args, **kwargs):
        """Run an arbitrary function in this worker (backend setup hooks)."""
        return fn(*args, **kwargs)


@dataclass
class WorkerStatus:
    finished: bool = False
    errors: dict[int, str] = field(default_factory=dict)
    # rank -> death reason: the actor itself is gone, as opposed to an
    # error the train_fn raised and reported.
    dead: dict[int, str] = field(default_factory=dict)
    reports: list[dict] = field(default_factory=list)


def _actor_options(scaling) -> dict[str, Any]:
    res = scaling.worker_resources()
    opts: dict[str, Any] = {"max_concurrency": 4}
    opts["num_cpus"] = res.get("CPU", 0)
    opts["num_gpus"] = res.get("GPU", 0)
    extra = {k: v for k, v in res.items() if k not in ("CPU", "GPU")}
    if extra:
        opts["resources"] = extra
    return opts


def create_spare(scaling, experiment: str, storage_path: str | None):
    """A spare TrainWorker actor outside any group (rank -1); a later group
    recycles it via reconfigure()."""
    WorkerActor = ray_tpu_torch.remote(TrainWorker)
    return WorkerActor.options(**_actor_options(scaling)).remote(
        -1, 0, experiment, storage_path)


class WorkerGroup:
    def __init__(self, scaling, experiment: str, storage_path: str | None,
                 num_workers: int | None = None,
                 recycled: list | None = None):
        self.scaling = scaling
        n = num_workers if num_workers is not None else scaling.num_workers
        self.num_workers = n
        opts = _actor_options(scaling)
        WorkerActor = ray_tpu_torch.remote(TrainWorker)
        spares = list(recycled or [])
        self.workers = []
        for rank in range(n):
            handle = None
            while spares and handle is None:
                cand = spares.pop(0)
                try:
                    ray_tpu_torch.get([cand.reconfigure.remote(
                        rank, n, experiment, storage_path)], timeout=30)
                    handle = cand
                except Exception:  # noqa: BLE001 - spare died while idle
                    ray_tpu_torch.kill(cand)
            if handle is None:
                handle = WorkerActor.options(**opts).remote(
                    rank, n, experiment, storage_path)
            self.workers.append(handle)

    def setup(self, coordinator_addr: str | None, restart_count: int,
              latest_checkpoint: str | None):
        ray_tpu_torch.get([
            w.setup_env.remote(coordinator_addr, restart_count,
                               latest_checkpoint)
            for w in self.workers
        ], timeout=120)

    def assign_dataset_shards(self, per_rank: list[dict]) -> None:
        """per_rank[i] = {name: DataIterator} for worker rank i."""
        ray_tpu_torch.get([w.set_dataset_shards.remote(per_rank[i])
                           for i, w in enumerate(self.workers)], timeout=120)

    def run(self, train_fn: Callable, config: dict | None):
        ray_tpu_torch.get([w.run.remote(train_fn, config) for w in self.workers],
                          timeout=120)

    def poll_status(self, timeout: float = 30.0) -> WorkerStatus:
        status = WorkerStatus()
        refs = [w.poll.remote() for w in self.workers]
        polls: list[dict | None] = []
        for rank, ref in enumerate(refs):
            try:
                polls.append(ray_tpu_torch.get([ref], timeout=timeout)[0])
            except GetTimeoutError:
                raise  # poll stall is the caller's timeout, not a death
            except Exception as e:  # noqa: BLE001 - ActorDied
                status.dead[rank] = f"{type(e).__name__}: {e}"
                polls.append(None)
        states = [p["status"] for p in polls if p is not None]
        for p in polls:
            if p is None:
                continue
            status.reports.extend(
                {**r, "rank": p["rank"]} for r in p["reports"])
            if p["error"]:
                status.errors[p["rank"]] = p["error"]
        status.finished = (not status.dead
                           and all(s == "FINISHED" for s in states))
        return status

    def shutdown(self):
        """Join the train threads (within JOIN_S), then kill the actors."""
        joins = [w.join.remote(JOIN_S) for w in self.workers]
        for ref in joins:
            try:
                ray_tpu_torch.get(ref, timeout=JOIN_S + 5)
            except Exception:  # noqa: BLE001 - a dead actor has no thread to join
                pass
        for w in self.workers:
            ray_tpu_torch.kill(w)


class SparePool:
    """Controller-owned reserve of TrainWorker actors. fill() creates them
    without blocking; take() hands them to the next WorkerGroup, which
    promotes them via reconfigure()."""

    def __init__(self, scaling, experiment: str, storage_path: str | None,
                 size: int, warmup: Callable | None = None):
        self.scaling = scaling
        self.experiment = experiment
        self.storage_path = storage_path
        self.size = max(0, int(size))
        self.warmup = warmup
        self._spares: list = []

    def fill(self) -> None:
        while len(self._spares) < self.size:
            h = create_spare(self.scaling, self.experiment,
                             self.storage_path)
            if self.warmup is not None:
                # Run the user's warmup in the spare now; result and errors
                # are discarded (a broken warmup only makes promotion slower).
                h.exec_fn.remote(self.warmup)
            self._spares.append(h)

    def take(self, k: int) -> list:
        out, self._spares = self._spares[:k], self._spares[k:]
        return out

    def available(self) -> int:
        return len(self._spares)

    def shutdown(self) -> None:
        for h in self._spares:
            ray_tpu_torch.kill(h)
        self._spares.clear()
