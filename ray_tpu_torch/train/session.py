"""Per-worker training session: context + report API.

Port of ray_tpu/train/session.py: ``get_context()`` inside a train
function gives its rank, world, storage path, restart count and latest
checkpoint; ``report(metrics, checkpoint=dir)`` queues a result for the
controller, which drains it on its next poll. Added: the worker's
``device`` (``get_device()``), the card its train function runs on, set by
the backend (``TorchBackendConfig``).

Out: the goodput ledger, the chaos probe, the throughput gauges and the
straggler step window (no metrics registry in the port), ``replicate`` and
``get_replica_state`` (the replica tier, ROADMAP Queue A item 7).
``get_dataset_shard(name)`` is this worker's streaming split of the
Trainer's ``datasets=`` (a ``ray_tpu_torch.data.DataIterator``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    # Every worker is a thread of this process, so its local rank is its
    # world rank.
    local_rank: int = 0
    experiment_name: str = "train"
    storage_path: str | None = None
    coordinator_addr: str | None = None
    restart_count: int = 0
    latest_checkpoint: str | None = None  # dir path, set on restore
    # The device this worker's train function runs on (a torch.device, or
    # None where the backend chose none); on a card, the worker thread's
    # current CUDA device.
    device: Any = None
    dataset_shards: dict = field(default_factory=dict)  # name -> DataIterator

    _reports: list[dict] = field(default_factory=list)
    _report_lock: threading.Lock = field(default_factory=threading.Lock)

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_checkpoint(self) -> str | None:
        return self.latest_checkpoint

    def get_device(self):
        return self.device

    def get_dataset_shard(self, name: str = "train"):
        """This worker's streaming split of a Trainer dataset (reference:
        ray.train.get_dataset_shard — v2 DataParallelTrainer datasets= are
        streaming_split across the worker group)."""
        if name not in self.dataset_shards:
            raise KeyError(
                f"no dataset {name!r}; Trainer(datasets={{...}}) keys: "
                f"{sorted(self.dataset_shards)}")
        return self.dataset_shards[name]


_local = threading.local()


def set_context(ctx: TrainContext | None) -> None:
    _local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("ray_tpu_torch.train.get_context() called outside a train worker")
    return ctx


def report(metrics: dict[str, Any], checkpoint: str | None = None) -> None:
    """Report metrics (and optionally a checkpoint directory the worker has
    already written) to the controller. Non-blocking; the controller
    collects reports when it polls. The metrics travel through the object
    store: send numbers, not device tensors (utils/serialization.py)."""
    ctx = get_context()
    with ctx._report_lock:
        # "ts" is the worker-stamped report instant.
        ctx._reports.append({"metrics": dict(metrics), "checkpoint": checkpoint,
                             "ts": time.time()})


def drain_reports(ctx: TrainContext) -> list[dict]:
    with ctx._report_lock:
        out, ctx._reports = ctx._reports, []
    return out


def get_dataset_shard(name: str = "train"):
    """Module-level alias (reference: ray.train.get_dataset_shard)."""
    return get_context().get_dataset_shard(name)
