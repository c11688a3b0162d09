"""Train configuration types.

Port of ray_tpu/train/config.py. ``use_gpu`` is the counterpart of
``use_tpu``: each worker demands ``{"GPU": 1}``, one rank a card. Out: the
TPU-only ``topology`` and ``accelerator_type``, the unread
``placement_strategy`` (no placement groups here) and
``checkpoint_frequency``;
``CheckpointConfig.replicate_every > 0`` raises (the in-cluster replica
tier, ``train/replica.py``, ROADMAP Queue A item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: dict[str, float] = field(default_factory=dict)
    # Elastic range (reference: elastic.py:29 ElasticScalingPolicy). Setting
    # either makes scaling elastic: every (re)start picks the largest
    # feasible world size in [min_workers, max_workers].
    min_workers: int | None = None
    max_workers: int | None = None
    # Hot spares: TrainWorker actors the controller keeps created OUTSIDE
    # the group; the next group after a failure promotes them. Here a
    # spare is a thread, so promotion saves only what ``hot_spare_warmup``
    # (run once in each spare through exec_fn) prepares.
    hot_spares: int = 0
    hot_spare_warmup: Any = None

    def worker_resources(self) -> dict[str, float]:
        res = dict(self.resources_per_worker)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0  # one card a rank
        if "CPU" not in res and not self.use_gpu:
            res["CPU"] = 1.0
        return res


@dataclass
class FailureConfig:
    max_failures: int = 0  # -1 = unlimited restarts from latest checkpoint


@dataclass
class CheckpointConfig:
    num_to_keep: int | None = None
    replicate_every: int = 0

    def __post_init__(self):
        if self.replicate_every > 0:
            raise NotImplementedError(
                "CheckpointConfig.replicate_every > 0: in-cluster state "
                "replicas (ray_tpu/train/replica.py) are not ported (ROADMAP "
                "Queue A item 7); restarts restore the latest checkpoint")


@dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    # Callbacks the controller invokes on run start / each rank-0 result /
    # checkpoint / run end (on_run_start, on_result, on_checkpoint,
    # on_run_end).
    callbacks: list = field(default_factory=list)
