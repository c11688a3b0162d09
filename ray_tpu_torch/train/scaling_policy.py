"""Scaling policies: how many workers each (re)start of training gets.

Port of ray_tpu/train/scaling_policy.py. Capability parity with the
reference's ScalingPolicy (reference:
python/ray/train/v2/_internal/execution/scaling_policy/ — fixed.py:13
FixedScalingPolicy, elastic.py:29 ElasticScalingPolicy): fixed always asks
for ScalingConfig.num_workers; elastic re-evaluates cluster capacity on
every (re)start and picks the largest feasible world size in
[min_workers, max_workers] — after a node loss, training resumes smaller
from the latest checkpoint instead of deadlocking on unsatisfiable
placement.
"""

from __future__ import annotations

import math
from typing import Callable

from ray_tpu_torch.train.config import ScalingConfig


class ScalingPolicy:
    def decide_world_size(self, restart_count: int) -> int:
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling

    def decide_world_size(self, restart_count: int) -> int:
        return self.scaling.num_workers


class ElasticScalingPolicy(ScalingPolicy):
    """Largest feasible world size within [min_workers, max_workers].

    Feasibility = how many copies of ``worker_resources()`` fit in the
    cluster's available resources right now. ``resources_fn`` is injectable
    for tests; default asks the live cluster.
    """

    def __init__(self, scaling: ScalingConfig,
                 resources_fn: Callable[[], dict] | None = None):
        self.scaling = scaling
        self.min_workers = scaling.min_workers or 1
        self.max_workers = scaling.max_workers or scaling.num_workers
        self._resources_fn = resources_fn

    def _available(self) -> dict:
        if self._resources_fn is not None:
            return self._resources_fn()
        import ray_tpu_torch

        return ray_tpu_torch.available_resources()

    def decide_world_size(self, restart_count: int) -> int:
        per_worker = self.scaling.worker_resources()
        avail = self._available()
        feasible = self.max_workers
        for res, need in per_worker.items():
            if need <= 0:
                continue
            feasible = min(feasible, int(math.floor(
                avail.get(res, 0.0) / need)))
        world = max(self.min_workers, min(self.max_workers, feasible))
        return world


def make_scaling_policy(scaling: ScalingConfig,
                        resources_fn=None) -> ScalingPolicy:
    if scaling.min_workers is not None or scaling.max_workers is not None:
        return ElasticScalingPolicy(scaling, resources_fn)
    return FixedScalingPolicy(scaling)
