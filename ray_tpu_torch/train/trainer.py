"""Trainer entry points.

Port of ray_tpu/train/trainer.py: ``fit()`` starts the controller as an
actor of the in-process runtime and waits for its ``Result``.
``TorchTrainer`` is the twin of ``JaxTrainer``, with ``TorchBackendConfig``
(default: every worker on the card). Before any worker starts, ``fit()``
refuses what would fail or hang later: the backend's refusals
(``TorchBackendConfig.validate``) and a per-worker demand the runtime does
not have at all (``use_gpu=True`` on a runtime started without a
``"GPU"`` resource, say). ``datasets=`` (name -> ``ray_tpu_torch.data``
Dataset) are split over the worker group at every (re)start; a worker
reads its split through ``get_dataset_shard(name)``.
"""

from __future__ import annotations

from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.train.backend import TorchBackendConfig
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import Result, TrainController


class DataParallelTrainer:
    """Runs ``train_fn`` on N workers; reports/checkpoints flow back through
    the controller actor (reference semantics: not on the caller)."""

    backend_config_cls = TorchBackendConfig

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 backend_config: Any = None,
                 datasets: dict | None = None):
        self.train_fn = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or self.backend_config_cls()
        self.datasets = datasets

    def _check_feasible(self) -> None:
        totals = ray_tpu_torch.cluster_resources()
        for k, v in self.scaling_config.worker_resources().items():
            if totals.get(k, 0.0) < v:
                raise ValueError(
                    f"infeasible resource demand {k}={v} per worker: the "
                    f"runtime has {totals.get(k, 0.0)} (start it with "
                    f"init(resources={{{k!r}: n}}))")

    def fit(self) -> Result:
        ray_tpu_torch.init()  # no-op if already connected
        self.backend_config.validate(self.scaling_config)
        self._check_feasible()
        Controller = ray_tpu_torch.remote(TrainController)
        controller = Controller.options(
            name=f"_rtpu_train_controller:{id(self)}", num_cpus=0,
            max_concurrency=2,
        ).remote(
            self.train_fn, self.train_loop_config, self.scaling_config,
            self.run_config, self.backend_config, self.datasets,
        )
        try:
            return ray_tpu_torch.get(controller.run.remote(), timeout=None)
        finally:
            ray_tpu_torch.kill(controller)


class TorchTrainer(DataParallelTrainer):
    """PyTorch trainer (reference: ray.train.torch.TorchTrainer; twin of
    ray_tpu's JaxTrainer): every worker runs the train function on its
    device (``train.get_context().get_device()``), in lockstep where it
    syncs through ``ray_tpu_torch.collective``."""

    backend_config_cls = TorchBackendConfig
