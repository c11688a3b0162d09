"""ray_tpu_torch.train: the training steps for Llama, Mixtral and ViT on
one device or over a mesh of ranks (port of ray_tpu.train.spmd), their
optimizers, process-group bring-up (``backend``) and checkpointing
(``checkpoint``), and the trainer on the in-process runtime
(``TorchTrainer``: controller, worker group, session, configs); the
pipeline step is ``ray_tpu_torch.parallel.pipeline``.
"""

from ray_tpu_torch.train.backend import TorchBackendConfig
from ray_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    Checkpoint,
    CheckpointManager,
    restore_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.controller import Result, TrainController
from ray_tpu_torch.train.optim import adam, adamw, adamw_lowmem, sgd
from ray_tpu_torch.train.session import get_context, get_dataset_shard, report
from ray_tpu_torch.train.spmd import (
    TrainState,
    make_llama_train_step,
    make_mixtral_train_step,
    make_train_step,
    make_vit_train_step,
)
from ray_tpu_torch.train.trainer import DataParallelTrainer, TorchTrainer

__all__ = [
    "TorchTrainer", "DataParallelTrainer", "TrainController", "Result",
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "TorchBackendConfig", "get_context", "get_dataset_shard", "report",
    "Checkpoint", "CheckpointManager", "save_pytree", "restore_pytree",
    "AsyncCheckpointWriter", "TrainState", "make_train_step",
    "make_llama_train_step", "make_vit_train_step",
    "make_mixtral_train_step", "adamw", "adamw_lowmem", "sgd", "adam",
]
