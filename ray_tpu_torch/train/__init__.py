"""ray_tpu_torch.train: the training steps for Llama, Mixtral and ViT on
one device or over a mesh of ranks (port of ray_tpu.train.spmd), their
optimizers, process-group bring-up (``backend``) and checkpointing
(``checkpoint``); the pipeline step is ``ray_tpu_torch.parallel.pipeline``.
"""

from ray_tpu_torch.train.optim import adam, adamw, adamw_lowmem, sgd
from ray_tpu_torch.train.spmd import (
    TrainState,
    make_llama_train_step,
    make_mixtral_train_step,
    make_train_step,
    make_vit_train_step,
)

__all__ = ["TrainState", "make_train_step", "make_llama_train_step",
           "make_vit_train_step", "make_mixtral_train_step", "adamw",
           "adamw_lowmem", "sgd", "adam"]
