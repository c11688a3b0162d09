"""ray_tpu_torch.train: the single-card training steps for Llama and ViT
(port of the single-device subset of ray_tpu.train.spmd) and their
optimizers."""

from ray_tpu_torch.train.optim import adamw, adamw_lowmem
from ray_tpu_torch.train.spmd import (
    TrainState,
    make_llama_train_step,
    make_train_step,
    make_vit_train_step,
)

__all__ = ["TrainState", "make_train_step", "make_llama_train_step",
           "make_vit_train_step", "adamw", "adamw_lowmem"]
