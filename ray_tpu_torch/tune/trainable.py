"""The class trainable: setup/step/checkpoint lifecycle.

Port of ray_tpu/tune/trainable.py's ``Trainable`` (reference:
python/ray/tune/trainable/trainable.py). A controller calls
``train_step`` repeatedly so that schedulers can act between steps;
``report``, ``FunctionTrainable`` and the trial actor need the actor
runtime, which the port does not have yet.
"""

from __future__ import annotations

from typing import Any


class Trainable:
    """Subclass and implement setup/step (and save_checkpoint/
    load_checkpoint for PBT and fault tolerance)."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.iteration = 0
        self.setup(self.config)

    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        """Return a picklable checkpoint (dict of state)."""
        return None

    def load_checkpoint(self, checkpoint: Any) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Return True if the trainable can hot-swap configs (PBT explore
        without actor restart)."""
        return False

    def cleanup(self) -> None:
        pass

    def train_step(self) -> dict:
        result = self.step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("done", False)
        return result
