"""ray_tpu_torch.tune: the ``Trainable`` base class that the RL algorithms
subclass (port of ray_tpu.tune.trainable's ``Trainable``). The trial
runtime (``report``, function trainables, trial actors) is not ported.
"""

from ray_tpu_torch.tune.trainable import Trainable

__all__ = ["Trainable"]
