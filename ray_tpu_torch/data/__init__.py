"""ray_tpu_torch.data: the in-memory datasets that offline RL reads.

A port of the part of ray_tpu.data that BC, MARWIL and CQL use:
``from_blocks``/``from_numpy`` and ``Dataset.iter_batches`` with
ray_tpu.data's re-batching and local shuffle. The offline algorithms take
any object with that ``iter_batches`` signature.
"""

from ray_tpu_torch.data.dataset import Dataset, from_blocks, from_numpy
from ray_tpu_torch.data.iterator import batches_from_blocks

__all__ = ["Dataset", "batches_from_blocks", "from_blocks", "from_numpy"]
