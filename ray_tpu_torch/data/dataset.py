"""An in-memory Dataset: a list of columnar blocks and ``iter_batches``.

The part of ray_tpu.data's ``Dataset`` that offline RL reads
(``from_blocks``, ``from_numpy``, ``iter_batches``). Blocks stay in this
process's memory: there is no object store, no lazy plan and no
streaming executor, which need the actor runtime.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ray_tpu_torch.data.iterator import Block, batches_from_blocks, num_rows


class Dataset:
    def __init__(self, blocks: list[Block]):
        self._blocks = [{k: np.asarray(v) for k, v in b.items()}
                        for b in blocks]

    def count(self) -> int:
        return sum(num_rows(b) for b in self._blocks)

    def num_blocks(self) -> int:
        return len(self._blocks)

    def iter_batches(
        self,
        *,
        batch_size: int | None = 256,
        drop_last: bool = False,
        local_shuffle_buffer_size: int | None = None,
        local_shuffle_seed: int | None = None,
    ) -> Iterator[Block]:
        """Batches as dicts of numpy arrays, as ray_tpu.data's
        ``iter_batches(batch_format="numpy")`` gives them."""
        yield from batches_from_blocks(
            self._blocks, batch_size=batch_size, drop_last=drop_last,
            shuffle_buffer_size=local_shuffle_buffer_size,
            shuffle_seed=local_shuffle_seed)


def from_blocks(blocks: list[Block]) -> Dataset:
    return Dataset(blocks)


def from_numpy(data) -> Dataset:
    """An ndarray (one column, "data") or a dict of ndarrays, one block."""
    if isinstance(data, dict):
        return Dataset([data])
    return Dataset([{"data": data}])
