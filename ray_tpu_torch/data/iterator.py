"""Re-batching of in-memory blocks, with an optional local shuffle.

The port's copy of ``batches_from_refs`` (ray_tpu/data/iterator.py),
over blocks held in memory instead of object refs: rows carry across
blocks, one ``np.random.default_rng(shuffle_seed)`` draws a permutation
of each emitted batch when a shuffle buffer is set, and the last partial
batch is kept unless ``drop_last``. The same blocks and seed give the
same batches, bit for bit, in the same order.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

Block = dict  # column name -> np.ndarray, every column the same length


def num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


def concat_blocks(blocks: list[Block]) -> Block:
    blocks = [b for b in blocks if num_rows(b) > 0]
    if not blocks:
        return {}
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def batches_from_blocks(
    blocks: Iterable[Block],
    *,
    batch_size: int | None,
    drop_last: bool = False,
    shuffle_buffer_size: int | None = None,
    shuffle_seed: int | None = None,
) -> Iterator[Block]:
    """Re-batch a stream of blocks into batches of ``batch_size`` rows
    (``None``: one batch a block)."""
    carry: list[Block] = []
    carry_rows = 0
    rng = np.random.default_rng(shuffle_seed)

    def emit(block: Block) -> Block:
        n = num_rows(block)
        if shuffle_buffer_size and n > 1:
            order = rng.permutation(n)
            block = {k: v[order] for k, v in block.items()}
        return dict(block)

    for block in blocks:
        n = num_rows(block)
        if n == 0:
            continue
        if batch_size is None:
            yield emit(block)
            continue
        carry.append(block)
        carry_rows += n
        while carry_rows >= batch_size:
            merged = concat_blocks(carry)
            yield emit({k: v[:batch_size] for k, v in merged.items()})
            rest = {k: v[batch_size:] for k, v in merged.items()}
            carry_rows = num_rows(rest)
            carry = [rest] if carry_rows else []
    if carry_rows and batch_size is not None and not drop_last:
        yield emit(concat_blocks(carry))
