"""Chained block hashes for KV-block-aware prefix routing.

The port's own copy of ``block_hashes`` and ``match_len`` from
ray_tpu/serve/prefix.py (the port imports nothing of the JAX package). A
prompt is hashed in fixed-size
blocks where block ``i``'s hash chains over block ``i-1``'s, so hash
``h_i`` identifies the whole prefix through block ``i``. crc32 over the
little-endian uint32 ids: stable across processes, and equal to the JAX
package's hashes for the same ids, so both engines publish the same keys.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np

# Hashing more than this many blocks per prefix buys nothing for routing.
MAX_BLOCKS = 64


def block_hashes(ids: Sequence[int], block: int,
                 max_blocks: int = MAX_BLOCKS) -> tuple[int, ...]:
    """Chain hashes of ``ids`` in blocks of ``block`` tokens. Only FULL
    blocks are hashed; () for prompts shorter than one block."""
    if block <= 0:
        return ()
    n = (min(len(ids), block * max_blocks) // block) * block
    if n <= 0:
        return ()
    buf = np.asarray(list(ids[:n]), dtype=np.int64).astype(
        np.uint32).tobytes()
    out = []
    h = 0
    step = block * 4
    for i in range(0, n * 4, step):
        h = zlib.crc32(buf[i:i + step], h)
        out.append(h)
    return tuple(out)


def match_len(hashes: Sequence[int], held: "set[int] | frozenset[int]"
              ) -> int:
    """Leading blocks of ``hashes`` present in ``held``. Chaining makes a
    gap impossible in an honest publication, so stop at the first miss."""
    n = 0
    for h in hashes:
        if h not in held:
            break
        n += 1
    return n
