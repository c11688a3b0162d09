"""Content-addressed function and actor-class registry.

Port of ray_tpu/core/fn_registry.py: a task names its function by
``fn_id = sha256(fn_blob)``; the submitter exports the blob to the head's
KV under ``FN_NS`` once, and each worker unpickles a definition once and
keeps it in ``FnCache`` (LRU, bounded by ``fn_cache_max_bytes``).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any

# Head-KV namespace the definitions are exported into.
FN_NS = "__fn__"


def fn_id(fn_blob: bytes) -> str:
    """Content address of a serialized definition."""
    return hashlib.sha256(fn_blob).hexdigest()


class FnCache:
    """LRU cache of deserialized definitions, bounded by a byte budget
    (each entry charged its serialized size). Thread-safe."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[str, tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str) -> Any | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: str, value: Any, nbytes: int) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            # Never evict the entry just put: a definition larger than the
            # whole budget must still serve the task that fetched it.
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_, n) = self._entries.popitem(last=False)
                self._bytes -= n
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
