"""Block model for ray_tpu_torch.data.

A Block is the unit of data that flows between operators as an object-store
ref (reference capability: python/ray/data/block.py — Arrow/pandas blocks in
plasma). The canonical in-memory block is a **columnar dict of numpy
arrays** — what a pinned host copy feeds to the card — with conversion
shims for rows, pandas, and pyarrow.

Port of ray_tpu/data/block.py: the same block format (a dict of
numpy arrays) and accessor.
"""

from __future__ import annotations

import importlib
import threading
from typing import Any, Iterator

import numpy as np

# Concurrent *first* imports of pyarrow/pandas C-extension submodules from
# parallel task threads segfault CPython's import machinery — take one lock
# around the lazy import, then use the cached module freely from any thread.
_IMPORT_LOCK = threading.Lock()


def require(module: str, package: str):
    """Import an optional IO dependency; a missing one raises ImportError
    naming the package (no fallback)."""
    with _IMPORT_LOCK:
        try:
            return importlib.import_module(module)
        except ImportError as e:
            raise ImportError(
                f"this ray_tpu_torch.data format needs the {package!r} "
                f"package, which is not installed ({e})") from e

# A Block is dict[str, np.ndarray]; all columns share length == num_rows.
Block = dict


def _to_column(values: list) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S"):
        arr = np.asarray(values, dtype=object)
    if arr.dtype.kind == "O" and arr.ndim > 1:
        # ragged nested lists — keep one object per row
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        arr = out
    return arr


def block_from_rows(rows: list[dict]) -> Block:
    """Build a columnar block from a list of row dicts."""
    if not rows:
        return {}
    cols: dict[str, list] = {k: [] for k in rows[0]}
    for r in rows:
        if r.keys() != cols.keys():
            for k in r:
                if k not in cols:
                    cols[k] = [None] * (len(cols[next(iter(cols))]) if cols else 0)
        for k in cols:
            cols[k].append(r.get(k))
    return {k: _to_column(v) for k, v in cols.items()}


def block_from_arrow(table) -> Block:
    """pyarrow.Table → columnar block."""
    out: Block = {}
    for name in table.column_names:
        col = table.column(name)
        try:
            out[name] = col.to_numpy(zero_copy_only=False)
        except Exception:
            out[name] = np.asarray(col.to_pylist(), dtype=object)
    return out


def block_from_pandas(df) -> Block:
    out: Block = {}
    for name in df.columns:
        out[str(name)] = df[name].to_numpy()
    return out


def block_from_numpy(data) -> Block:
    """An ndarray (→ column "data") or a dict of ndarrays."""
    if isinstance(data, dict):
        return {k: np.asarray(v) for k, v in data.items()}
    return {"data": np.asarray(data)}


class BlockAccessor:
    """Uniform view over a columnar block (reference capability:
    python/ray/data/block.py BlockAccessor)."""

    def __init__(self, block: Block):
        self._block = block or {}

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        for col in self._block.values():
            return len(col)
        return 0

    def size_bytes(self) -> int:
        total = 0
        for col in self._block.values():
            if col.dtype.kind == "O":
                total += sum(_approx_obj_size(v) for v in col)
            else:
                total += col.nbytes
        return total

    def columns(self) -> list[str]:
        return list(self._block.keys())

    def schema(self) -> dict[str, str]:
        return {k: str(v.dtype) for k, v in self._block.items()}

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._block.items()}

    def take_rows(self, indices: np.ndarray) -> Block:
        return {k: v[indices] for k, v in self._block.items()}

    def iter_rows(self) -> Iterator[dict]:
        keys = list(self._block.keys())
        for i in range(self.num_rows()):
            yield {k: _unbox(self._block[k][i]) for k in keys}

    def to_pandas(self):
        pd = require("pandas", "pandas")

        return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                             for k, v in self._block.items()})

    def to_arrow(self):
        pa = require("pyarrow", "pyarrow")

        return pa.Table.from_pydict({k: list(v) for k, v in self._block.items()})

    def to_numpy(self) -> Block:
        return dict(self._block)

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "default", None):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")


def _unbox(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _approx_obj_size(v: Any) -> int:
    if isinstance(v, (bytes, str)):
        return len(v)
    if isinstance(v, np.ndarray):
        return v.nbytes
    return 8


def concat_blocks(blocks: list[Block]) -> Block:
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
    if not blocks:
        return {}
    keys = list(blocks[0].keys())
    out: Block = {}
    for k in keys:
        cols = [b[k] for b in blocks]
        if any(c.dtype.kind == "O" for c in cols):
            merged = np.empty(sum(len(c) for c in cols), dtype=object)
            i = 0
            for c in cols:
                merged[i:i + len(c)] = c
                i += len(c)
            out[k] = merged
        else:
            out[k] = np.concatenate(cols)
    return out


def batch_to_block(batch: Any) -> Block:
    """Normalize a user map_batches return value into a block."""
    if batch is None:
        return {}
    if isinstance(batch, dict):
        return {k: np.asarray(v) if not isinstance(v, np.ndarray) else v
                for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return {"data": batch}
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return block_from_pandas(batch)
    except ImportError:
        pass
    try:
        import pyarrow as pa

        if isinstance(batch, pa.Table):
            return block_from_arrow(batch)
    except ImportError:
        pass
    raise TypeError(
        f"map_batches must return dict/ndarray/DataFrame/Table, got {type(batch)}"
    )


def split_block(block: Block, num_splits: int) -> list[Block]:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    sizes = [n // num_splits + (1 if i < n % num_splits else 0)
             for i in range(num_splits)]
    out, start = [], 0
    for s in sizes:
        out.append(acc.slice(start, start + s))
        start += s
    return out
