"""ray_tpu_torch.data: streaming distributed datasets (reference capability:
python/ray/data — lazy logical plan, streaming block executor, blocks as
object-store refs, per-train-worker streaming_split).

Port of ray_tpu/data on the port's in-process runtime: every public name
of ray_tpu.data, the same block format (dicts of numpy arrays) and the
same semantics. pandas, pyarrow and PIL stay optional: a format whose
package is missing raises an ImportError naming it. A dataset made from
blocks in memory while no runtime runs (``from_blocks``, ``from_numpy``,
...) holds them until a stage needs the runtime, so reading it
(offline RL) starts none. ``batches_from_blocks`` re-batches blocks in
memory; ``ray_tpu_torch.data.llm`` is batch LLM inference.
"""

from __future__ import annotations

import builtins

from typing import Any

# Eagerly finish every heavy IO import while single-threaded: pyarrow and
# pandas lazily import C-extension submodules at call time (read_table pulls
# pyarrow.dataset, etc.), and concurrent first-imports of C extensions from
# parallel task threads segfault CPython's import machinery.
try:
    import pandas as _pd  # noqa: F401
    import pyarrow as _pa  # noqa: F401
    import pyarrow.csv as _pa_csv  # noqa: F401
    import pyarrow.dataset as _pa_ds  # noqa: F401
    import pyarrow.parquet as _pa_pq  # noqa: F401
except ImportError:  # pragma: no cover - optional IO deps
    pass

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData, MaterializedDataset
from ray_tpu_torch.data.executor import ActorPoolStrategy
from ray_tpu_torch.data.iterator import DataIterator, batches_from_blocks
from ray_tpu_torch.data.plan import InputData, Read
from ray_tpu_torch.data.shuffle import (
    AggregateFn,
    Count,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ImageDatasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    SQLDatasource,
    TFRecordDatasource,
    WebDatasetDatasource,
)


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return Dataset([Read(RangeDatasource(n), parallelism)])


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    return Dataset([Read(ItemsDatasource(items), parallelism)])


def read_datasource(ds: Datasource, *, parallelism: int = -1) -> Dataset:
    return Dataset([Read(ds, parallelism)])


def read_parquet(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return Dataset([Read(ParquetDatasource(paths, **kwargs), parallelism)])


def read_csv(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return Dataset([Read(CSVDatasource(paths, **kwargs), parallelism)])


def read_json(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return Dataset([Read(JSONDatasource(paths, **kwargs), parallelism)])


def read_numpy(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return Dataset([Read(NumpyDatasource(paths, **kwargs), parallelism)])


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return Dataset([Read(BinaryDatasource(paths), parallelism)])


def read_images(paths, *, size: tuple[int, int] | None = None,
                mode: str = "RGB", parallelism: int = -1) -> Dataset:
    """Decoded images as an ``image`` column (reference:
    ray.data.read_images / datasource/image_datasource.py)."""
    return Dataset([Read(ImageDatasource(paths, size=size, mode=mode),
                         parallelism)])


def read_tfrecords(paths, *, raw: bool = False,
                   validate_data_crc: bool = False,
                   parallelism: int = -1) -> Dataset:
    """tf.train.Example records as columns (reference:
    ray.data.read_tfrecords) — decoded without a tensorflow dependency."""
    return Dataset([Read(TFRecordDatasource(
        paths, raw=raw, validate_data_crc=validate_data_crc), parallelism)])


def read_sql(sql: str, connection_factory, *,
             shard_column: str | None = None, num_shards: int = 1,
             parallelism: int = -1) -> Dataset:
    """Rows from any DB-API 2.0 database (reference: ray.data.read_sql).
    ``connection_factory`` is a zero-arg callable returning a fresh
    connection; with ``shard_column``/``num_shards`` the query range-
    partitions into parallel read tasks."""
    return Dataset([Read(SQLDatasource(
        sql, connection_factory, shard_column=shard_column,
        num_shards=num_shards), parallelism)])


def read_webdataset(paths, *, decode_images: bool = True,
                    parallelism: int = -1) -> Dataset:
    """WebDataset tar shards, one sample per key (reference:
    ray.data.read_webdataset). Columns named by member extension."""
    return Dataset([Read(WebDatasetDatasource(
        paths, decode_images=decode_images), parallelism)])


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: list | None = None, client_factory=None,
               num_shards: int = 1, parallelism: int = -1) -> Dataset:
    """Documents from MongoDB (reference: ray.data.read_mongo).
    ``client_factory`` injects a pymongo-shaped client; omitted, pymongo
    connects to ``uri``."""
    from ray_tpu_torch.data.datasource import MongoDatasource

    return Dataset([Read(MongoDatasource(
        uri, database, collection, pipeline=pipeline,
        client_factory=client_factory, num_shards=num_shards), parallelism)])


def read_bigquery(table: str, *, client_factory, max_streams: int = 8,
                  parallelism: int = -1) -> Dataset:
    """BigQuery table via Storage-API-shaped read streams (reference:
    ray.data.read_bigquery); one read task per stream."""
    from ray_tpu_torch.data.datasource import BigQueryDatasource

    return Dataset([Read(BigQueryDatasource(
        table, client_factory, max_streams=max_streams), parallelism)])


def read_delta(table_path: str, *, parallelism: int = -1) -> Dataset:
    """A Delta Lake table by replaying its _delta_log transaction log
    (reference: table-format lakes via delta-rs); one task per live file."""
    from ray_tpu_torch.data.datasource import DeltaLakeDatasource

    return Dataset([Read(DeltaLakeDatasource(table_path), parallelism)])


def from_pandas(df) -> Dataset:
    from ray_tpu_torch.data.block import block_from_pandas

    return from_blocks([block_from_pandas(df)])


def from_numpy(arr) -> Dataset:
    from ray_tpu_torch.data.block import block_from_numpy

    return from_blocks([block_from_numpy(arr)])


def from_arrow(table) -> Dataset:
    from ray_tpu_torch.data.block import block_from_arrow

    return from_blocks([block_from_arrow(table)])


def from_huggingface(hf_dataset, *, rows_per_block: int = 4096) -> Dataset:
    """A Dataset over a HuggingFace ``datasets.Dataset`` (reference:
    ray.data.from_huggingface). Rows are chunked into column-dict blocks."""
    import numpy as np

    blocks = []
    n = len(hf_dataset)
    cols = hf_dataset.column_names
    for start in builtins.range(0, n, rows_per_block):
        sl = hf_dataset[start:start + rows_per_block]
        blocks.append({c: np.asarray(sl[c]) for c in cols})
    if not blocks:
        blocks = [{c: np.asarray([]) for c in cols}]
    return from_blocks(blocks)


def from_blocks(blocks: list[Block]) -> MaterializedDataset:
    from ray_tpu_torch.data.executor import put_block
    from ray_tpu_torch.data.shuffle import _meta

    refs_meta = [(put_block(b), _meta(b)) for b in blocks]
    return MaterializedDataset(refs_meta)


__all__ = [
    "ActorPoolStrategy",
    "AggregateFn",
    "Block",
    "BlockAccessor",
    "Count",
    "DataContext",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "MaterializedDataset",
    "Max",
    "Mean",
    "Min",
    "ReadTask",
    "Std",
    "Sum",
    "batches_from_blocks",
    "from_arrow",
    "from_blocks",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_binary_files",
    "read_csv",
    "read_images",
    "read_sql",
    "read_tfrecords",
    "read_datasource",
    "read_json",
    "read_numpy",
    "read_webdataset",
    "read_mongo",
    "read_bigquery",
    "read_delta",
    "read_parquet",
]
