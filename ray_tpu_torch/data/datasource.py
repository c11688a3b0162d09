"""Datasources: each produces a list of ReadTasks (reference capability:
python/ray/data/datasource/ + read_api.py:934 read_parquet).

A ReadTask is a zero-arg callable returning one Block; the executor runs them
as remote tasks so reads parallelize and blocks land in the object store.

Port of ray_tpu/data/datasource.py. pandas, pyarrow and PIL stay
optional: a format whose package is missing raises an ImportError that
names the package.
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    block_from_arrow,
    block_from_numpy,
    block_from_pandas,
    block_from_rows,
    require,
)


@dataclass
class ReadTask:
    fn: Callable[[], Block]
    # best-effort metadata for planning; -1 means unknown
    num_rows: int = -1
    metadata: dict = field(default_factory=dict)

    def __call__(self) -> Block:
        return self.fn()


class Datasource:
    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class RangeDatasource(Datasource):
    def __init__(self, n: int, column: str = "id"):
        self._n = n
        self._col = column

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        parallelism = max(1, min(parallelism, self._n or 1))
        chunk = self._n // parallelism
        rem = self._n % parallelism
        tasks, start = [], 0
        for i in range(parallelism):
            size = chunk + (1 if i < rem else 0)
            lo, hi = start, start + size
            start = hi
            col = self._col

            def fn(lo=lo, hi=hi, col=col) -> Block:
                return {col: np.arange(lo, hi, dtype=np.int64)}

            tasks.append(ReadTask(fn, num_rows=size))
        return [t for t in tasks if t.num_rows > 0] or [
            ReadTask(lambda col=self._col: {col: np.arange(0, dtype=np.int64)},
                     num_rows=0)
        ]


class ItemsDatasource(Datasource):
    def __init__(self, items: list):
        self._items = list(items)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = len(self._items)
        parallelism = max(1, min(parallelism, n or 1))
        chunk = n // parallelism
        rem = n % parallelism
        tasks, start = [], 0
        for i in range(parallelism):
            size = chunk + (1 if i < rem else 0)
            part = self._items[start:start + size]
            start += size
            if not part and n > 0:
                continue

            def fn(part=part) -> Block:
                rows = [r if isinstance(r, dict) else {"item": r} for r in part]
                return block_from_rows(rows)

            tasks.append(ReadTask(fn, num_rows=size))
        return tasks or [ReadTask(lambda: {}, num_rows=0)]


def _expand_paths(paths, suffixes: tuple[str, ...]) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for suf in suffixes:
                out.extend(sorted(_glob.glob(os.path.join(p, f"*{suf}"))))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


class FileDatasource(Datasource):
    suffixes: tuple[str, ...] = ()

    def __init__(self, paths, **read_kwargs):
        self._paths = _expand_paths(paths, self.suffixes)
        self._kwargs = read_kwargs

    def read_file(self, path: str) -> Block:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        tasks = []
        for path in self._paths:
            def fn(path=path):
                return self.read_file(path)

            tasks.append(ReadTask(fn, metadata={"path": path}))
        return tasks


class ParquetDatasource(FileDatasource):
    suffixes = (".parquet",)

    def read_file(self, path: str) -> Block:
        pq = _import_pq()

        return block_from_arrow(pq.read_table(path, **self._kwargs))


class CSVDatasource(FileDatasource):
    suffixes = (".csv",)

    def read_file(self, path: str) -> Block:
        pd = _import_pd()

        return block_from_pandas(pd.read_csv(path, **self._kwargs))


class JSONDatasource(FileDatasource):
    suffixes = (".json", ".jsonl")

    def read_file(self, path: str) -> Block:
        import json

        rows = []
        with open(path) as f:
            text = f.read().strip()
        if text.startswith("["):
            rows = json.loads(text)
        else:
            for line in text.splitlines():
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return block_from_rows(rows)


class NumpyDatasource(FileDatasource):
    suffixes = (".npy",)

    def read_file(self, path: str) -> Block:
        return block_from_numpy(np.load(path, allow_pickle=False))


class BinaryDatasource(FileDatasource):
    """Whole-file bytes, one row per file (images etc.)."""

    suffixes = ()

    def read_file(self, path: str) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        col = np.empty(1, dtype=object)
        col[0] = data
        pcol = np.empty(1, dtype=object)
        pcol[0] = path
        return {"bytes": col, "path": pcol}


class ImageDatasource(FileDatasource):
    """Decoded images, one row per file (reference capability:
    python/ray/data/datasource/image_datasource.py — decode via PIL into an
    ``image`` ndarray column plus the source ``path``).

    ``size=(h, w)`` resizes at read time (rows then stack into one dense
    [N, h, w, C] batch per block — the shape a trainer wants); without it,
    variable-shape arrays ride an object column. ``mode`` converts color
    space (default RGB).
    """

    suffixes = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, paths, size: tuple[int, int] | None = None,
                 mode: str = "RGB"):
        super().__init__(paths)
        self._size = size
        self._mode = mode

    def read_file(self, path: str) -> Block:
        Image = _import_pil()

        with Image.open(path) as im:
            if self._mode:
                im = im.convert(self._mode)
            if self._size is not None:
                h, w = self._size
                im = im.resize((w, h))  # PIL takes (width, height)
            arr = np.asarray(im)
        if self._size is not None:
            img_col = arr[None]  # dense [1, h, w, C]
        else:
            img_col = np.empty(1, dtype=object)
            img_col[0] = arr
        pcol = np.empty(1, dtype=object)
        pcol[0] = path
        return {"image": img_col, "path": pcol}


class TFRecordDatasource(FileDatasource):
    """tf.train.Example records decoded into columns (reference:
    datasource/tfrecords_datasource.py) — no tensorflow dependency, the
    framing + proto wire format are parsed directly (data/tfrecord.py).
    ``raw=True`` skips Example parsing and yields one ``data`` bytes
    column (arbitrary payloads, e.g. serialized tensors)."""

    suffixes = (".tfrecord", ".tfrecords")

    def __init__(self, paths, raw: bool = False,
                 validate_data_crc: bool = False):
        super().__init__(paths)
        self._raw = raw
        self._validate = validate_data_crc

    def read_file(self, path: str) -> Block:
        from ray_tpu_torch.data.tfrecord import (
            example_rows_to_block,
            parse_example,
            read_records,
        )

        records = list(read_records(path,
                                    validate_data_crc=self._validate))
        if self._raw:
            col = np.empty(len(records), object)
            for i, r in enumerate(records):
                col[i] = r
            return {"data": col}
        return example_rows_to_block([parse_example(r) for r in records])


class SQLDatasource(Datasource):
    """Rows from a DB-API 2.0 database (reference capability:
    python/ray/data/read_api.py read_sql — sql + zero-arg connection
    factory). Works with any DB-API driver; sqlite3 (stdlib) in tests.

    Unsharded, the query runs as ONE read task. With ``shard_column`` (a
    NUMERIC column) + ``num_shards``, the table is range-partitioned by
    bound predicates computed from MIN/MAX so shards read in parallel —
    the same strategy as the reference's sharded read_sql. Bounds are
    inlined as numeric literals (driver paramstyles differ; numbers are
    portable), and rows with a NULL shard key ride the first shard so
    sharding never silently drops rows.
    """

    def __init__(self, sql: str, connection_factory: Callable[[], Any],
                 shard_column: str | None = None, num_shards: int = 1):
        self._sql = sql
        self._factory = connection_factory
        self._shard_column = shard_column
        self._num_shards = max(1, num_shards)

    @staticmethod
    def _fetch(factory, sql, params=()) -> Block:
        conn = factory()
        try:
            cur = conn.cursor()
            cur.execute(sql, params)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        return block_from_rows([dict(zip(cols, r)) for r in rows])

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        factory, sql = self._factory, self._sql
        if self._shard_column is None or self._num_shards == 1:
            return [ReadTask(lambda: self._fetch(factory, sql))]
        col = self._shard_column
        conn = factory()
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT MIN({col}), MAX({col}) "  # noqa: S608
                        f"FROM ({sql}) __rtpu_bounds")
            lo, hi = cur.fetchone()
        finally:
            conn.close()
        if lo is None:  # empty result set (or all-NULL shard column)
            return [ReadTask(lambda: self._fetch(factory, sql))]
        if not isinstance(lo, (int, float)) or isinstance(lo, bool):
            raise ValueError(
                f"shard_column {col!r} must be numeric for range "
                f"sharding (got {type(lo).__name__}); omit shard_column "
                f"to read unsharded")
        tasks = []
        int_bounds = isinstance(lo, int) and isinstance(hi, int)

        def bound(i: int):
            # Integer columns get EXACT integer bounds — float math loses
            # precision above 2**53 (ns-epoch timestamps, snowflake ids)
            # and a rounded-up lower bound silently excludes the MIN rows
            # from every shard.
            if int_bounds:
                return lo + (hi - lo) * i // self._num_shards
            return lo + (hi - lo) / self._num_shards * i

        for i in range(self._num_shards):
            a = bound(i)
            b = hi if i == self._num_shards - 1 else bound(i + 1)
            # last shard closes the interval so MAX rows aren't dropped
            op = "<=" if i == self._num_shards - 1 else "<"
            pred = f"({col} >= {a!r} AND {col} {op} {b!r})"
            if i == 0:  # NULL keys satisfy no range predicate
                pred = f"({pred} OR {col} IS NULL)"
            shard_sql = (f"SELECT * FROM ({sql}) __rtpu_shard "  # noqa: S608
                         f"WHERE {pred}")
            tasks.append(ReadTask(
                lambda s=shard_sql: self._fetch(factory, s)))
        return tasks


class WebDatasetDatasource(FileDatasource):
    """WebDataset-style tar shards (reference capability:
    python/ray/data/read_api.py read_webdataset): each shard is a .tar whose
    members group into samples by key = basename up to the first dot; the
    remaining extension names the column. One read task per shard — the
    natural parallel unit.

    Decoding: .json → parsed object, .txt/.cls → str (cls additionally int
    when it parses), image extensions → decoded ndarray when PIL is
    available (else raw bytes), everything else → bytes. Columns are named
    by the FULL extension ("seg.png"), decode dispatches on the last
    segment ("png") — standard WebDataset member naming.
    """

    suffixes = (".tar",)
    _IMG_EXT = ("png", "jpg", "jpeg", "bmp", "gif", "webp")

    def __init__(self, paths, decode_images: bool = True):
        super().__init__(paths)
        self._decode_images = decode_images

    def _decode(self, ext: str, data: bytes):
        import io
        import json

        ext = ext.rsplit(".", 1)[-1]  # "seg.png" decodes as "png"
        if ext == "json":
            return json.loads(data)
        if ext in ("txt", "text"):
            return data.decode()
        if ext == "cls":
            text = data.decode().strip()
            try:
                return int(text)
            except ValueError:
                return text
        if ext in self._IMG_EXT and self._decode_images:
            try:
                Image = _import_pil()
                with Image.open(io.BytesIO(data)) as im:
                    return np.asarray(im.convert("RGB"))
            except ImportError:
                return data
        return data

    def read_file(self, path: str) -> Block:
        import tarfile

        samples: dict[str, dict] = {}
        order: list[str] = []
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                # WebDataset convention: the sample key is the member PATH
                # up to the first dot of the basename — basename-only keys
                # would merge train/0001.jpg and val/0001.jpg into one
                # sample (silent loss on per-class-directory shards).
                dirpart, base = os.path.split(member.name)
                if "." in base:
                    stem, ext = base.split(".", 1)
                else:
                    stem, ext = base, "bin"
                key = f"{dirpart}/{stem}" if dirpart else stem
                data = tf.extractfile(member).read()
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext.lower()] = self._decode(ext.lower(), data)
        return block_from_rows([samples[k] for k in order])


class MongoDatasource(Datasource):
    """Documents from a MongoDB collection (reference capability:
    python/ray/data/read_api.py read_mongo — uri/database/collection +
    optional aggregation pipeline). ``client_factory`` is a zero-arg
    callable returning a pymongo-shaped client (injectable: tests and
    driverless environments use a fake; omitted, pymongo is imported and
    connected to ``uri``).

    Sharding: ``num_shards`` partitions the collection by _id ranges
    whose boundaries are the documents at even rank offsets (sorted by
    _id, one count + N skip probes) so shards read in parallel;
    combining ``pipeline`` with ``num_shards > 1`` raises (a pipeline can
    reorder/reshape documents, making _id ranges meaningless). The
    reference delegates range splitting to the mongo cluster
    (splitVector); _id-range partitioning is the driver-portable
    equivalent at this scale."""

    def __init__(self, uri: str, database: str, collection: str,
                 pipeline: list | None = None,
                 client_factory: Callable[[], Any] | None = None,
                 num_shards: int = 1):
        self._uri = uri
        self._db = database
        self._coll = collection
        self._pipeline = list(pipeline or [])
        self._factory = client_factory
        self._num_shards = max(1, num_shards)

    def _client(self):
        if self._factory is not None:
            return self._factory()
        try:
            import pymongo  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "read_mongo needs pymongo (not in this image) or an "
                "injectable client_factory") from e
        return pymongo.MongoClient(self._uri)

    def _fetch(self, extra_stages: list | None = None) -> Block:
        client = self._client()
        try:
            coll = client[self._db][self._coll]
            rows = [dict(d) for d in coll.aggregate(
                list(self._pipeline) + list(extra_stages or []))]
        finally:
            close = getattr(client, "close", None)
            if close:
                close()
        return block_from_rows(rows)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if self._num_shards == 1:
            return [ReadTask(lambda: self._fetch())]
        if self._pipeline:
            # skip/limit windows over pipeline OUTPUT are only correct
            # under a total order, and pipelines can project _id away or
            # emit ties ($unwind) that MongoDB's unstable sort splits
            # differently per shard — silent row loss/duplication. The
            # reference likewise shards the raw collection (splitVector),
            # not pipeline output.
            raise ValueError(
                "read_mongo: num_shards > 1 cannot be combined with a "
                "pipeline (no total order over pipeline output to "
                "partition on); shard the raw collection and apply the "
                "pipeline per shard upstream, or use num_shards=1")
        client = self._client()
        try:
            coll = client[self._db][self._coll]
            total = coll.count_documents({})
            per = max(1, (total + self._num_shards - 1) // self._num_shards)
            # _id range partition (every document has a unique, indexed
            # _id): boundary docs at the shard edges make closed/open
            # [lo, hi) predicates that are deterministic under concurrent
            # writes — unlike skip/limit windows.
            bounds = []
            for i in range(1, self._num_shards):
                edge = list(coll.aggregate([
                    {"$sort": {"_id": 1}}, {"$skip": i * per},
                    {"$limit": 1}, {"$project": {"_id": 1}}]))
                bounds.append(edge[0]["_id"] if edge else None)
        finally:
            close = getattr(client, "close", None)
            if close:
                close()
        tasks = []
        prev = None
        for hi in bounds + [None]:
            match: dict = {}
            if prev is not None:
                match["$gte"] = prev
            if hi is not None:
                match["$lt"] = hi
            stage = [{"$match": {"_id": match}}] if match else []
            tasks.append(ReadTask(lambda st=stage: self._fetch(st)))
            prev = hi
            if hi is None:
                # No boundary doc at this edge (total < num_shards or the
                # collection shrank): this task already took [prev, ∞) —
                # further shards would re-read the whole collection.
                break
        return tasks


class BigQueryDatasource(Datasource):
    """Rows from a BigQuery table via Storage-API-shaped read streams
    (reference capability: python/ray/data/read_api.py read_bigquery).
    ``client_factory`` returns an object with ``create_read_session(table,
    max_streams) -> [stream_id, ...]`` and ``read_rows(stream_id) ->
    iterable[dict]`` — the google-cloud-bigquery-storage surface reduced
    to its data motion; tests inject a fake, real use wraps the Google
    client. One read task per stream (the Storage API's parallel unit)."""

    def __init__(self, table: str, client_factory: Callable[[], Any],
                 max_streams: int = 8):
        self._table = table
        self._factory = client_factory
        self._max_streams = max(1, max_streams)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        client = self._factory()
        try:
            streams = list(client.create_read_session(self._table,
                                                      self._max_streams))
        finally:
            close = getattr(client, "close", None)
            if close:
                close()

        def read_stream(stream_id):
            c = self._factory()
            try:
                return block_from_rows([dict(r) for r in
                                        c.read_rows(stream_id)])
            finally:
                close = getattr(c, "close", None)
                if close:
                    close()

        return [ReadTask(lambda s=s: read_stream(s),
                         metadata={"stream": s}) for s in streams]


class DeltaLakeDatasource(Datasource):
    """A Delta Lake table from its transaction log (reference capability:
    ray.data.read_delta / delta-rs integration — here implemented directly:
    replay ``_delta_log/*.json`` add/remove actions to the live file set,
    then read each data file with the parquet reader, injecting the file's
    ``partitionValues`` as literal columns the way partitioned parquet
    lakes expect). One read task per live data file."""

    def __init__(self, table_path: str):
        self._root = table_path

    def _live_files(self) -> list[tuple[str, dict]]:
        import json as _json

        log_dir = os.path.join(self._root, "_delta_log")
        live: dict[str, dict] = {}
        ckpt_version = -1
        # Checkpointed tables vacuum old JSON commits: seed the file set
        # from the parquet checkpoint named by _last_checkpoint, then
        # replay only the JSON commits AFTER it.
        last_ck = os.path.join(log_dir, "_last_checkpoint")
        if os.path.exists(last_ck):
            with open(last_ck) as f:
                ckpt_version = int(_json.load(f)["version"])
            parts = sorted(_glob.glob(os.path.join(
                log_dir, f"{ckpt_version:020d}.checkpoint*.parquet")))
            if not parts:
                raise FileNotFoundError(
                    f"_last_checkpoint names version {ckpt_version} but no "
                    f"matching *.checkpoint*.parquet exists in {log_dir!r}")
            pq = _import_pq()
            for part in parts:
                tbl = pq.read_table(part)
                for row in tbl.to_pylist():
                    a = row.get("add")
                    if a and a.get("path"):
                        live[a["path"]] = a.get("partitionValues") or {}
                    r = row.get("remove")
                    if r and r.get("path"):
                        live.pop(r["path"], None)

        logs = sorted(_glob.glob(os.path.join(log_dir, "*.json")))
        if not logs and ckpt_version < 0:
            raise FileNotFoundError(
                f"no _delta_log under {self._root!r} — not a Delta table")
        for log in logs:  # commits replay in version order
            version = int(os.path.splitext(os.path.basename(log))[0])
            if version <= ckpt_version:
                continue  # already folded into the checkpoint
            with open(log) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    action = _json.loads(line)
                    if "add" in action:
                        a = action["add"]
                        live[a["path"]] = a.get("partitionValues", {}) or {}
                    elif "remove" in action:
                        live.pop(action["remove"]["path"], None)
        return [(os.path.join(self._root, p), pv)
                for p, pv in sorted(live.items())]

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        tasks = []
        for path, part_values in self._live_files():
            def fn(path=path, pv=part_values):
                from ray_tpu_torch.data.block import _to_column

                pq = _import_pq()
                block = block_from_arrow(pq.read_table(path))
                n = len(next(iter(block.values()))) if block else 0
                for col, val in pv.items():
                    block[col] = _to_column([val] * n)
                return block

            tasks.append(ReadTask(fn, metadata={"path": path}))
        return tasks


# ---------------------------------------------------------------------------
# write tasks


def _import_pq():
    return require("pyarrow.parquet", "pyarrow")


def _import_pd():
    return require("pandas", "pandas")


def _import_pil():
    return require("PIL.Image", "Pillow (PIL)")


def write_block_parquet(block: Block, path: str, index: int) -> str:
    pq = _import_pq()

    from ray_tpu_torch.data.block import BlockAccessor

    out = os.path.join(path, f"part-{index:05d}.parquet")
    pq.write_table(BlockAccessor(block).to_arrow(), out)
    return out


def write_block_csv(block: Block, path: str, index: int) -> str:
    from ray_tpu_torch.data.block import BlockAccessor

    out = os.path.join(path, f"part-{index:05d}.csv")
    BlockAccessor(block).to_pandas().to_csv(out, index=False)
    return out


def write_block_json(block: Block, path: str, index: int) -> str:
    import json

    from ray_tpu_torch.data.block import BlockAccessor

    out = os.path.join(path, f"part-{index:05d}.jsonl")
    with open(out, "w") as f:
        for row in BlockAccessor(block).iter_rows():
            f.write(json.dumps(row, default=_json_default) + "\n")
    return out


def write_block_sql(block: Block, sql: str, connection_factory) -> int:
    """executemany one block's rows through a fresh DB-API connection.
    Values are converted to Python scalars (drivers reject numpy types)."""
    from ray_tpu_torch.data.block import BlockAccessor

    rows = []
    for row in BlockAccessor(block).iter_rows():
        rows.append(tuple(v.item() if isinstance(v, np.generic) else v
                          for v in row.values()))
    if not rows:
        return 0
    conn = connection_factory()
    try:
        conn.cursor().executemany(sql, rows)
        conn.commit()
    finally:
        conn.close()
    return len(rows)


def _json_default(v: Any):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"not JSON serializable: {type(v)}")
