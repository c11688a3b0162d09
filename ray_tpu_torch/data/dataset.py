"""Dataset: lazy transformation chain over blocks-as-refs (reference
capability: python/ray/data/dataset.py:186 — map/map_batches/filter/sort/
groupby/iter_batches/materialize/streaming_split on a logical plan executed
by the streaming executor).

Port of ray_tpu/data/dataset.py on the in-process runtime, with every
method of ray_tpu's Dataset, MaterializedDataset and GroupedData. The
counterpart of ``iter_jax_batches`` is ``iter_torch_batches(prefetch=k)``:
with ``k`` > 0 and a card device, ``device_prefetch`` copies ``k`` batches
ahead. A class UDF gets one instance per pool actor (executor.py).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.executor import (
    ActorPoolStrategy,
    HeldBlock,
    execute_plan,
    get_block,
    put_block,
    udf_instance,
)
from ray_tpu_torch.data.plan import (
    AllToAll,
    InputData,
    LimitOp,
    LogicalOp,
    MapBlocks,
    make_filter_fn,
    make_flat_map_fn,
    make_map_batches_fn,
    make_map_rows_fn,
    plan_stages,
)
from ray_tpu_torch.data import shuffle as _shuffle
from ray_tpu_torch.data.shuffle import AggregateFn


def _api():
    import ray_tpu_torch

    return ray_tpu_torch


def _task_arg(ref):
    """A block ref as a task argument (a held block goes by value)."""
    return ref.block if isinstance(ref, HeldBlock) else ref


class Dataset:
    def __init__(self, ops: list[LogicalOp]):
        self._ops = ops

    # -- transforms (lazy) --------------------------------------------------

    def _with(self, op: LogicalOp) -> "Dataset":
        return Dataset(self._ops + [op])

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._with(MapBlocks(make_map_rows_fn(fn), label="Map"))

    def flat_map(self, fn: Callable[[dict], list]) -> "Dataset":
        return self._with(MapBlocks(make_flat_map_fn(fn), label="FlatMap"))

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._with(MapBlocks(make_filter_fn(fn), label="Filter"))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: int | None = None,
        batch_format: str = "numpy",
        compute: ActorPoolStrategy | None = None,
        fn_args: tuple = (),
        fn_kwargs: dict | None = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: dict | None = None,
    ) -> "Dataset":
        if isinstance(fn, type):
            # Class-based UDF → stateful actor-pool map: each pool actor
            # instantiates the class once and reuses it across blocks.
            compute = compute or ActorPoolStrategy()
            cls = fn
            ctor_kwargs = fn_constructor_kwargs or {}
            inst_holder: dict = {}
            key = object()

            def call(batch, *a, **kw):
                inst = udf_instance(
                    key, lambda: cls(*fn_constructor_args, **ctor_kwargs),
                    inst_holder)
                return inst(batch, *a, **kw)

            fn = call
        return self._with(
            MapBlocks(
                make_map_batches_fn(
                    fn, batch_size=batch_size, batch_format=batch_format,
                    fn_args=fn_args, fn_kwargs=fn_kwargs,
                ),
                label="MapBatches",
                compute=compute,
            )
        )

    def select_columns(self, cols: list[str]) -> "Dataset":
        def block_fn(block: Block) -> Block:
            return {k: block[k] for k in cols}

        return self._with(MapBlocks(block_fn, label="SelectColumns"))

    def drop_columns(self, cols: list[str]) -> "Dataset":
        drop = set(cols)

        def block_fn(block: Block) -> Block:
            return {k: v for k, v in block.items() if k not in drop}

        return self._with(MapBlocks(block_fn, label="DropColumns"))

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]) -> "Dataset":
        def block_fn(block: Block) -> Block:
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return out

        return self._with(MapBlocks(block_fn, label="AddColumn"))

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        def block_fn(block: Block) -> Block:
            return {mapping.get(k, k): v for k, v in block.items()}

        return self._with(MapBlocks(block_fn, label="RenameColumns"))

    def limit(self, n: int) -> "Dataset":
        return self._with(LimitOp(n))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(
            AllToAll(_shuffle.make_sort_fn(key, descending, _api()),
                     label="Sort")
        )

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        return self._with(
            AllToAll(_shuffle.make_random_shuffle_fn(seed, _api()),
                     label="RandomShuffle")
        )

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(
            AllToAll(_shuffle.make_repartition_fn(num_blocks, _api()),
                     label="Repartition")
        )

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def join(self, other: "Dataset", on: str, how: str = "inner",
             ) -> "Dataset":
        """Hash join on column ``on`` (reference: Dataset.join, join.py —
        both sides hash-partition on the key, partitions join pairwise).
        ``how``: "inner" or "left". Right-side column collisions get an
        ``_r`` suffix."""
        if how not in ("inner", "left"):
            raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
        return self._with(
            AllToAll(_shuffle.make_join_fn(other, on, how, _api()),
                     label=f"Join({how})"))

    def union(self, *others: "Dataset") -> "Dataset":
        mats = [self.materialize()] + [o.materialize() for o in others]
        refs = list(itertools.chain.from_iterable(m._refs_meta for m in mats))
        return Dataset([InputData(block_refs=refs)])

    def zip(self, other: "Dataset") -> "Dataset":
        left = self.materialize()
        right = other.materialize()
        lb = concat_blocks([get_block(r, _api()) for r, _ in left._refs_meta])
        rb = concat_blocks([get_block(r, _api()) for r, _ in right._refs_meta])
        ln, rn = BlockAccessor(lb).num_rows(), BlockAccessor(rb).num_rows()
        if ln != rn:
            raise ValueError(f"zip requires equal row counts ({ln} vs {rn})")
        merged = dict(lb)
        for k, v in rb.items():
            merged[k if k not in merged else f"{k}_1"] = v
        from ray_tpu_torch.data import from_blocks

        return from_blocks([merged])

    # -- execution ----------------------------------------------------------

    def _execute(self) -> Iterator[tuple[Any, dict]]:
        return execute_plan(plan_stages(self._ops), api=_api())

    def iter_block_refs(self) -> Iterator[tuple[Any, dict]]:
        return self._execute()

    def materialize(self) -> "MaterializedDataset":
        refs = list(self._execute())
        return MaterializedDataset(refs)

    def iter_rows(self) -> Iterator[dict]:
        api = _api()
        for ref, _meta in self._execute():
            yield from BlockAccessor(get_block(ref, api)).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: int | None = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: int | None = None,
        local_shuffle_seed: int | None = None,
    ) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import batches_from_refs

        yield from batches_from_refs(
            self._execute(), _api(),
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            shuffle_buffer_size=local_shuffle_buffer_size,
            shuffle_seed=local_shuffle_seed,
        )

    def iter_torch_batches(
        self,
        *,
        batch_size: int | None = 256,
        dtypes=None,
        device: str = "cpu",
        drop_last: bool = False,
        local_shuffle_buffer_size: int | None = None,
        local_shuffle_seed: int | None = None,
        prefetch: int = 0,
    ) -> Iterator[Any]:
        """Batches as dicts of torch tensors (reference:
        Dataset.iter_torch_batches — dataset.py:5650 family). ``dtypes``
        maps column name → torch dtype (or one dtype for all columns).
        ``prefetch`` > 0 is ray_tpu's ``iter_jax_batches``: a thread copies
        that many batches ahead onto ``device`` (``device_prefetch``)."""
        from ray_tpu_torch.data.iterator import torch_batches

        yield from torch_batches(
            self.iter_batches(
                batch_size=batch_size, batch_format="numpy",
                drop_last=drop_last,
                local_shuffle_buffer_size=local_shuffle_buffer_size,
                local_shuffle_seed=local_shuffle_seed),
            dtypes=dtypes, device=device, prefetch=prefetch)

    def take(self, n: int = 20) -> list[dict]:
        out = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        total = 0
        api = _api()
        for ref, meta in self._execute():
            n = meta.get("num_rows", -1)
            if n < 0:
                n = BlockAccessor(get_block(ref, api)).num_rows()
            total += n
        return total

    def schema(self) -> dict[str, str] | None:
        for ref, _meta in self._execute():
            block = get_block(ref, _api())
            if BlockAccessor(block).num_rows() >= 0 and block:
                return BlockAccessor(block).schema()
        return None

    def columns(self) -> list[str]:
        s = self.schema()
        return list(s.keys()) if s else []

    def num_blocks(self) -> int:
        return sum(1 for _ in self._execute())

    # -- aggregates ---------------------------------------------------------

    def aggregate(self, *aggs: AggregateFn) -> dict:
        ds = self._with(
            AllToAll(_shuffle.make_global_aggregate_fn(list(aggs), _api()),
                     label="Aggregate")
        )
        rows = ds.take_all()
        return rows[0] if rows else {}

    def sum(self, col: str):
        return self.aggregate(_shuffle.Sum(col)).get(f"sum({col})")

    def min(self, col: str):
        return self.aggregate(_shuffle.Min(col)).get(f"min({col})")

    def max(self, col: str):
        return self.aggregate(_shuffle.Max(col)).get(f"max({col})")

    def mean(self, col: str):
        return self.aggregate(_shuffle.Mean(col)).get(f"mean({col})")

    def std(self, col: str):
        return self.aggregate(_shuffle.Std(col)).get(f"std({col})")

    # -- splits / conversion ------------------------------------------------

    def split(self, n: int) -> list["MaterializedDataset"]:
        mat = self.materialize()
        api = _api()
        blocks = [get_block(r, api) for r, _ in mat._refs_meta]
        merged = concat_blocks(blocks)
        from ray_tpu_torch.data.block import split_block

        parts = split_block(merged, n)
        return [MaterializedDataset([(put_block(p, api),
                                      {"num_rows": BlockAccessor(p).num_rows()})])
                for p in parts]

    def streaming_split(self, n: int, *, equal: bool = False):
        from ray_tpu_torch.data.iterator import make_streaming_split

        return make_streaming_split(self, n, equal=equal)

    def to_pandas(self):
        api = _api()
        blocks = [get_block(r, api) for r, _ in self.materialize()._refs_meta]
        return BlockAccessor(concat_blocks(blocks)).to_pandas()

    def to_numpy_refs(self) -> list:
        return [r for r, _ in self.materialize()._refs_meta]

    # -- writes -------------------------------------------------------------

    def _write(self, path: str, write_fn) -> list[str]:
        import os

        os.makedirs(path, exist_ok=True)
        api = _api()
        ctx = DataContext.get_current()
        write_remote = api.remote(num_cpus=ctx.task_num_cpus)(write_fn)
        refs = [
            write_remote.remote(_task_arg(ref), path, i)
            for i, (ref, _m) in enumerate(self._execute())
        ]
        return api.get(refs)

    def write_parquet(self, path: str) -> list[str]:
        from ray_tpu_torch.data.datasource import write_block_parquet

        return self._write(path, write_block_parquet)

    def write_csv(self, path: str) -> list[str]:
        from ray_tpu_torch.data.datasource import write_block_csv

        return self._write(path, write_block_csv)

    def write_json(self, path: str) -> list[str]:
        from ray_tpu_torch.data.datasource import write_block_json

        return self._write(path, write_block_json)

    def write_sql(self, sql: str, connection_factory) -> int:
        """Insert every row through a DB-API 2.0 connection (reference:
        Dataset.write_sql). ``sql`` is an INSERT with positional
        placeholders matching the block's column order; each block runs
        one executemany in its own remote task. Returns rows written."""
        from ray_tpu_torch.data.datasource import write_block_sql

        api = _api()
        ctx = DataContext.get_current()
        write_remote = api.remote(num_cpus=ctx.task_num_cpus)(write_block_sql)
        refs = [write_remote.remote(_task_arg(ref), sql, connection_factory)
                for ref, _m in self._execute()]
        return sum(api.get(refs))

    def __repr__(self) -> str:
        labels = [getattr(op, "label", type(op).__name__) for op in self._ops]
        return f"Dataset({' -> '.join(labels)})"


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are already in the object store (reference
    capability: Dataset.materialize :6493)."""

    def __init__(self, refs_meta: list[tuple[Any, dict]]):
        super().__init__([InputData(block_refs=list(refs_meta))])
        self._refs_meta = list(refs_meta)

    def materialize(self) -> "MaterializedDataset":
        return self

    def num_blocks(self) -> int:
        return len(self._refs_meta)

    def count(self) -> int:
        total = 0
        api = _api()
        for ref, meta in self._refs_meta:
            n = meta.get("num_rows", -1)
            if n < 0:
                n = BlockAccessor(get_block(ref, api)).num_rows()
            total += n
        return total


class GroupedData:
    """Result of Dataset.groupby (reference capability:
    python/ray/data/grouped_data.py)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return self._ds._with(
            AllToAll(_shuffle.make_groupby_fn(self._key, list(aggs), _api()),
                     label=f"GroupBy({self._key})")
        )

    def count(self) -> Dataset:
        return self.aggregate(_shuffle.Count())

    def sum(self, col: str) -> Dataset:
        return self.aggregate(_shuffle.Sum(col))

    def min(self, col: str) -> Dataset:
        return self.aggregate(_shuffle.Min(col))

    def max(self, col: str) -> Dataset:
        return self.aggregate(_shuffle.Max(col))

    def mean(self, col: str) -> Dataset:
        return self.aggregate(_shuffle.Mean(col))

    def std(self, col: str) -> Dataset:
        return self.aggregate(_shuffle.Std(col))

    def map_groups(self, fn: Callable[[Block], Any]) -> Dataset:
        """Shuffle by key, then apply fn per group within each partition."""
        key = self._key

        def per_partition(block: Block) -> Block:
            acc = BlockAccessor(block)
            if acc.num_rows() == 0:
                return block
            keys = block[key]
            if keys.dtype.kind == "O":
                uniq = {}
                for i, k in enumerate(keys):
                    uniq.setdefault(str(k), []).append(i)
                groups = [np.asarray(v) for v in uniq.values()]
            else:
                vals, inverse = np.unique(keys, return_inverse=True)
                groups = [np.nonzero(inverse == g)[0]
                          for g in range(len(vals))]
            outs = []
            for idx in groups:
                from ray_tpu_torch.data.block import batch_to_block

                outs.append(batch_to_block(fn(acc.take_rows(idx))))
            return concat_blocks(outs)

        shuffled = self._ds._with(
            AllToAll(
                _shuffle.make_groupby_shuffle_only_fn(key, _api()),
                label=f"ShuffleBy({key})",
            )
        )
        return shuffled._with(MapBlocks(per_partition, label="MapGroups"))
