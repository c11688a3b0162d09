"""ray_tpu_torch.data's ops against ray_tpu.data's on the same inputs.

Each case of tests/test_data.py builds its dataset with one data module
and runs once under ``ray_tpu.init`` with ``ray_tpu.data``, then under
``ray_tpu_torch.init`` with ``ray_tpu_torch.data`` (never nested; each
runtime shut down in a ``finally``). The outputs must be equal.

Row order: every op here gives a deterministic order in ray_tpu.data,
so every case compares in order. Reads and map stages release blocks in
input order; actor pools too (outputs are re-sequenced); sort is a
stable sort; ``random_shuffle(seed)`` and local shuffles draw from numpy
with the same seeds (bit-equal rows in the same order); groupby, joins
and ``map_groups`` partition by the stable hash and emit keys in
``np.unique`` order; ``streaming_split`` round-robins blocks over the
splits, so each split's rows are compared in order.
"""

import math
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata

SIDES = (("jax", ray_tpu, jdata), ("torch", ray_tpu_torch, tdata))


def _norm(x):
    """A comparable form of an op's output (numpy scalars and arrays as
    lists with their dtype, NaN as a marker)."""
    if isinstance(x, dict):
        return [(k, _norm(v)) for k, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, _norm(x.tolist()))
    if isinstance(x, np.generic):
        return _norm(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def run_both(case, **init_kw):
    out = {}
    for side, rt, rd in SIDES:
        rt.shutdown()
        rt.init(num_cpus=8, **init_kw)
        try:
            out[side] = _norm(case(rd))
        finally:
            rt.shutdown()
    return out["jax"], out["torch"]


class _AddState:
    def __init__(self):
        self.offset = 100

    def __call__(self, batch):
        return {"id": batch["id"] + self.offset}


def _add_col(df):
    df = df.copy()
    df["y"] = df["id"] + 1
    return df


def _norm_group(group):
    return {"k": group["k"], "v": group["v"] - group["v"].mean()}


def _perm(n, seed=0):
    return np.random.default_rng(seed).permutation(n).tolist()


CASES = {
    "range_count_take": lambda rd: (rd.range(100).count(),
                                    rd.range(100).take(5)),
    "from_items_rows": lambda rd: (
        rd.from_items([{"a": 1}, {"a": 2}, {"a": 3}]).take_all(),
        rd.from_items([10, 20]).take_all()),
    "map_filter_flat_map_fusion": lambda rd: (
        rd.range(50).map(lambda r: {"id": r["id"] * 2})
        .filter(lambda r: r["id"] % 4 == 0)
        .flat_map(lambda r: [r, r]).take_all()),
    "map_batches_numpy": lambda rd: rd.range(32).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2},
        batch_size=10).take_all(),
    "map_batches_pandas": lambda rd: rd.range(10).map_batches(
        _add_col, batch_format="pandas").take_all(),
    "map_batches_actor_pool": lambda rd: rd.range(20).map_batches(
        _AddState,
        compute=rd.ActorPoolStrategy(size=2, num_cpus=0.5)).take_all(),
    "columns_ops": lambda rd: [
        f(rd.from_items([{"a": 1, "b": 2}, {"a": 3, "b": 4}])).take_all()
        for f in (lambda d: d.select_columns(["a"]),
                  lambda d: d.drop_columns(["b"]),
                  lambda d: d.rename_columns({"a": "x"}),
                  lambda d: d.add_column("c",
                                         lambda b: b["a"] + b["b"]))],
    "limit_streaming": lambda rd: (rd.range(1000).limit(17).count(),
                                   rd.range(1000).limit(17).take_all()),
    "sort": lambda rd: [
        rd.from_items([{"v": v} for v in _perm(200)])
        .sort("v", descending=d).take_all() for d in (False, True)],
    "random_shuffle": lambda rd: rd.range(100).random_shuffle(
        seed=42).take_all(),
    "repartition": lambda rd: (lambda m: (m.num_blocks(), m.count(),
                                          m.take_all()))(
        rd.range(100, parallelism=10).repartition(3).materialize()),
    "groupby_sum": lambda rd: rd.from_items(
        [{"k": i % 3, "v": float(i)} for i in range(30)])
        .groupby("k").sum("v").take_all(),
    "groupby_count_mean_min_max_std": lambda rd: [
        f(rd.from_items([{"k": "a" if i < 10 else "b", "v": i}
                         for i in range(25)]).groupby("k")).take_all()
        for f in (lambda g: g.count(), lambda g: g.mean("v"),
                  lambda g: g.min("v"), lambda g: g.max("v"),
                  lambda g: g.std("v"))],
    "global_aggregates": lambda rd: [
        getattr(rd.range(100), f)("id")
        for f in ("sum", "min", "max", "mean", "std")],
    "aggregate_many": lambda rd: rd.range(50).aggregate(
        rd.Count(), rd.Sum("id"), rd.Mean("id")),
    "iter_batches": lambda rd: [
        list(rd.range(100).iter_batches(batch_size=32, drop_last=d))
        for d in (False, True)],
    "iter_batches_local_shuffle": lambda rd: list(
        rd.range(100, parallelism=4).iter_batches(
            batch_size=16, local_shuffle_buffer_size=32,
            local_shuffle_seed=5)),
    "split": lambda rd: [p.take_all() for p in rd.range(90).split(3)],
    "streaming_split": lambda rd: [
        [r["id"] for r in it.iter_rows()]
        for it in rd.range(60, parallelism=6).streaming_split(2)],
    "union_zip": lambda rd: (
        rd.range(5).union(rd.range(5)).take_all(),
        rd.from_items([{"a": 1}, {"a": 2}]).zip(
            rd.from_items([{"b": 10}, {"b": 20}])).take_all()),
    "schema_to_pandas_columns": lambda rd: (
        rd.range(10).schema(), rd.range(10).to_pandas()["id"].tolist(),
        rd.range(10).columns(), rd.range(10, parallelism=3).num_blocks()),
    "map_groups": lambda rd: rd.from_items(
        [{"k": i % 4, "v": float(i)} for i in range(40)])
        .groupby("k").map_groups(_norm_group).take_all(),
    "inner_join": lambda rd: rd.from_items(
        [{"id": i, "a": i * 10} for i in range(8)]).join(
        rd.from_items([{"id": i, "b": i * 100} for i in range(4, 12)]),
        on="id").take_all(),
    "left_join": lambda rd: rd.from_items(
        [{"id": i, "a": i} for i in range(4)]).join(
        rd.from_items([{"id": 1, "b": 11.0}, {"id": 3, "b": 33.0}]),
        on="id", how="left").take_all(),
    "join_collision": lambda rd: rd.from_items([{"id": 1, "v": "L"}]).join(
        rd.from_items([{"id": 1, "v": "R"}]), on="id").take_all(),
    "from_numpy_blocks": lambda rd: (
        rd.from_numpy(np.arange(12).reshape(6, 2)).take_all(),
        rd.from_blocks([{"x": np.arange(3)}, {"x": np.arange(4)}])
        .map_batches(lambda b: {"x": b["x"] * 2}).take_all()),
    "from_pandas_arrow": lambda rd: (
        rd.from_pandas(__import__("pandas").DataFrame(
            {"a": [1, 2], "b": ["x", "y"]})).take_all(),
        rd.from_arrow(__import__("pyarrow").table(
            {"a": [3, 4]})).take_all()),
    "from_huggingface": lambda rd: rd.from_huggingface(
        __import__("datasets").Dataset.from_dict(
            {"x": list(range(12)), "y": [i * 2 for i in range(12)]}),
        rows_per_block=5).take_all(),
    "take_show_count_after_map": lambda rd: (
        rd.range(30).map(lambda r: {"id": r["id"] + 1}).take(4),
        rd.range(30).filter(lambda r: r["id"] % 3 == 0).count()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_ray_tpu_data(name):
    want, got = run_both(CASES[name])
    assert got == want


def test_stable_hash_and_partitioners_match():
    """The shuffle's partitioners draw and hash as ray_tpu's (no runtime)."""
    from ray_tpu.data import shuffle as js
    from ray_tpu_torch.data import shuffle as ts

    for col in (np.arange(64), np.linspace(-3, 3, 64),
                np.asarray([f"k{i % 7}" for i in range(64)], object)):
        assert ts._stable_hash(col).tolist() == js._stable_hash(col).tolist()
    block = {"k": np.arange(40) % 9, "v": np.arange(40.0)}
    for got, want in ((ts._partition_random(block, 4, 11),
                       js._partition_random(block, 4, 11)),
                      (ts._partition_by_hash(block, "k", 4),
                       js._partition_by_hash(block, "k", 4))):
        assert _norm(list(got)) == _norm(list(want))


def test_shuffle_partitions_and_byte_budget_match():
    from ray_tpu.data.context import DataContext as JCtx
    from ray_tpu.data.shuffle import shuffle_partitions as jsp
    from ray_tpu_torch.data.context import DataContext as TCtx
    from ray_tpu_torch.data.shuffle import shuffle_partitions as tsp

    for sizes in ([10] * 3, [1 << 20] * 40, [200 << 20] * 5):
        refs = [(None, {"size_bytes": s}) for s in sizes]
        assert tsp(refs, TCtx()) == jsp(refs, JCtx())


def test_actor_pool_num_gpus_takes_the_gpu_resource():
    """ActorPoolStrategy(num_gpus=) is num_tpus's counterpart: the pool's
    actors hold the runtime's "GPU" while they run, and give it back
    before the dataset's iteration returns."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    try:
        seen = []

        class OnCard:
            def __call__(self, batch):
                seen.append(ray_tpu_torch.get_runtime_context()
                            .get_assigned_resources())
                return batch

        rows = tdata.range(8, parallelism=4).map_batches(
            OnCard, compute=tdata.ActorPoolStrategy(
                size=2, num_gpus=0.5)).take_all()
        assert [r["id"] for r in rows] == list(range(8))
        assert seen and all(s.get("GPU") == 0.5 for s in seen)
        assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    finally:
        ray_tpu_torch.shutdown()


def test_class_udf_gets_one_instance_per_pool_actor():
    """Pool actors are threads here: each still builds its own instance of
    a class UDF (ray_tpu's actors are processes, each with its copy)."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    made = []
    try:
        class Counted:
            def __init__(self):
                made.append(threading.get_ident())

            def __call__(self, batch):
                time.sleep(0.02)
                return batch

        n = tdata.range(40, parallelism=8).map_batches(
            Counted, compute=tdata.ActorPoolStrategy(size=2)).count()
        assert n == 40
        assert len(made) == 2 and len(set(made)) == 2
    finally:
        ray_tpu_torch.shutdown()


def test_reading_blocks_in_memory_starts_no_runtime():
    ray_tpu_torch.shutdown()
    ds = tdata.from_blocks([{"x": np.arange(5)}, {"x": np.arange(3)}])
    assert ds.count() == 8 and ds.num_blocks() == 2
    assert [len(b["x"]) for b in ds.iter_batches(batch_size=3)] == [3, 3, 2]
    assert not ray_tpu_torch.is_initialized()


def test_device_prefetch_gives_the_same_batches_in_order():
    """iter_torch_batches(prefetch=k) (ray_tpu's iter_jax_batches) hands
    over ray_tpu's iter_torch_batches batches, in order, with dtypes."""
    import torch

    def case(rd):
        ds = rd.range(50, parallelism=3).map_batches(
            lambda b: {"id": b["id"], "x": b["id"] * 0.5})
        return [{k: v.tolist() for k, v in b.items()}
                for b in ds.iter_torch_batches(
                    batch_size=8, dtypes={"x": torch.float16})]

    want, plain = run_both(case)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        ds = tdata.range(50, parallelism=3).map_batches(
            lambda b: {"id": b["id"], "x": b["id"] * 0.5})
        got = list(ds.iter_torch_batches(batch_size=8, prefetch=2,
                                         dtypes={"x": torch.float16}))
        assert got[0]["x"].dtype == torch.float16
        assert _norm([{k: v.tolist() for k, v in b.items()}
                      for b in got]) == want == plain
    finally:
        ray_tpu_torch.shutdown()


def test_device_prefetch_early_break_releases_producer():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        ds = tdata.from_items([{"x": float(i)} for i in range(512)])
        for _batch in ds.iter_torch_batches(batch_size=8, prefetch=2):
            break  # abandon early
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and [
                t for t in threading.enumerate()
                if t.name == "data-device-prefetch" and t.is_alive()]:
            time.sleep(0.05)
        assert not [t for t in threading.enumerate()
                    if t.name == "data-device-prefetch" and t.is_alive()]
    finally:
        ray_tpu_torch.shutdown()


def test_actor_pools_with_num_gpus_give_the_gpu_back_20_times():
    """The pool's shutdown waits until its killed actors have released
    their resources: right after each iteration the GPU is whole."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    try:
        for i in range(20):
            n = tdata.range(16, parallelism=4).map_batches(
                _AddState, compute=tdata.ActorPoolStrategy(
                    size=2, num_gpus=0.5)).count()
            assert n == 16
            assert ray_tpu_torch.available_resources()["GPU"] == 1.0, i
    finally:
        ray_tpu_torch.shutdown()


def test_actor_pool_autoscales_up_and_down():
    """tests/test_data.py's elastic pool on the port's runtime: a deep
    queue grows it toward max_size, idleness shrinks it to min_size."""
    from ray_tpu_torch.data.context import DataContext
    from ray_tpu_torch.data.executor import _StageExec
    from ray_tpu_torch.data.plan import FusedMapStage

    def slow(block):
        time.sleep(0.2)
        return block

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    comp = tdata.ActorPoolStrategy(min_size=1, max_size=3, num_cpus=0.1)
    ex = _StageExec(FusedMapStage(block_fn=slow, label="t", compute=comp),
                    DataContext.get_current(), ray_tpu_torch, n_stages=1)
    ex.POOL_IDLE_S = 0.2
    try:
        for _ in range(12):
            ex.input_queue.append((ray_tpu_torch.put({"id": np.arange(4)}),
                                   {"num_rows": 4, "size_bytes": 32}))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (ex.input_queue
                                               or ex.in_flight):
            ex.launch()
            if ex.in_flight:
                ready, _ = ray_tpu_torch.wait(list(ex.in_flight),
                                              num_returns=1, timeout=0.2)
                ex.collect_ready(ready)
        assert len(ex._pool) > 1, "pool never scaled up"
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and len(ex._pool) > 1:
            ex.launch()
            time.sleep(0.05)
        assert len(ex._pool) == 1 and len(ex.outputs) == 12
    finally:
        ex.shutdown()
        ray_tpu_torch.shutdown()


def test_every_public_name_of_ray_tpu_data_is_ported():
    assert set(jdata.__all__) <= set(tdata.__all__)
    assert all(hasattr(tdata, n) for n in jdata.__all__)
    for cls in ("Dataset", "MaterializedDataset", "GroupedData",
                "DataIterator"):
        want = {m for m in dir(getattr(jdata, cls)) if not m.startswith("_")}
        got = {m for m in dir(getattr(tdata, cls)) if not m.startswith("_")}
        assert want - got <= {"iter_jax_batches"}, (cls, want - got)
