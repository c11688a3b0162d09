"""Distributed shuffle ops: sort / random_shuffle / repartition / groupby.

Reference capability: python/ray/data/_internal/execution/operators/
hash_shuffle.py + sort.py — two-round map/reduce over blocks-as-refs:
map tasks partition each block (num_returns=P), reduce tasks combine the
pieces of one partition. All data movement stays in the object store.

Port of ray_tpu/data/shuffle.py: the same partitioners, seeds and
stable hash, so the port's shuffles give ray_tpu.data's rows.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.context import DataContext


def _meta(block: Block) -> dict:
    acc = BlockAccessor(block)
    # size_bytes rides along so downstream all-to-alls can size their
    # partition count from real bytes (shuffle_partitions) — without it a
    # chained shuffle would fall back to the 8-partition floor.
    return {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}


# -- map-side partitioners (run as remote tasks, num_returns=P) -------------


def _partition_by_boundaries(block: Block, key: str, boundaries: np.ndarray,
                             descending: bool):
    col = block.get(key)
    if col is None or len(col) == 0:
        return tuple({} for _ in range(len(boundaries) + 1))
    idx = np.searchsorted(boundaries, col, side="right")
    acc = BlockAccessor(block)
    parts = []
    for p in range(len(boundaries) + 1):
        parts.append(acc.take_rows(np.nonzero(idx == p)[0]))
    if descending:
        parts = parts[::-1]
    return tuple(parts)


def _partition_random(block: Block, num_parts: int, seed: int):
    acc = BlockAccessor(block)
    n = acc.num_rows()
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, num_parts, size=n)
    return tuple(acc.take_rows(np.nonzero(assign == p)[0])
                 for p in range(num_parts))


def _stable_hash(col: np.ndarray) -> np.ndarray:
    """Process-independent per-value hashes. Python's hash() is SipHash
    salted per interpreter — partition tasks running in different worker
    processes would route the same key to different partitions, silently
    dropping join matches / splitting groups."""
    import zlib

    if col.dtype.kind in "iu":
        v = col.astype(np.uint64, copy=False)
    elif col.dtype.kind == "f":
        v = col.astype(np.float64, copy=False).view(np.uint64)
    elif col.dtype.kind == "b":
        v = col.astype(np.uint64)
    else:  # strings/objects: stable byte-level CRC per value
        return np.fromiter(
            (zlib.crc32(str(x).encode()) for x in col),
            dtype=np.uint64, count=len(col))
    # splitmix64 finalizer — deterministic, well-mixed, fully vectorized.
    v = (v + np.uint64(0x9E3779B97F4A7C15))
    v ^= v >> np.uint64(30)
    v *= np.uint64(0xBF58476D1CE4E5B9)
    v ^= v >> np.uint64(27)
    v *= np.uint64(0x94D049BB133111EB)
    v ^= v >> np.uint64(31)
    return v


def _partition_by_hash(block: Block, key: str, num_parts: int):
    col = block.get(key)
    acc = BlockAccessor(block)
    if col is None or len(col) == 0:
        return tuple({} for _ in range(num_parts))
    with np.errstate(over="ignore"):
        assign = _stable_hash(col) % np.uint64(num_parts)
    return tuple(acc.take_rows(np.nonzero(assign == p)[0])
                 for p in range(num_parts))


# -- reduce-side -------------------------------------------------------------


def _merge_sorted(key: str, descending: bool, *parts: Block):
    merged = concat_blocks(list(parts))
    if not merged:
        return merged, _meta(merged)
    order = np.argsort(merged[key], kind="stable")
    if descending:
        order = order[::-1]
    out = BlockAccessor(merged).take_rows(order)
    return out, _meta(out)


def _merge_plain(seed: int, *parts: Block):
    merged = concat_blocks(list(parts))
    if merged and seed >= 0:
        rng = np.random.default_rng(seed)
        order = rng.permutation(BlockAccessor(merged).num_rows())
        merged = BlockAccessor(merged).take_rows(order)
    return merged, _meta(merged)


def _merge_aggregate(key: str, aggs: list, *parts: Block):
    merged = concat_blocks(list(parts))
    out = aggregate_block(merged, key, aggs)
    return out, _meta(out)


def _sample_boundaries(block: Block, key: str, num_samples: int):
    col = block.get(key)
    if col is None or len(col) == 0:
        return np.array([])
    idx = np.random.default_rng(len(col)).integers(
        0, len(col), size=min(num_samples, len(col))
    )
    return np.asarray(col[idx])


# -- aggregation kernel ------------------------------------------------------


class AggregateFn:
    """(name, init, accumulate(np column)->partial, merge, finalize)."""

    def __init__(self, out_name: str, column: str | None, np_fn: Callable,
                 finalize: Callable | None = None):
        self.out_name = out_name
        self.column = column
        self.np_fn = np_fn
        self.finalize = finalize


def Count() -> AggregateFn:
    return AggregateFn("count()", None, lambda c: len(c))


def Sum(col: str) -> AggregateFn:
    return AggregateFn(f"sum({col})", col, np.sum)


def Min(col: str) -> AggregateFn:
    return AggregateFn(f"min({col})", col, np.min)


def Max(col: str) -> AggregateFn:
    return AggregateFn(f"max({col})", col, np.max)


def Mean(col: str) -> AggregateFn:
    return AggregateFn(f"mean({col})", col, np.mean)


def Std(col: str) -> AggregateFn:
    return AggregateFn(f"std({col})", col, lambda c: np.std(c, ddof=1))


def aggregate_block(block: Block, key: str | None, aggs: list[AggregateFn]) -> Block:
    """Group `block` by `key` (None = global) and apply aggs per group."""
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        cols = ([] if key is None else [key]) + [a.out_name for a in aggs]
        return {c: np.array([]) for c in cols}
    if key is None:
        out: Block = {}
        for a in aggs:
            col = block[a.column] if a.column else next(iter(block.values()))
            out[a.out_name] = np.asarray([a.np_fn(col)])
        return out
    keys = block[key]
    if keys.dtype.kind == "O":
        uniq, inverse = np.unique(np.asarray([str(k) for k in keys]),
                                  return_inverse=True)
        uniq_vals = []
        seen = {}
        for i, k in enumerate(keys):
            s = str(k)
            if s not in seen:
                seen[s] = k
        uniq_vals = np.asarray([seen[u] for u in uniq], dtype=object)
    else:
        uniq_vals, inverse = np.unique(keys, return_inverse=True)
    out = {key: uniq_vals}
    for a in aggs:
        col = block[a.column] if a.column else keys
        vals = []
        for g in range(len(uniq_vals)):
            vals.append(a.np_fn(col[inverse == g]))
        out[a.out_name] = np.asarray(vals)
    return out


# -- AllToAll builders (driver-side; each returns fn(list[(ref,meta)])) ------


def shuffle_partitions(refs_meta, ctx) -> int:
    """All-to-all fan-out: at least the configured default (capped by the
    block count), grown so each reduce partition targets at most
    target_shuffle_partition_bytes of data — a reduce task materializes
    one partition in memory, so this bound (not the dataset size) is what
    its footprint scales with. Blocks between rounds live as object-store
    refs, and the arena spills to disk under pressure: together that is
    the external-sort path."""
    n = len(refs_meta)
    base = max(1, min(ctx.default_shuffle_partitions, n))
    total = sum((m or {}).get("size_bytes", 0) for _, m in refs_meta)
    by_bytes = -(-total // max(1, ctx.target_shuffle_partition_bytes))
    return max(base, min(int(by_bytes), ctx.max_shuffle_partitions))


def _two_round(api, refs_meta, partition_fn, partition_args,
               reduce_fn, reduce_args, num_parts: int):
    ctx = DataContext.get_current()
    part_remote = api.remote(num_cpus=ctx.task_num_cpus,
                             num_returns=num_parts)(partition_fn)
    red_remote = api.remote(num_cpus=ctx.task_num_cpus,
                            num_returns=2)(reduce_fn)
    part_refs = []  # per input block: list of P refs
    for ref, _m in refs_meta:
        out = part_remote.remote(ref, *partition_args)
        if num_parts == 1:
            out = [out]
        part_refs.append(out)
    results = []
    for p in range(num_parts):
        pieces = [pr[p] for pr in part_refs]
        out_ref, meta_ref = red_remote.remote(*reduce_args, *pieces)
        results.append((out_ref, meta_ref))
    return [(ref, api.get(meta_ref)) for ref, meta_ref in results]


def make_sort_fn(key: str, descending: bool, api):
    def run(refs_meta):
        if not refs_meta:
            return []
        ctx = DataContext.get_current()
        num_parts = shuffle_partitions(refs_meta, ctx)
        # ~20 samples per eventual boundary, spread over the blocks — a
        # fixed 20/block was sized for the old <=8-partition cap and makes
        # high fan-out boundaries far too noisy to honor the per-partition
        # byte target.
        per_block = min(1000, max(20, (20 * num_parts)
                                  // max(1, len(refs_meta)) + 1))
        sample = api.remote(num_cpus=0)(_sample_boundaries)
        samples = api.get(
            [sample.remote(ref, key, per_block) for ref, _ in refs_meta]
        )
        allv = np.concatenate([s for s in samples if len(s)]) if any(
            len(s) for s in samples
        ) else np.array([])
        if len(allv) == 0:
            num_parts = 1
            boundaries = np.array([])
        else:
            qs = np.linspace(0, 1, num_parts + 1)[1:-1]
            boundaries = np.unique(np.quantile(allv, qs))
            num_parts = len(boundaries) + 1
        return _two_round(
            api, refs_meta,
            _partition_by_boundaries, (key, boundaries, descending),
            _merge_sorted, (key, descending), num_parts,
        )

    return run


def make_random_shuffle_fn(seed: int | None, api):
    def run(refs_meta):
        if not refs_meta:
            return []
        ctx = DataContext.get_current()
        num_parts = shuffle_partitions(refs_meta, ctx)
        base = seed if seed is not None else 0xC0FFEE
        out = []
        part_remote = api.remote(num_cpus=ctx.task_num_cpus,
                                 num_returns=num_parts)(_partition_random)
        red_remote = api.remote(num_cpus=ctx.task_num_cpus,
                                num_returns=2)(_merge_plain)
        part_refs = []
        for i, (ref, _m) in enumerate(refs_meta):
            o = part_remote.remote(ref, num_parts, base + i)
            part_refs.append([o] if num_parts == 1 else o)
        for p in range(num_parts):
            pieces = [pr[p] for pr in part_refs]
            out_ref, meta_ref = red_remote.remote(base + 7919 * (p + 1), *pieces)
            out.append((out_ref, api.get(meta_ref)))
        return out

    return run


def make_repartition_fn(num_blocks: int, api):
    def run(refs_meta):
        ctx = DataContext.get_current()
        counts = []
        for ref, m in refs_meta:
            n = m.get("num_rows", -1)
            if n < 0:
                n = api.get(api.remote(num_cpus=0)(
                    lambda b: BlockAccessor(b).num_rows()).remote(ref))
            counts.append(n)
        total = sum(counts)
        sizes = [total // num_blocks + (1 if i < total % num_blocks else 0)
                 for i in range(num_blocks)]

        def slice_task(block, start, end):
            out = BlockAccessor(block).slice(start, end)
            return out

        slice_remote = api.remote(num_cpus=0)(slice_task)
        red_remote = api.remote(num_cpus=ctx.task_num_cpus, num_returns=2)(
            _merge_plain
        )
        # global row cursor → (block index, offset)
        pieces_per_out: list[list] = [[] for _ in range(num_blocks)]
        cursor = 0
        out_idx = 0
        filled = 0
        for (ref, _m), n in zip(refs_meta, counts):
            off = 0
            while off < n and out_idx < num_blocks:
                need = sizes[out_idx] - filled
                take = min(need, n - off)
                if take > 0:
                    pieces_per_out[out_idx].append(
                        slice_remote.remote(ref, off, off + take)
                    )
                off += take
                filled += take
                if filled == sizes[out_idx]:
                    out_idx += 1
                    filled = 0
            cursor += n
        out = []
        for p in range(num_blocks):
            out_ref, meta_ref = red_remote.remote(-1, *pieces_per_out[p])
            out.append((out_ref, api.get(meta_ref)))
        return out

    return run


def make_groupby_fn(key: str, aggs: list[AggregateFn], api):
    def run(refs_meta):
        if not refs_meta:
            return []
        ctx = DataContext.get_current()
        num_parts = shuffle_partitions(refs_meta, ctx)
        return _two_round(
            api, refs_meta,
            _partition_by_hash, (key, num_parts),
            _merge_aggregate, (key, aggs), num_parts,
        )

    return run


def make_groupby_shuffle_only_fn(key: str, api):
    """Hash-partition by key without aggregating (for map_groups): rows of
    one key land in exactly one output partition."""

    def run(refs_meta):
        if not refs_meta:
            return []
        ctx = DataContext.get_current()
        num_parts = shuffle_partitions(refs_meta, ctx)
        return _two_round(
            api, refs_meta,
            _partition_by_hash, (key, num_parts),
            _merge_plain, (-1,), num_parts,
        )

    return run


def make_global_aggregate_fn(aggs: list[AggregateFn], api):
    """Global (no-key) aggregate via exact sufficient statistics: per-block
    partials carry (count, sum, sumsq, min, max) per column; one combine task
    finalizes every agg from those."""

    def run(refs_meta):
        ctx = DataContext.get_current()
        columns = sorted({a.column for a in aggs if a.column})

        def partial(block):
            stats = {"__n": float(BlockAccessor(block).num_rows())}
            for c in columns:
                col = block.get(c)
                if col is None or len(col) == 0:
                    continue
                stats[c] = (float(len(col)), float(np.sum(col)),
                            float(np.sum(np.square(col.astype(np.float64)))),
                            float(np.min(col)), float(np.max(col)))
            return stats

        part_remote = api.remote(num_cpus=ctx.task_num_cpus)(partial)
        partials = [part_remote.remote(ref) for ref, _ in refs_meta]

        def combine(*parts):
            total_rows = sum(p["__n"] for p in parts)
            per_col = {}
            for c in columns:
                ss = [p[c] for p in parts if c in p]
                if not ss:
                    per_col[c] = None
                    continue
                n = sum(s[0] for s in ss)
                sm = sum(s[1] for s in ss)
                sq = sum(s[2] for s in ss)
                per_col[c] = (n, sm, sq, min(s[3] for s in ss),
                              max(s[4] for s in ss))
            out: Block = {}
            for a in aggs:
                if a.column is None:
                    out[a.out_name] = np.asarray([total_rows])
                    continue
                s = per_col.get(a.column)
                if s is None:
                    out[a.out_name] = np.asarray([np.nan])
                    continue
                n, sm, sq, mn, mx = s
                if a.out_name.startswith("sum("):
                    v = sm
                elif a.out_name.startswith("min("):
                    v = mn
                elif a.out_name.startswith("max("):
                    v = mx
                elif a.out_name.startswith("mean("):
                    v = sm / n
                elif a.out_name.startswith("std("):
                    v = float(np.sqrt(max(0.0, (sq - sm * sm / n) / (n - 1)))) \
                        if n > 1 else 0.0
                else:
                    v = n
                out[a.out_name] = np.asarray([v])
            return out, _meta(out)

        comb_remote = api.remote(num_cpus=ctx.task_num_cpus, num_returns=2)(
            combine
        )
        out_ref, meta_ref = comb_remote.remote(*partials)
        return [(out_ref, api.get(meta_ref))]

    return run


# -- joins (reference capability: Dataset.join/join.py — hash-partition both
#    sides on the key, then per-partition hash joins) ------------------------


def _merge_join(key: str, how: str, num_left: int, *parts: Block):
    """Join the concatenation of the first num_left parts (left side)
    against the rest (right side) on ``key``. Vectorized via sort +
    searchsorted; right-side column collisions get an ``_r`` suffix."""
    # num_parts == 1 ships the partition fn's whole 1-tuple in one ref.
    parts = tuple(p[0] if isinstance(p, tuple) else p for p in parts)
    left = concat_blocks([p for p in parts[:num_left] if len(p)])
    right = concat_blocks([p for p in parts[num_left:] if len(p)])
    empty = {}, {"num_rows": 0}
    la, ra = BlockAccessor(left), BlockAccessor(right)
    if la.num_rows() == 0:
        return empty
    if ra.num_rows() == 0 and how == "inner":
        return empty

    lk = left[key]
    rk = right[key] if ra.num_rows() > 0 else np.array([], dtype=lk.dtype)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo

    # Vectorized match-index construction: matched left rows repeat by
    # match count; their right indices are contiguous runs of `order`
    # starting at lo[i] (run-local offsets via a cumsum-reset trick).
    m_li = np.repeat(np.arange(len(lk)), counts)
    if len(m_li):
        starts = np.repeat(lo, counts)
        run_first = np.repeat(np.cumsum(counts) - counts, counts)
        offsets = np.arange(len(m_li)) - run_first
        m_ri = order[starts + offsets]
    else:
        m_ri = np.array([], dtype=np.int64)
    if how == "left":
        miss = np.nonzero(counts == 0)[0]
        li = np.concatenate([m_li, miss])
        ri = np.concatenate([m_ri, np.full(len(miss), -1)])
    else:
        li, ri = m_li, m_ri
    if len(li) == 0:
        return empty
    li = li.astype(np.int64)
    ri = ri.astype(np.int64)

    out: Block = {}
    for col in la.columns():
        out[col] = left[col][li]
    matched = ri >= 0
    # Schema comes from the raw parts: concat drops 0-row blocks, and a
    # match-less partition must still emit the right-side columns (as
    # misses) or the joined dataset's schema varies per block.
    right_cols = next((list(p.keys()) for p in parts[num_left:] if len(p)),
                      list(ra.columns()))
    for col in right_cols:
        if col == key:
            continue
        name = col if col not in out else f"{col}_r"
        rcol = right.get(col)
        if rcol is None:
            # concat dropped the 0-row blocks; a raw part still carries the
            # column's DTYPE, which decides NaN (numeric) vs None (object)
            # fill — a float default would put NaN into string columns.
            rcol = next((p[col] for p in parts[num_left:] if col in p),
                        np.array([]))
        if len(rcol) == 0 or not matched.any():
            # every output row is a left-join miss for this column
            out[name] = np.full(len(li), np.nan) if rcol.dtype.kind in "fiu" \
                else np.full(len(li), None, dtype=object)
            continue
        vals = rcol[np.where(matched, ri, 0)]
        if not matched.all():  # left-join misses -> NaN/None fill
            if vals.dtype.kind in "fiu":
                vals = vals.astype(np.float64)
                vals[~matched] = np.nan
            else:
                vals = vals.astype(object)
                vals[~matched] = None
        out[name] = vals
    return out, {"num_rows": len(li)}


def make_join_fn(right_dataset, key: str, how: str, api):
    """AllToAll builder: hash-partition both sides, join per partition."""

    def run(left_refs_meta):
        from ray_tpu_torch.data.executor import _to_store

        right_refs_meta = _to_store(list(right_dataset._execute()), api)
        ctx = DataContext.get_current()
        num_parts = max(shuffle_partitions(left_refs_meta, ctx),
                        shuffle_partitions(right_refs_meta, ctx), 1)
        part_remote = api.remote(num_cpus=ctx.task_num_cpus,
                                 num_returns=num_parts)(_partition_by_hash)
        join_remote = api.remote(num_cpus=ctx.task_num_cpus,
                                 num_returns=2)(_merge_join)

        def partition(refs_meta):
            out = []
            for ref, _m in refs_meta:
                parts = part_remote.remote(ref, key, num_parts)
                out.append([parts] if num_parts == 1 else parts)
            return out

        left_parts = partition(left_refs_meta)
        right_parts = partition(right_refs_meta)
        results = []
        for p in range(num_parts):
            lps = [pr[p] for pr in left_parts]
            rps = [pr[p] for pr in right_parts]
            out_ref, meta_ref = join_remote.remote(key, how, len(lps),
                                                   *lps, *rps)
            results.append((out_ref, meta_ref))
        return [(ref, api.get(meta_ref)) for ref, meta_ref in results]

    return run
