"""Logical plan + planner (reference capability:
python/ray/data/_internal/logical_operators/* and the operator-fusion pass).

A Dataset holds a chain of LogicalOps. The planner lowers the chain to
physical operators, fusing consecutive per-block transforms into a single
map stage so one remote task applies the whole fused pipeline per block.

Port of ray_tpu/data/plan.py: the same logical ops and fusion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    batch_to_block,
    block_from_rows,
    concat_blocks,
)
from ray_tpu_torch.data.datasource import Datasource


class LogicalOp:
    name = "op"


@dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1
    name = "Read"


@dataclass
class InputData(LogicalOp):
    """Pre-materialized block refs (from_blocks / materialized datasets)."""

    block_refs: list = field(default_factory=list)
    name = "InputData"


@dataclass
class MapBlocks(LogicalOp):
    """Any per-block transform: map/map_batches/filter/flat_map/drop cols."""

    block_fn: Callable[[Block], Block]
    label: str = "MapBlocks"
    # actor-pool compute ("tasks" default)
    compute: Any = None
    name = "MapBlocks"


@dataclass
class AllToAll(LogicalOp):
    """Global shuffle-shaped op: fn(list[Block refs]) -> list[Block refs].

    Runs when all upstream blocks are available (a pipeline barrier),
    submitting its own remote map/reduce tasks.
    """

    fn: Callable[[list], list]
    label: str = "AllToAll"
    name = "AllToAll"


@dataclass
class LimitOp(LogicalOp):
    limit: int
    name = "Limit"


# ---------------------------------------------------------------------------
# per-block transform builders (composed by fusion)


def make_map_rows_fn(fn: Callable[[dict], dict]) -> Callable[[Block], Block]:
    def block_fn(block: Block) -> Block:
        rows = [fn(r) for r in BlockAccessor(block).iter_rows()]
        return block_from_rows(rows)

    return block_fn


def make_flat_map_fn(fn: Callable[[dict], list]) -> Callable[[Block], Block]:
    def block_fn(block: Block) -> Block:
        rows: list[dict] = []
        for r in BlockAccessor(block).iter_rows():
            rows.extend(fn(r))
        return block_from_rows(rows)

    return block_fn


def make_filter_fn(fn: Callable[[dict], bool]) -> Callable[[Block], Block]:
    import numpy as np

    def block_fn(block: Block) -> Block:
        acc = BlockAccessor(block)
        keep = np.fromiter(
            (bool(fn(r)) for r in acc.iter_rows()), dtype=bool,
            count=acc.num_rows(),
        )
        return acc.take_rows(np.nonzero(keep)[0])

    return block_fn


def make_map_batches_fn(
    fn: Callable,
    *,
    batch_size: int | None,
    batch_format: str = "numpy",
    fn_args: tuple = (),
    fn_kwargs: dict | None = None,
) -> Callable[[Block], Block]:
    fn_kwargs = fn_kwargs or {}

    def block_fn(block: Block) -> Block:
        acc = BlockAccessor(block)
        n = acc.num_rows()
        if batch_size is None or batch_size >= n:
            batches = [acc.to_batch(batch_format)] if n else []
        else:
            batches = [
                BlockAccessor(acc.slice(i, min(i + batch_size, n)))
                .to_batch(batch_format)
                for i in range(0, n, batch_size)
            ]
        out = [batch_to_block(fn(b, *fn_args, **fn_kwargs)) for b in batches]
        return concat_blocks(out)

    return block_fn


def compose_block_fns(fns: list[Callable[[Block], Block]]) -> Callable[[Block], Block]:
    if len(fns) == 1:
        return fns[0]

    def fused(block: Block) -> Block:
        for f in fns:
            block = f(block)
        return block

    return fused


@dataclass
class FusedMapStage:
    block_fn: Callable[[Block], Block]
    label: str
    compute: Any = None


def plan_stages(ops: list[LogicalOp]) -> list[Any]:
    """Lower the logical chain: fuse adjacent MapBlocks (same compute) into
    FusedMapStage; pass through Read/InputData/AllToAll/Limit."""
    stages: list[Any] = []
    pending: list[MapBlocks] = []

    def flush():
        if pending:
            stages.append(
                FusedMapStage(
                    compose_block_fns([m.block_fn for m in pending]),
                    label="->".join(m.label for m in pending),
                    compute=pending[0].compute,
                )
            )
            pending.clear()

    for op in ops:
        if isinstance(op, MapBlocks):
            if pending and pending[0].compute is not op.compute:
                flush()
            pending.append(op)
        else:
            flush()
            stages.append(op)
    flush()
    return stages
