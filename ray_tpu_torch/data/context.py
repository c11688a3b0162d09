"""Execution context/knobs (reference capability:
python/ray/data/context.py DataContext).

Port of ray_tpu/data/context.py.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class DataContext:
    # rows per output block a read aims for when parallelism=-1
    target_min_rows_per_block: int = 1000
    # default read parallelism when unknown
    default_parallelism: int = 8
    # per map-stage cap on concurrently running tasks
    max_tasks_in_flight_per_stage: int = 8
    # cap on produced-but-unconsumed blocks per stage (backpressure)
    max_output_blocks_buffered: int = 16
    # cap on produced-but-unconsumed BYTES per stage (backpressure budget —
    # reference: ResourceManager object-store memory budgets). The
    # effective per-stage budget is the MIN of this and the arena-derived
    # share: object_store_capacity × object_store_budget_fraction / stages.
    max_output_bytes_buffered: int = 256 * 1024 * 1024
    # Fraction of the node's object-store arena the executor's buffered
    # outputs may collectively occupy (reference: ResourceManager
    # op-resource budgets against object_store_memory).
    object_store_budget_fraction: float = 0.5
    # shuffle fan-out (floor; see target_shuffle_partition_bytes)
    default_shuffle_partitions: int = 8
    # Spill-aware shuffle sizing (reference: push-based shuffle splits by
    # target partition size): all-to-all partition count grows with total
    # bytes so each reduce task materializes at most ~this much data in
    # worker memory — the blocks themselves live in the spilling arena, so
    # datasets larger than the object store sort without OOM.
    target_shuffle_partition_bytes: int = 64 * 1024 * 1024
    max_shuffle_partitions: int = 256
    # task resource demand for data tasks (0 CPU => don't starve trainers)
    task_num_cpus: float = 0.25

    _local = threading.local()

    @staticmethod
    def get_current() -> "DataContext":
        ctx = getattr(DataContext._local, "ctx", None)
        if ctx is None:
            ctx = DataContext()
            DataContext._local.ctx = ctx
        return ctx
