"""Streaming executor (reference capability:
python/ray/data/_internal/execution/streaming_executor.py:77 — pull-based
streaming over blocks-as-refs with in-flight budgets and backpressure).

The plan is a linear chain of stages. Each map stage keeps a bounded pool of
in-flight remote tasks; completed blocks flow downstream without waiting for
the stage to finish. AllToAll stages are barriers that run their own
distributed shuffle. The whole loop is a generator: consumers pull
(block_ref, meta) pairs, which is itself the final backpressure.

Port of ray_tpu/data/executor.py on the in-process runtime, with the same
budgets, backpressure and block order. ``ActorPoolStrategy(num_gpus=)``
is the counterpart of ``num_tpus``: it demands the runtime's ``"GPU"``
resource. Pool actors are threads of this process, so two things are
explicit here that a process exit does in ray_tpu: each pool actor
builds its own instance of a class UDF (closures are shared by reference
here, not copied), and a pool's shutdown kills its actors and then waits
until each has given its resources back and dropped its instance (a UDF
holding an engine frees the card memory then).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterator

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.datasource import ReadTask
from ray_tpu_torch.data.plan import AllToAll, FusedMapStage, InputData, LimitOp, Read

# How long a pool's shutdown waits for each killed actor to give its
# resources back (a call still running finishes first).
POOL_RELEASE_TIMEOUT_S = 120.0

_exec_metrics_cache: dict | None = None


def _exec_metrics() -> dict:
    """Lazy federated counters for streaming-executor backpressure — created
    once per process (re-instantiating a same-named Counter would re-register
    and orphan the prior series)."""
    global _exec_metrics_cache
    if _exec_metrics_cache is None:
        from ray_tpu_torch.util.metrics import Counter

        _exec_metrics_cache = {
            "backpressure": Counter(
                "data_stage_backpressure",
                "streaming stage launches blocked by the output-buffer budget",
                ("stage",)),
        }
    return _exec_metrics_cache


class HeldBlock:
    """A block held in memory by a dataset made while no runtime runs
    (``from_blocks``, ``from_numpy``...): it is put into the object store
    only when a stage needs the runtime, so reading such a dataset starts
    no runtime (offline RL reads them so)."""

    __slots__ = ("block",)

    def __init__(self, block: Block):
        self.block = block


def get_block(ref, api=None) -> Block:
    """The block behind a ref or a HeldBlock."""
    if isinstance(ref, HeldBlock):
        return ref.block
    if api is None:
        import ray_tpu_torch as api  # noqa: PLC0415
    return api.get(ref)


def put_block(block: Block, api=None):
    """A ref to ``block``: an object-store ref when the runtime runs, else a
    HeldBlock."""
    import ray_tpu_torch  # noqa: PLC0415

    if ray_tpu_torch.is_initialized():
        return (api or ray_tpu_torch).put(block)
    return HeldBlock(block)


def _to_store(refs_meta: list, api) -> list:
    return [(api.put(r.block) if isinstance(r, HeldBlock) else r, m)
            for r, m in refs_meta]


# Per-actor state of class UDFs: ``_MapWorker.apply`` sets it on the
# actor's thread for the duration of a call.
_udf_local = threading.local()


def udf_instance(key: object, make: Callable[[], Any],
                 fallback: dict) -> Any:
    """The instance of a class UDF for the pool actor running this call
    (made on its first block), or ``fallback``'s outside a pool actor."""
    state = getattr(_udf_local, "state", None)
    if state is None:
        state = fallback
    inst = state.get(key)
    if inst is None:
        inst = state[key] = make()
    return inst


def _run_block_fn(block_fn, block: Block):
    out = block_fn(block)
    acc = BlockAccessor(out)
    return out, {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}


def _run_read_task(task: ReadTask):
    out = task()
    acc = BlockAccessor(out)
    return out, {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}


def _slice_block(block: Block, start: int, end: int):
    out = BlockAccessor(block).slice(start, end)
    return out, {"num_rows": end - start}


class ActorPoolStrategy:
    """compute= argument for map_batches (reference capability:
    ray.data.ActorPoolStrategy — autoscaling actor-pool map operator for
    stateful or accelerator-bound transforms). ``min_size``/``max_size``
    make the pool elastic: it grows while the stage's input queue outruns
    the actors and shrinks back when they idle (reference:
    _internal/execution/operators/actor_pool_map_operator.py)."""

    def __init__(self, size: int | None = None, *, min_size: int | None = None,
                 max_size: int | None = None, num_cpus: float = 1.0,
                 num_gpus: float = 0.0, resources: dict | None = None):
        if size is None and min_size is None and max_size is None:
            size = 2
        self.min_size = int(min_size if min_size is not None
                            else (size if size is not None else 1))
        self.max_size = int(max_size if max_size is not None
                            else (size if size is not None
                                  else self.min_size))
        if self.min_size < 1 or self.max_size < self.min_size:
            raise ValueError(
                f"invalid pool bounds [{self.min_size}, {self.max_size}]")
        self.size = self.min_size  # initial size (back-compat attribute)
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus
        self.resources = resources or {}


class _MapWorker:
    """Actor applying a fused block fn; holds user state (e.g. a model on
    the card) across blocks: its class UDFs' instances, which it drops
    when it ends."""

    def __init__(self, block_fn):
        self._fn = block_fn
        self._udf_state: dict = {}

    def apply(self, block: Block):
        _udf_local.state = self._udf_state
        try:
            return _run_block_fn(self._fn, block)
        finally:
            _udf_local.state = None

    def ping(self):
        return True


class _StageExec:
    """Runtime state of one map stage."""

    # Wall-clock seconds of continuous idleness before an elastic pool
    # retires one actor above min_size (ticks would shrink a warm pool
    # sitting behind a slow upstream stage in milliseconds).
    POOL_IDLE_S = 10.0

    def __init__(self, stage: FusedMapStage, ctx: DataContext, api,
                 n_stages: int = 1):
        self.stage = stage
        self.ctx = ctx
        self.api = api
        # Per-stage byte budget measured against the node's object-store
        # arena (reference: ResourceManager op budgets against
        # object_store_memory): the stages of a pipeline collectively get
        # object_store_budget_fraction of the arena.
        try:
            from ray_tpu_torch.utils.config import get_config

            arena = get_config().object_store_memory_bytes
        except Exception:
            arena = 0
        self.byte_budget = ctx.max_output_bytes_buffered
        if arena:
            share = int(arena * ctx.object_store_budget_fraction
                        / max(1, n_stages))
            self.byte_budget = min(self.byte_budget, max(share, 1 << 20))
        self.input_queue: collections.deque = collections.deque()
        self.upstream_done = False
        # Backpressure accounting: one stall per transition into the
        # budget-blocked state (input waiting but output buffers full), not
        # one per scheduler tick — the federated counter then reads as
        # "how often did this stage hit its budget", not loop frequency.
        self.backpressure_stalls = 0
        self._bp_blocked = False
        try:
            self._metrics = _exec_metrics()
        except Exception:
            self._metrics = None
        # meta_ref -> (block_ref, actor_index|None, seq)
        self.in_flight: dict = {}
        self.outputs: collections.deque = collections.deque()
        # Deterministic block order (reference: ray.data preserves block
        # order end-to-end): tasks complete in any order, but outputs are
        # released strictly in input order.
        self._seq_in = 0
        self._seq_out = 0
        self._pending_out: dict[int, tuple] = {}
        self._remote_fn = api.remote(num_cpus=ctx.task_num_cpus, num_returns=2)(
            _run_block_fn
        )
        self._pool = None
        self._pool_load: list[int] = []
        self._pool_idle_since: float | None = None
        self._actor_cls = None
        self._fn_ref = None
        if isinstance(stage.compute, ActorPoolStrategy):
            comp = stage.compute
            self._actor_cls = api.remote(
                num_cpus=comp.num_cpus, num_gpus=comp.num_gpus,
                resources=comp.resources,
            )(_MapWorker)
            self._fn_ref = api.put(stage.block_fn)
            self._pool = [self._actor_cls.remote(self._fn_ref)
                          for _ in range(comp.min_size)]
            self._pool_load = [0] * comp.min_size

    def _autoscale_pool(self) -> None:
        """Elastic pool sizing: grow while the queue outruns the actors
        AND the stage can actually launch (a stage throttled by its output
        byte budget must not ramp actors that can do no work), capped by
        the in-flight task limit; retire an idle actor after a quiet
        wall-clock spell (down to min_size)."""
        import time as _time

        comp = self.stage.compute
        if self._pool is None or comp.min_size == comp.max_size:
            return
        cap = min(comp.max_size, self.ctx.max_tasks_in_flight_per_stage)
        if (len(self.input_queue) > 2 * len(self._pool)
                and len(self._pool) < cap and self.can_launch()):
            self._pool.append(self._actor_cls.remote(self._fn_ref))
            self._pool_load.append(0)
            self._pool_idle_since = None
            return
        busy = len(self.input_queue) + sum(self._pool_load)
        if busy == 0 and len(self._pool) > comp.min_size:
            now = _time.monotonic()
            if self._pool_idle_since is None:
                self._pool_idle_since = now
            elif now - self._pool_idle_since >= self.POOL_IDLE_S:
                self._pool_idle_since = now
                actor = self._pool.pop()  # retire the newest
                self._pool_load.pop()
                try:
                    self.api.kill(actor)
                except Exception:
                    pass
                _wait_released([actor])
        else:
            self._pool_idle_since = None

    @property
    def done(self) -> bool:
        return (self.upstream_done and not self.input_queue
                and not self.in_flight and not self.outputs)

    def can_launch(self) -> bool:
        if not self.input_queue:
            return False
        if len(self.in_flight) >= self.ctx.max_tasks_in_flight_per_stage:
            return False
        # _pending_out holds completed blocks awaiting earlier sequence
        # numbers — they're buffered memory too, or the ordering buffer
        # would bypass the budgets entirely.
        n_buffered = len(self.outputs) + len(self._pending_out)
        if n_buffered >= self.ctx.max_output_blocks_buffered:
            self._note_backpressure()
            return False
        buffered = sum(m.get("size_bytes", 0) for _, m in self.outputs)
        buffered += sum(m.get("size_bytes", 0)
                        for _, m in self._pending_out.values())
        if buffered >= self.byte_budget:
            self._note_backpressure()
            return False  # byte budget (reference: ResourceManager)
        self._bp_blocked = False
        return True

    def _note_backpressure(self) -> None:
        if self._bp_blocked:
            return
        self._bp_blocked = True
        self.backpressure_stalls += 1
        if self._metrics is not None:
            self._metrics["backpressure"].inc(
                tags={"stage": self.stage.label})

    def launch(self) -> None:
        self._autoscale_pool()
        while self.can_launch():
            block_ref, _meta = self.input_queue.popleft()
            seq = self._seq_in
            self._seq_in += 1
            if self._pool is not None:
                idx = min(range(len(self._pool)), key=lambda i: self._pool_load[i])
                out_ref, meta_ref = self._pool[idx].apply.options(
                    num_returns=2
                ).remote(block_ref)
                self._pool_load[idx] += 1
                self.in_flight[meta_ref] = (out_ref, idx, seq)
            else:
                out_ref, meta_ref = self._remote_fn.remote(
                    self.stage.block_fn, block_ref
                )
                self.in_flight[meta_ref] = (out_ref, None, seq)

    def collect_ready(self, ready_meta_refs: list) -> None:
        for meta_ref in ready_meta_refs:
            if meta_ref not in self.in_flight:
                continue
            out_ref, actor_idx, seq = self.in_flight.pop(meta_ref)
            if actor_idx is not None:
                self._pool_load[actor_idx] -= 1
            meta = self.api.get(meta_ref)
            self._pending_out[seq] = (out_ref, meta)
        while self._seq_out in self._pending_out:
            self.outputs.append(self._pending_out.pop(self._seq_out))
            self._seq_out += 1

    def shutdown(self) -> None:
        if self._pool:
            for a in self._pool:
                try:
                    self.api.kill(a)
                except Exception:
                    pass
            _wait_released(self._pool)
            self._pool = []


def _wait_released(actors: list) -> None:
    from ray_tpu_torch.api import wait_released

    for a in actors:
        try:
            wait_released(a, POOL_RELEASE_TIMEOUT_S)
        except Exception:
            pass


def execute_plan(stages: list[Any], api=None) -> Iterator[tuple[Any, dict]]:
    """Run the lowered stage list; yield (block_ref, meta) of the final stage.

    ``api`` is the ray_tpu module (injectable for tests).
    """
    if api is None:
        import ray_tpu_torch as api  # noqa: PLC0415

    ctx = DataContext.get_current()

    # Source stage → initial (ref, meta) stream.
    source = stages[0]
    if isinstance(source, InputData):
        pending_source: list = []
        initial = list(source.block_refs)  # already (ref, meta) pairs
        if len(stages) > 1:  # a stage runs tasks: held blocks go to the store
            initial = _to_store(initial, api)
    elif isinstance(source, Read):
        tasks = source.datasource.get_read_tasks(
            source.parallelism if source.parallelism > 0
            else ctx.default_parallelism
        )
        read_fn = api.remote(num_cpus=ctx.task_num_cpus, num_returns=2)(
            _run_read_task
        )
        pending_source = []
        initial = []
        for t in tasks:
            out_ref, meta_ref = read_fn.remote(t)
            pending_source.append((out_ref, meta_ref))
    else:
        raise TypeError(f"plan must start with Read/InputData, got {source}")

    rest = stages[1:]
    yield from _execute_chain(initial, pending_source, rest, ctx, api)


def _execute_chain(initial, pending_source, rest, ctx, api):
    # Split the chain at barriers: run the streaming segment up to the first
    # AllToAll, materialize, run the barrier fn, continue with the remainder.
    for i, st in enumerate(rest):
        if isinstance(st, AllToAll):
            upstream = list(
                _stream_segment(initial, pending_source, rest[:i], ctx, api)
            )
            shuffled = st.fn(upstream)
            yield from _execute_chain(shuffled, [], rest[i + 1:], ctx, api)
            return
    yield from _stream_segment(initial, pending_source, rest, ctx, api)


def _stream_segment(initial, pending_source, stages, ctx, api):
    """Streaming loop over map/limit stages (no barriers inside)."""
    limit_remaining: dict[int, int] = {}
    execs: list[_StageExec | LimitOp] = []
    n_map_stages = sum(1 for st in stages if isinstance(st, FusedMapStage))
    for st in stages:
        if isinstance(st, FusedMapStage):
            execs.append(_StageExec(st, ctx, api, n_stages=n_map_stages))
        elif isinstance(st, LimitOp):
            limit_remaining[id(st)] = st.limit
            execs.append(st)
        else:
            raise TypeError(f"unexpected stage {st}")

    map_execs = [e for e in execs if isinstance(e, _StageExec)]
    final_out: collections.deque = collections.deque()

    # feed initial materialized refs
    upstream_out = collections.deque(initial)
    # Source blocks release in submission order even though read tasks
    # complete in any order (deterministic block order, as above).
    source_pending = {
        meta_ref: (out_ref, i)
        for i, (out_ref, meta_ref) in enumerate(pending_source)
    }
    src_buffer: dict[int, tuple] = {}
    src_next = 0
    source_done = not source_pending

    slice_fn = api.remote(num_cpus=0, num_returns=2)(_slice_block)

    def route(queue_in: collections.deque, start_idx: int) -> None:
        """Push (ref, meta) pairs through limit stages until the next map
        stage (or the final output)."""
        items = list(queue_in)
        queue_in.clear()
        for ref, meta in items:
            idx = start_idx
            emitted = True
            cur = (ref, meta)
            while idx < len(execs):
                st = execs[idx]
                if isinstance(st, LimitOp):
                    rem = limit_remaining[id(st)]
                    if rem <= 0:
                        emitted = False
                        break
                    nrows = cur[1].get("num_rows", -1)
                    if nrows < 0:
                        nrows = api.get(
                            api.remote(num_cpus=0)(
                                lambda b: BlockAccessor(b).num_rows()
                            ).remote(cur[0])
                        )
                    if nrows > rem:
                        sliced_ref, meta_ref = slice_fn.remote(cur[0], 0, rem)
                        cur = (sliced_ref, api.get(meta_ref))
                        nrows = rem
                    limit_remaining[id(st)] -= nrows
                    idx += 1
                else:
                    st.input_queue.append(cur)
                    emitted = False
                    break
            if emitted:
                final_out.append(cur)

    try:
        while True:
            # 1. route source outputs into the chain
            if upstream_out:
                route(upstream_out, 0)
            # 2. move each map stage's outputs downstream
            for i, st in enumerate(execs):
                if isinstance(st, _StageExec) and st.outputs:
                    route(st.outputs, i + 1)
            # 3. launch work
            for st in map_execs:
                st.launch()
            # 4. drain final outputs to consumer
            while final_out:
                yield final_out.popleft()
            # 5. check termination / limits satisfied
            all_limits_hit = limit_remaining and all(
                v <= 0 for v in limit_remaining.values()
            )
            upstream_done = source_done
            for st in execs:
                if isinstance(st, _StageExec):
                    st.upstream_done = upstream_done
                    upstream_done = st.done or (
                        upstream_done and not st.input_queue and not st.in_flight
                        and not st.outputs
                    )
            if all_limits_hit:
                break
            if source_done and all(
                e.done for e in map_execs
            ) and not upstream_out and not final_out:
                break
            # 6. wait for something to finish
            wait_refs = list(source_pending.keys())
            for st in map_execs:
                wait_refs.extend(st.in_flight.keys())
            if not wait_refs:
                continue
            ready, _ = api.wait(
                wait_refs, num_returns=1, timeout=0.1, fetch_local=True
            )
            for meta_ref in ready:
                if meta_ref in source_pending:
                    out_ref, idx = source_pending.pop(meta_ref)
                    src_buffer[idx] = (out_ref, api.get(meta_ref))
                    while src_next in src_buffer:
                        upstream_out.append(src_buffer.pop(src_next))
                        src_next += 1
                    if not source_pending:
                        source_done = True
                else:
                    for st in map_execs:
                        st.collect_ready([meta_ref])
        while final_out:
            yield final_out.popleft()
    finally:
        for st in map_execs:
            st.shutdown()
