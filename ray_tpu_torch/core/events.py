"""Task/actor lifecycle event buffer + chrome-trace timeline export.

Port of ray_tpu/core/events.py for the in-process runtime: the runtime
records state transitions per task attempt into a bounded buffer, and
``timeline`` exports them in chrome://tracing's JSON shape, and every
task and actor method runs inside a worker span (``util/tracing.py``)
parented under its submitter's context. Out: the dropped-events metrics
counter (``buffer.dropped`` still counts) and the cluster-wide event
fetch (process workers, ROADMAP Queue A item (iv)).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class TaskEvent:
    task_id: str
    name: str
    state: str  # SUBMITTED | RUNNING | FINISHED | FAILED | CANCELLED
    ts: float  # unix seconds
    worker_id: str = ""
    node_id: str = ""
    actor_id: str = ""
    job_id: str = ""
    extra: dict = field(default_factory=dict)


class TaskEventBuffer:
    """Bounded in-process ring of task events (oldest dropped first)."""

    def __init__(self, max_events: int = 100_000):
        self._events: deque[TaskEvent] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self.dropped = 0

    def record(self, task_id: str, name: str, state: str, **extra) -> None:
        ev = TaskEvent(
            task_id=task_id, name=name, state=state, ts=time.time(),
            worker_id=extra.pop("worker_id", ""),
            node_id=extra.pop("node_id", ""),
            actor_id=extra.pop("actor_id", ""),
            job_id=extra.pop("job_id", ""),
            extra=extra,
        )
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def events(self) -> list[TaskEvent]:
        with self._lock:
            return list(self._events)


def chrome_trace(events: list[TaskEvent]) -> list[dict]:
    """Complete (ph="X") events per RUNNING→{FINISHED|FAILED} task attempt,
    one row per node/worker, same shape the reference's ``ray.timeline`` emits."""
    running: dict[str, TaskEvent] = {}
    out: list[dict] = []
    for ev in sorted(events, key=lambda e: e.ts):
        if ev.state == "RUNNING":
            running[ev.task_id] = ev
        elif ev.state in ("FINISHED", "FAILED", "CANCELLED"):
            start = running.pop(ev.task_id, None)
            if start is None:
                continue
            out.append({
                "name": ev.name,
                "cat": "actor_task" if (ev.actor_id or start.actor_id) else "task",
                "ph": "X",
                "ts": start.ts * 1e6,
                "dur": max(0.0, (ev.ts - start.ts) * 1e6),
                "pid": (ev.node_id or start.node_id)[:8] or "node",
                "tid": (ev.worker_id or start.worker_id)[:8] or "worker",
                "args": {"task_id": ev.task_id, "state": ev.state, **ev.extra},
                "cname": "thread_state_runnable" if ev.state == "FINISHED"
                         else "terrible",
            })
    return out


@contextlib.contextmanager
def task_execution(spec, worker_id: str, node_id: str = ""):
    """RUNNING event → traced user code → FINISHED/FAILED event, around
    every task and actor method the runtime executes."""
    from ray_tpu_torch.util import tracing

    buf = global_event_buffer()
    tid = spec.task_id.hex()
    aid = spec.actor_id.hex() if spec.actor_id else ""
    common = dict(worker_id=worker_id, node_id=node_id, actor_id=aid,
                  job_id=spec.job_id.hex() if spec.job_id else "")
    buf.record(tid, spec.name, "RUNNING", **common)
    try:
        with tracing.task_span(spec.name, spec.trace_ctx,
                               attributes={"task_id": tid}):
            yield
        buf.record(tid, spec.name, "FINISHED", **common)
    except BaseException:
        buf.record(tid, spec.name, "FAILED", **common)
        raise


_buffer = TaskEventBuffer()


def global_event_buffer() -> TaskEventBuffer:
    return _buffer


def timeline(filename: str | None = None):
    """Chrome-trace timeline of every task this process has executed
    (reference: ray.timeline, python/ray/_private/state.py:1010)."""
    trace = chrome_trace(_buffer.events())
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
        return filename
    return trace
