"""On-demand distributed profiling: stack sampling, device traces,
memory snapshots, and straggler attribution.

Port of ray_tpu/profiling/: the sampler, merge and straggler modules are
copies; ``capture`` takes the card's device trace with ``torch.profiler``
and ``memory`` reads the CUDA caching allocator. The control RPC, CLI verbs
and dashboard endpoints named below wait for the process workers and the
head (ROADMAP Queue A item (iv)); in the port the entry points are
``capture_profile`` in a process, ``serve`` replicas' ``profile(seconds)``,
and ``ray_tpu_torch.util.state``'s in-process verbs.

Capability parity with the reference's active-debugging surface (reference:
``ray stack`` via py-spy, ``ray timeline``, per-task profiling events, and
PyTorch's ``torch.profiler`` trace and the CUDA allocator's memory
statistics): point a
command at a live cluster and get back who is slow, where the time goes, and
what is holding device memory.

Layering (one capture, three planes):

- :mod:`ray_tpu_torch.profiling.sampler` — in-process Python stack sampler (no
  py-spy dependency): a background thread walks ``sys._current_frames()`` at
  a fixed rate and aggregates collapsed-stack flamegraph lines.
- :mod:`ray_tpu_torch.profiling.capture` — one capture session per process:
  sampler + (guarded) ``torch.profiler`` device trace + memory snapshot.
- :mod:`ray_tpu_torch.profiling.merge` — head/driver-side aggregation: per-process
  captures + the span timeline → one chrome-trace and one fleet flamegraph.
- :mod:`ray_tpu_torch.profiling.straggler` — training straggler attribution from
  the per-worker step-time/sync-time deciles streamed to the head.

Wire path: ``profile`` control RPC head → node_daemon → worker; CLI verbs
``profile`` / ``stack`` / ``stragglers`` / ``memory --device``; dashboard
endpoints ``/api/profile`` / ``/api/stragglers`` / ``/api/memory/device``.

The profiler observes itself: every completed capture adds its duration to
``profiler_capture_seconds`` and every refused one (per-node concurrency cap,
busy process) increments ``profiler_dropped_captures``.
"""

from __future__ import annotations

import threading

from ray_tpu_torch.profiling.capture import capture_profile
from ray_tpu_torch.profiling.memory import memory_snapshot
from ray_tpu_torch.profiling.merge import (
    merge_chrome_trace,
    merge_flamegraph,
    write_artifacts,
)
from ray_tpu_torch.profiling.sampler import StackSampler, dump_stacks
from ray_tpu_torch.profiling.straggler import build_report

__all__ = [
    "StackSampler",
    "build_report",
    "capture_profile",
    "dump_stacks",
    "memory_snapshot",
    "merge_chrome_trace",
    "merge_flamegraph",
    "profiler_metrics",
    "write_artifacts",
]


_metrics = None
_metrics_lock = threading.Lock()


def profiler_metrics() -> dict:
    """Lazy self-metrics: the observability layer observes itself (same
    lazy-singleton idiom as the serve/train hot-path metrics)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter

            _metrics = {
                "capture_seconds": Counter(
                    "profiler_capture_seconds",
                    "total seconds of profiler capture completed in this "
                    "process", tag_keys=("kind",)),
                "dropped": Counter(
                    "profiler_dropped_captures",
                    "capture requests refused (per-node concurrency cap, "
                    "process already capturing)", tag_keys=("reason",)),
            }
        return _metrics


def count_dropped(reason: str) -> None:
    try:
        profiler_metrics()["dropped"].inc(tags={"reason": reason})
    except Exception:
        pass  # metrics must never fail the control path
