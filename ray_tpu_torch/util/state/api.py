"""State API: the in-process verbs of ray_tpu/util/state/api.py.

Port of ``profile_cluster``, ``get_stack``, ``stack_cluster``,
``device_memory``, ``stragglers`` and ``get_goodput`` on their in-process
paths, which are the port's only paths: its runtime runs every task,
actor and train worker as a thread of this process, so "the cluster" is
this process and one capture covers every rank in it. The cluster paths
(a head fanning captures out to node daemons and workers) and the entity
listings wait for the process workers (ROADMAP Queue A item (iv)).
"""

from __future__ import annotations

import os
import time

from ray_tpu_torch.core.worker import global_worker


def profile_cluster(seconds: float = 5.0, sample_hz: float = 0.0,
                    out_dir: str | None = None) -> dict:
    """On-demand profile of this process: stack samples + the guarded
    device trace + a memory snapshot for ``seconds``, merged with the span
    timeline into one chrome trace and one flamegraph. With ``out_dir``,
    artifacts are written there and their paths returned under
    ``"paths"``. The returned captures omit the raw ``sample_events`` —
    they are already encoded in ``chrome_trace``."""
    from ray_tpu_torch.profiling import (
        capture_profile,
        merge_chrome_trace,
        merge_flamegraph,
        write_artifacts,
    )
    from ray_tpu_torch.util import tracing

    global_worker.check_connected()
    cap = capture_profile(seconds, sample_hz=sample_hz or None,
                          meta={"kind": "driver", "source": "local"})
    res = {"captures": [] if cap.get("error") else [cap],
           "errors": ({"local": cap["reason"]} if cap.get("error")
                      else {}),
           "spans": tracing.export()}
    captures = res["captures"]
    spans = res["spans"]
    out = {
        "captures": [{k: v for k, v in c.items() if k != "sample_events"}
                     for c in captures],
        "errors": res["errors"],
        "chrome_trace": merge_chrome_trace(captures, spans),
        "flamegraph": merge_flamegraph(captures),
    }
    if out_dir:
        out["paths"] = write_artifacts(res, out_dir,
                                       trace=out["chrome_trace"],
                                       flame=out["flamegraph"])
    return out


def get_stack(worker_id: str = "") -> dict:
    """Thread stacks of THIS process (the `ray stack` capability). A
    worker id names a process worker, which the port does not have."""
    from ray_tpu_torch.profiling.sampler import dump_stacks

    if not worker_id:
        return {"worker_id": "local", "pid": os.getpid(),
                "stacks": dump_stacks()}
    raise ValueError("per-worker stacks require cluster mode "
                     "(pass no worker for a local dump)")


def stack_cluster() -> dict:
    """Thread stacks of every process in the cluster: this one."""
    from ray_tpu_torch.profiling.sampler import dump_stacks

    global_worker.check_connected()
    return {"nodes": {"local": {
        "node_id": "local",
        "daemon": {"pid": os.getpid(), "stacks": dump_stacks()},
        "workers": {}, "errors": {}}}}


def device_memory() -> dict:
    """Per-node device/host memory snapshots (the cards' allocator bytes,
    RSS, object-store occupancy): this process's snapshot."""
    from ray_tpu_torch.profiling import memory_snapshot

    global_worker.check_connected()
    return {"nodes": {"local": {"node_id": "local",
                                "daemon": memory_snapshot(),
                                "workers": {}, "errors": {}}}}


def stragglers(threshold: float = 1.15) -> dict:
    """Straggler report: workers ranked by median step time vs the fleet,
    attributed compute-bound vs collective-wait, lagging host named, from
    this process's train contexts."""
    from ray_tpu_torch.profiling import build_report
    from ray_tpu_torch.train.session import collect_train_stats

    global_worker.check_connected()
    stats = collect_train_stats()
    sources = {"local": {"node_id": "local", "ts": time.time(),
                         "stats": stats}} if stats else {}
    return build_report(sources, threshold=threshold)


def get_goodput(run: str | None = None) -> dict:
    """Fleet goodput rollup. In-process runtimes have no head rollup and
    report disabled, as ray_tpu's does; each rank's ledger snapshot is in
    ``train.session.collect_train_stats()`` and
    ``observability.GoodputStore().rollup`` rolls them up."""
    global_worker.check_connected()
    return {"enabled": False, "runs": {}, "fleet": {}, "serve": {},
            "note": "in-process runtime (no head rollup)"}
