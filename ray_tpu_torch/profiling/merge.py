"""Head/driver-side aggregation: per-process captures + span timeline →
one chrome-trace JSON and one fleet flamegraph.

Port of ray_tpu/profiling/merge.py, a straight copy with one addition:
each capture's device trace (the card's kernel, memcpy and memset rows
from its ``torch.profiler`` session) joins the document, so one file holds
spans, stack samples, memory counters and kernels for every process.

The chrome trace interleaves four kinds of rows so the whole capture loads
as one Perfetto/chrome://tracing document:

- span slices (ph="X") from the span timeline, one row per trace;
- sampling tracks per captured process: one slice per stack sample, named by
  the leaf frame (the "what was it doing" track);
- memory counters (ph="C") per process from the capture's snapshots;
- device rows per captured process (pid ``device <label>``), one row per
  CUDA stream.

The fleet flamegraph is plain collapsed-stack text: every process's stacks
prefixed with a ``kind:id@node`` root frame, counts summed — one file feeds
any flamegraph renderer (inferno, speedscope, flamegraph.pl).
"""

from __future__ import annotations

import json
import os


def _capture_label(cap: dict) -> str:
    meta = cap.get("meta") or {}
    kind = meta.get("kind", "process")
    ident = (meta.get("worker_id") or meta.get("source")
             or str(cap.get("pid", "?")))[:8]
    node = (meta.get("node_id") or "")[:8]
    return f"{kind}:{ident}@{node}" if node else f"{kind}:{ident}"


def merge_flamegraph(captures: list[dict]) -> str:
    """Sum collapsed stacks across captures, each rooted at its process
    label, so one flamegraph spans the fleet."""
    agg: dict[str, int] = {}
    for cap in captures:
        if not cap or cap.get("error"):
            continue
        label = _capture_label(cap)
        for line in (cap.get("collapsed") or "").splitlines():
            stack, _, n = line.rpartition(" ")
            if not stack or not n.isdigit():
                continue
            key = f"{label};{stack}"
            agg[key] = agg.get(key, 0) + int(n)
    return "\n".join(f"{k} {v}" for k, v in
                     sorted(agg.items(), key=lambda kv: (-kv[1], kv[0])))


def merge_chrome_trace(captures: list[dict],
                       spans: list[dict] | None = None) -> dict:
    """Chrome-trace object document merging sample tracks, memory counters,
    and the span timeline (same span-row shape as the ``timeline`` CLI, so
    the two artifacts never drift visually)."""
    events: list[dict] = []
    seen_spans = set()
    has_goodput = False
    for s in spans or []:
        # Span ids are minted per process: dedup on (trace_id, span_id) so
        # a cross-process collision can't swallow someone else's row.
        sid = (s.get("trace_id"), s.get("span_id"))
        if sid in seen_spans:
            continue
        seen_spans.add(sid)
        # Goodput phase chunks get their own lane, one row per (run, rank),
        # so the badput breakdown reads as a horizontal timeline next to
        # the sample tracks instead of drowning in the RPC span soup.
        attrs = s.get("attributes") or {}
        name = s.get("name", "")
        if name.startswith("goodput."):
            has_goodput = True
            pid = "goodput"
            tid = f"{attrs.get('run', '?')}/r{attrs.get('rank', '?')}"
        else:
            pid = "spans"
            tid = (s.get("trace_id") or "")[:8]
        events.append({
            "name": name, "cat": f"span:{s.get('kind', '')}",
            "ph": "X", "ts": s.get("start_ts", 0.0) * 1e6,
            "dur": max(0.0, (s.get("end_ts", 0.0) -
                             s.get("start_ts", 0.0)) * 1e6),
            "pid": pid, "tid": tid,
            "args": {"trace_id": s.get("trace_id"), "span_id": sid,
                     "status": s.get("status"), **attrs},
        })
    if spans is not None:
        events.append({"name": "process_name", "ph": "M", "pid": "spans",
                       "args": {"name": "ray_tpu spans"}})
    if has_goodput:
        events.append({"name": "process_name", "ph": "M", "pid": "goodput",
                       "args": {"name": "goodput phases"}})

    for cap in captures:
        if not cap or cap.get("error"):
            continue
        label = _capture_label(cap)
        hz = float(cap.get("sample_hz") or 100.0)
        dur_us = 1e6 / hz
        events.append({"name": "process_name", "ph": "M", "pid": label,
                       "args": {"name": f"samples {label}"}})
        for ev in cap.get("sample_events") or []:
            events.append({
                "name": ev.get("leaf") or "(idle)", "cat": "sample",
                "ph": "X", "ts": ev.get("ts", 0.0) * 1e6, "dur": dur_us,
                "pid": label, "tid": ev.get("thread", "thread"),
            })
        for which in ("memory_before", "memory"):
            mem = cap.get(which) or {}
            if not mem:
                continue
            events.append({
                "name": "rss_bytes", "ph": "C",
                "ts": mem.get("ts", 0.0) * 1e6, "pid": label,
                "args": {"rss": mem.get("rss_bytes", 0)},
            })
        events.extend(device_events(cap, f"device {label}"))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def device_events(cap: dict, pid: str) -> list[dict]:
    """The capture's device rows (read into its bundle when the capture
    ended), on the wall clock of the span timeline: kineto writes microseconds from ``baseTimeNanoseconds`` (epoch);
    a trace without that base is laid from the capture's start."""
    dev = cap.get("xla_trace") or {}
    if dev.get("status") not in ("captured", "partial"):
        return []
    raw = dev.get("events") or []
    if not raw:
        return []
    base_us = float(dev.get("base_ns") or 0) / 1e3
    first = min(float(e.get("ts", 0.0)) for e in raw) + base_us
    start_us = float(cap.get("started_at") or 0.0) * 1e6
    if start_us and abs(first - start_us) > 86400e6:
        base_us += start_us - first  # not epoch-based: align to the start
    out = [{"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": pid}}]
    for e in raw:
        args = e.get("args") or {}
        out.append({
            "name": e.get("name", ""), "cat": e.get("cat"), "ph": "X",
            "ts": float(e.get("ts", 0.0)) + base_us,
            "dur": float(e.get("dur", 0.0)), "pid": pid,
            "tid": f"stream {args.get('stream', e.get('tid', '?'))}",
            "args": {k: args[k] for k in ("device", "stream", "grid",
                                          "block", "correlation")
                     if k in args},
        })
    return out


def write_artifacts(result: dict, out_dir: str,
                    trace: dict | None = None,
                    flame: str | None = None) -> dict:
    """Write the merged artifacts of one cluster profile under ``out_dir``:
    trace.json (chrome trace), flame.txt (collapsed stacks), memory.json
    (per-process snapshots), captures.json (raw bundles, sample events
    elided — they are already in the trace). Returns the path map. Pass
    ``trace``/``flame`` when the caller already merged them (a fleet merge
    over thousands of sample events is not free to redo)."""
    os.makedirs(out_dir, exist_ok=True)
    captures = result.get("captures") or []
    if trace is None:
        trace = merge_chrome_trace(captures, result.get("spans"))
    if flame is None:
        flame = merge_flamegraph(captures)
    paths = {
        "trace": os.path.join(out_dir, "trace.json"),
        "flamegraph": os.path.join(out_dir, "flame.txt"),
        "memory": os.path.join(out_dir, "memory.json"),
        "captures": os.path.join(out_dir, "captures.json"),
    }
    with open(paths["trace"], "w") as f:
        json.dump(trace, f)
    with open(paths["flamegraph"], "w") as f:
        f.write(flame + ("\n" if flame else ""))
    with open(paths["memory"], "w") as f:
        json.dump([{"label": _capture_label(c),
                    "memory": c.get("memory"),
                    "memory_before": c.get("memory_before")}
                   for c in captures if c and not c.get("error")],
                  f, indent=2, default=str)
    slim = []
    for c in captures:
        c = dict(c or {})
        c.pop("sample_events", None)
        if "events" in (c.get("xla_trace") or {}):  # already in trace.json
            c["xla_trace"] = {k: v for k, v in c["xla_trace"].items()
                              if k != "events"}
        slim.append(c)
    with open(paths["captures"], "w") as f:
        json.dump({"captures": slim, "errors": result.get("errors") or {}},
                  f, default=str)
    return paths
