"""One profiling capture session for THIS process.

Port of ray_tpu/profiling/capture.py. ``capture_profile(seconds)`` runs,
for a clamped duration:

(a) the Python stack sampler (collapsed flamegraph lines + sample timeline),
(b) a device trace: a ``torch.profiler`` session with CUDA activity,
    exported as a chrome trace into the capture's logdir (in place of
    ray_tpu's ``jax.profiler`` session). Guarded as there: a process
    without CUDA (the CPU tests) gets the skip marker, and so does one
    that has not initialized CUDA; on a card, a device trace that fails is
    an ``error`` status, never a silent skip;
(c) a before/after memory snapshot (the cards' allocator bytes, RSS, store
    occupancy).

The device trace is started from the capturing thread. CUPTI records the
card's kernels for the whole process, whichever thread launched them;
``torch.profiler`` records CPU operators only on the thread that started
it (its callbacks are thread-local), so the trace's host side is the
stack sampler's, which covers every thread. A process's first session
starts late (Kineto initializes CUPTI in it; ~1 s on an H100 with torch
2.11), so its device window opens after the sampler's.

The exported trace is read back at the end of the capture: its device
rows (kernels, copies, sets) ride in the bundle as ``xla_trace["events"]``
with the kernel and kernel-launch counts. A trace whose runtime recorded
kernel launches but which lost their kernel records (none at all, or
more than ``PARTIAL_SHARE`` of the launches by correlation id) is
``partial``, not ``captured``. Without a ``xla_logdir`` the trace file
goes to a directory under ``tempfile.gettempdir()`` that is removed once
read; a given logdir keeps its ``trace.json``.

Exactly one capture runs per process at a time: a second request returns a
``busy`` error (and counts into ``profiler_dropped_captures``) instead of
double-sampling. Kineto takes one session per process, so a capture while
some other ``torch.profiler`` session is active is refused the same way
(reason ``device_busy``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

from ray_tpu_torch.utils.config import get_config

_capture_lock = threading.Lock()


def _other_profiler_active() -> bool:
    import sys

    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None and getattr(prof, "_is_profiler_enabled",
                                             False))


def _device_trace_begin(logdir: str | None):
    """Start a torch.profiler session with CUDA activity when it is
    meaningful; otherwise return the skip marker. Returns (state, session
    or None). Never initializes CUDA in a process that hasn't."""
    import sys

    from ray_tpu_torch.profiling.memory import cuda_ready

    cfg = get_config()
    if not cfg.profiler_xla_trace:
        return {"status": "skipped", "reason": "disabled by config "
                "(profiler_xla_trace=False)"}, None
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        # CPU-only torch (the tests): a device trace has nothing to say.
        return {"status": "skipped",
                "reason": "cpu-only backend (no CUDA device trace)"}, None
    if not cuda_ready():
        return {"status": "skipped",
                "reason": "cuda not initialized in this process"}, None
    try:
        from torch.profiler import ProfilerActivity, profile

        state = {"status": "capturing", "backend": "cuda"}
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            state["logdir"] = logdir
        else:
            state["scratch"] = tempfile.mkdtemp(prefix="rtpu-device-trace-")
        session = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
        session.__enter__()
        return state, session
    except Exception as e:  # noqa: BLE001 - reported, the caller decides
        return {"status": "error", "reason": f"{type(e).__name__}: {e}"}, \
            None


# Device-side categories of a torch.profiler chrome trace, and the runtime
# and driver calls that launch a kernel.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# The share of a window's launches whose kernel records may be missing
# before the trace reads ``partial``: kernels other threads launched
# between the capture's synchronize and the session's stop, on streams
# that had not reached them.
PARTIAL_SHARE = 0.01


def read_device_trace(path: str) -> dict:
    """The device rows of an exported chrome trace, with its epoch base
    and the counts that tell a whole trace from a partial one. A kernel
    launch is ``missing`` when no kernel record carries its correlation
    id although a kernel launched after it was recorded: the device ran
    it inside the window and the trace lost it."""
    with open(path) as f:
        doc = json.load(f)
    events, kernels, launched = [], set(), []
    for e in doc.get("traceEvents") or []:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            events.append(e)
            if cat == "kernel":
                kernels.add(corr)
        elif cat in _LAUNCH_CATS and "LaunchKernel" in str(e.get("name")):
            launched.append(corr)
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    last = max((c for c in kernels if c is not None), default=None)
    if not n_kernels:
        missing = len(launched)
    elif last is None:  # no correlation ids: nothing to match
        missing = 0
    else:
        missing = sum(1 for c in launched if c is not None and c < last
                      and c not in kernels)
    return {"events": events, "kernels": n_kernels,
            "launches": len(launched), "missing": missing,
            "base_ns": doc.get("baseTimeNanoseconds")}


def _device_trace_end(state: dict, session) -> dict:
    state = dict(state)
    scratch = state.pop("scratch", None)
    try:
        import torch

        torch.cuda.synchronize()  # the window's kernels land in the trace
        session.__exit__(None, None, None)
        path = os.path.join(state.get("logdir") or scratch, "trace.json")
        session.export_chrome_trace(path)
        state.update(read_device_trace(path))
        if state["launches"] and (not state["kernels"] or state["missing"]
                                  > PARTIAL_SHARE * state["launches"]):
            state["status"] = "partial"
            state["reason"] = (f"{state['missing']} of {state['launches']} "
                               "kernel launches have no kernel record")
        else:
            state["status"] = "captured"
        if scratch is None:
            state["trace_file"] = path
    except Exception as e:  # noqa: BLE001
        state["status"] = "error"
        state["reason"] = f"{type(e).__name__}: {e}"
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    return state


def capture_profile(seconds: float, *, sample_hz: float | None = None,
                    xla_logdir: str | None = None,
                    meta: dict | None = None) -> dict:
    """Blocking capture (callers run it on a side thread). Returns the
    capture bundle, or ``{"error": "busy", ...}`` when this process is
    already capturing. ``xla_logdir`` (ray_tpu's name) is where the
    device trace's ``trace.json`` is kept; without it the file is read
    into the bundle and removed."""
    from ray_tpu_torch.profiling import count_dropped, profiler_metrics
    from ray_tpu_torch.profiling.memory import memory_snapshot
    from ray_tpu_torch.profiling.sampler import StackSampler

    cfg = get_config()
    seconds = max(0.05, min(float(seconds), cfg.profiler_max_capture_s))
    hz = float(sample_hz or cfg.profiler_sample_hz)
    if not _capture_lock.acquire(blocking=False):
        count_dropped("busy")
        return {"error": "busy", "reason": "a capture is already running in "
                f"this process (pid {os.getpid()})", "meta": dict(meta or {})}
    try:
        if _other_profiler_active():
            count_dropped("device_busy")
            return {"error": "busy", "reason": "another torch.profiler "
                    f"session is active in this process (pid {os.getpid()})",
                    "meta": dict(meta or {})}
        mem_before = memory_snapshot()
        xla, session = _device_trace_begin(xla_logdir)
        sampler = StackSampler(hz=hz).start()
        hz = sampler.hz  # report the CLAMPED rate (sampler enforces _MAX_HZ)
        t0 = time.monotonic()
        time.sleep(seconds)
        sampler.stop()
        if session is not None:
            xla = _device_trace_end(xla, session)
        duration = time.monotonic() - t0
        bundle = {
            "meta": dict(meta or {}),
            "pid": os.getpid(),
            "duration_s": duration,
            "sample_hz": hz,
            "samples": sampler.samples,
            "collapsed": sampler.collapsed(),
            "sample_events": sampler.sample_events(),
            "xla_trace": xla,
            "memory": memory_snapshot(),
            "memory_before": mem_before,
            "started_at": sampler.started_at,
            "ended_at": sampler.ended_at,
        }
        try:
            kind = (meta or {}).get("kind", "process")
            profiler_metrics()["capture_seconds"].inc(
                duration, tags={"kind": kind})
        except Exception:
            pass
        return bundle
    finally:
        _capture_lock.release()
