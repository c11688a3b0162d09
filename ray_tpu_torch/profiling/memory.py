"""Device/host memory snapshot: what is holding memory right now.

Port of ray_tpu/profiling/memory.py, with the same dict shape. Three
accounting domains in one dict:

- process: RSS from /proc (works everywhere, no dependencies);
- device: per-card bytes from the CUDA caching allocator
  (``torch.cuda.memory_allocated`` and ``memory_stats``), with the
  allocator's ``bytes_in_use``/``bytes_limit`` per card. Guarded as the
  JAX package guards its backend: a process that has not initialized CUDA
  reports a skip marker, and a snapshot never creates a CUDA context (it
  reads no card this process has not used, and calls no ``mem_get_info``);
- stores: the in-process object store's occupancy.
"""

from __future__ import annotations

import os
import sys


def cuda_ready() -> bool:
    """True only when CUDA is already initialized in this process: the
    counterpart of ray_tpu's ``jax_backend_ready``. A process that merely
    imported torch must not pay a CUDA context (hundreds of MiB of card
    memory, seconds) for bookkeeping."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001 - a torch without CUDA support
        return False


def used_devices() -> list[int]:
    """The cards this process has allocated on (its allocator holds
    memory there) plus its current card; [] without CUDA."""
    if not cuda_ready():
        return []
    import torch

    cur = torch.cuda.current_device()
    return [i for i in range(torch.cuda.device_count())
            if i == cur or torch.cuda.memory_reserved(i) > 0]


def _rss_bytes() -> int:
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _device_memory() -> dict:
    """Per-card allocator bytes. ``live_arrays`` is the allocator's count
    of live allocations (``active.all.current``), the counterpart of JAX's
    live-array count."""
    if not cuda_ready():
        return {"status": "skipped",
                "reason": "cuda not initialized in this process"}
    try:
        import torch

        per_device: dict[str, dict] = {}
        stats: dict[str, dict] = {}
        for i in used_devices():
            ms = torch.cuda.memory_stats(i)
            name = f"cuda:{i}"
            in_use = int(torch.cuda.memory_allocated(i))
            per_device[name] = {
                "live_arrays": int(ms.get("active.all.current", 0)),
                "bytes": in_use,
            }
            stats[name] = {
                "bytes_in_use": in_use,
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory),
            }
        out = {"status": "captured", "backend": "cuda",
               "devices": per_device}
        if stats:
            out["allocator"] = stats
        return out
    except Exception as e:  # noqa: BLE001 - snapshot must not fail captures
        return {"status": "error", "reason": f"{type(e).__name__}: {e}"}


def _store_stats() -> dict:
    out: dict[str, dict] = {}
    try:
        from ray_tpu_torch.core.worker import global_worker

        rt = global_worker.runtime
        if rt is None:
            return out
        store = getattr(rt, "store", None)
        if store is not None and hasattr(store, "stats"):
            out["object_store"] = store.stats()
    except Exception:
        pass
    return out


def memory_snapshot() -> dict:
    """One process's memory picture: RSS + the cards' allocator bytes +
    object store occupancy."""
    import time

    return {
        "ts": time.time(),
        "pid": os.getpid(),
        "rss_bytes": _rss_bytes(),
        "device": _device_memory(),
        "stores": _store_stats(),
    }
