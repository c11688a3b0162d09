"""Long-poll: controller → router/proxy config push.

Port of ray_tpu/serve/long_poll.py: LongPollHost holds versioned snapshots
per key and parks listeners until a key changes; LongPollClient re-issues
listens and invokes callbacks on updates. The client's thread carries the
runtime's thread-name prefix and ends when that runtime shuts down, so the
runtime's ``shutdown`` joins it.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable


class LongPollHost:
    """Embedded in the controller actor. ``notify_changed`` bumps a key's
    version; ``listen`` blocks until any requested key is newer than the
    version the caller already has (or timeout → {})."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._snapshots: dict[str, tuple[int, Any]] = {}
        self._closed = False

    def close(self) -> None:
        """Wake every parked listener; later listens raise (the clients
        back off until serve.shutdown stops them)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def notify_changed(self, key: str, snapshot: Any) -> None:
        with self._cv:
            ver = self._snapshots.get(key, (0, None))[0] + 1
            self._snapshots[key] = (ver, snapshot)
            self._cv.notify_all()

    def listen(self, keys_to_versions: dict[str, int],
               timeout: float = 10.0) -> dict[str, tuple[int, Any]]:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError("the serve controller shut down")
                out = {}
                for key, have in keys_to_versions.items():
                    cur = self._snapshots.get(key)
                    if cur is not None and cur[0] > have:
                        out[key] = cur
                if out:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._cv.wait(remaining)


class LongPollClient:
    """Driver/replica-side cache over a controller's long-poll endpoint.

    ``host_listen`` is a callable (keys_to_versions, timeout) → updates —
    an actor-method bridge so this class stays transport-agnostic.
    """

    def __init__(self, host_listen: Callable[[dict, float], dict],
                 keys: list[str],
                 callback: Callable[[str, Any], None] | None = None,
                 poll_timeout: float = 5.0,
                 on_alive: Callable[[], None] | None = None):
        from ray_tpu_torch.core.worker import global_worker

        self._listen = host_listen
        self._versions = {k: 0 for k in keys}
        self._cache: dict[str, Any] = {}
        self._callback = callback
        # Called after EVERY successful listen round, updates or not: a
        # completed round proves the host is alive, which consumers use to
        # age liveness-gated state (the router's prefix-map TTL must not
        # expire a healthy-but-unchanged publication).
        self._on_alive = on_alive
        self._poll_timeout = poll_timeout
        self._stopped = threading.Event()
        self._have_first = threading.Event()
        # Die with the runtime that spawned us: a poller surviving a
        # shutdown/init cycle would keep issuing listen calls into the NEW
        # runtime forever (each one allocating task returns in its store).
        self._born_runtime = global_worker.runtime
        self._thread = self._born_runtime._start_thread(
            self._loop, (), "serve-longpoll")

    # Reconnect backoff bounds: first retry after ~BACKOFF_BASE_S, doubling
    # to BACKOFF_MAX_S, each with full jitter. A controller restart with
    # hundreds of routers/proxies polling must see staggered reconnects,
    # not a synchronized thundering herd every fixed 0.2 s.
    BACKOFF_BASE_S = 0.1
    BACKOFF_MAX_S = 5.0

    def _loop(self) -> None:
        import random

        from ray_tpu_torch.core.worker import global_worker

        failures = 0
        rt = self._born_runtime
        while not self._stopped.is_set():
            if global_worker.runtime is not rt or rt._shutdown:
                return  # our runtime is gone; stop polling
            try:
                updates = self._listen(dict(self._versions), self._poll_timeout)
                failures = 0
            except Exception:
                if self._stopped.is_set() or rt._shutdown:
                    return
                # Jittered exponential backoff on controller connection
                # loss (sleep in [0, cap) — full jitter decorrelates the
                # fleet's retries while keeping the mean at cap/2).
                failures += 1
                cap = min(self.BACKOFF_MAX_S,
                          self.BACKOFF_BASE_S * (2 ** min(failures, 16)))
                self._stopped.wait(random.random() * cap)
                continue
            if not isinstance(updates, dict):
                # Defensive: a malformed/stale reply (e.g. from an actor
                # mid-restart) must degrade to "no update", not kill the
                # poll thread — a dead poller silently freezes the replica
                # cache for the process's lifetime.
                continue
            for key, (ver, snap) in updates.items():
                self._versions[key] = ver
                self._cache[key] = snap
                if self._callback is not None:
                    self._callback(key, snap)
            if updates:
                self._have_first.set()
            if self._on_alive is not None:
                try:
                    self._on_alive()
                except Exception:  # noqa: BLE001 - liveness ping only
                    pass

    def get(self, key: str, default: Any = None) -> Any:
        return self._cache.get(key, default)

    def wait_first(self, timeout: float = 10.0) -> bool:
        return self._have_first.wait(timeout)

    def stop(self) -> None:
        self._stopped.set()
