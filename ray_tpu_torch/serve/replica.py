"""Replica actor: hosts one copy of the user's callable.

Port of ray_tpu/serve/replica.py: runs the user callable, counts ongoing
requests for routing and autoscaling, admits or sheds each request, drops
requests whose deadline passed before they started, streams generator
results (``handle_request_streaming``, called with
``num_returns="streaming"``), and exposes health checks, reconfigure,
prefix-cache publication and graceful drains.

In the in-process runtime a replica has no process to exit, so what its
callable holds (an engine's weights and KV cache on the card, its scheduler
thread) would outlive the replica. ``stop`` stands in for the JAX
package's process exit: the controller calls it before it kills the
replica, and it calls the callable's ``shutdown()`` where it has one and
drops the callable. A replica killed without ``stop`` (``kill()``, or a
``stop`` that timed out) only drops its instance; the port's ``LLMServer``
then stops its engine when it is collected.

Each request runs inside the runtime's worker span (core/events.py),
parented under the router's attempt span, so what the callable submits
(an engine request) joins the request's trace; ``profile(seconds)`` takes
a capture from inside the replica. Out: the replica's metrics (TTFT/TPOT
histograms and counters, whose exemplars would carry the request's trace
id) and the chaos injector (ROADMAP Queue A item (iv)).
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any

from ray_tpu_torch.serve.multiplex import _set_multiplexed_model_id
from ray_tpu_torch.serve.resilience import (
    DEADLINE_KEY,
    DeadlineExceeded,
    Overloaded,
    _set_current_deadline,
    expired,
)
from ray_tpu_torch.utils import serialization


class ServeReplica:
    """Created by the controller with max_concurrency above
    max_ongoing_requests, so concurrent handle_request calls map to pool
    threads."""

    def __init__(self, deployment_name: str, replica_id: str,
                 cls_blob: bytes, init_args_blob: bytes,
                 user_config: Any = None, max_ongoing_requests: int = 0,
                 replica_queue_slack: int = 8):
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        cls = serialization.deserialize(cls_blob)
        args, kwargs = serialization.deserialize(init_args_blob)
        if isinstance(cls, type):
            self._callable = cls(*args, **kwargs)
        else:
            self._callable = cls  # plain function deployment
        self._ongoing = 0
        self._total = 0
        self._shed = 0
        self._expired = 0
        # Replica-side admission cap: every router caps its OWN in-flight
        # at max_ongoing_requests, but several routers can each fill that
        # cap against one replica; beyond the slack the replica says
        # Overloaded instead of queuing unboundedly. 0 = router caps only.
        self._admit_cap = (max_ongoing_requests + replica_queue_slack
                           if max_ongoing_requests > 0 else 0)
        self._lock = threading.Lock()
        if user_config is not None:
            self.reconfigure(user_config)

    def _begin_request(self, deadline: float | None = None) -> None:
        """Admission: shed when over the replica-side cap; drop requests
        whose deadline already passed, before any user or card work runs."""
        with self._lock:
            if self._admit_cap and self._ongoing >= self._admit_cap:
                self._shed += 1
                raise Overloaded(
                    f"replica {self.replica_id} at admission cap "
                    f"({self._admit_cap} ongoing)",
                    retry_after_s=0.5, where="replica")
            if expired(deadline):
                self._expired += 1
                raise DeadlineExceeded(
                    f"request expired before execution on replica "
                    f"{self.replica_id}")
            self._ongoing += 1
            self._total += 1

    def _end_request(self) -> None:
        with self._lock:
            self._ongoing -= 1

    def _target(self, method_name: str):
        target = self._callable
        if target is None:
            raise RuntimeError(f"replica {self.replica_id} was stopped")
        if method_name == "__call__":
            if not callable(target):
                raise AttributeError(
                    f"deployment {self.deployment_name} is not callable; "
                    f"specify a method name")
            return target
        return getattr(target, method_name)

    # -- data plane --

    def handle_request(self, method_name: str, args: tuple, kwargs: dict):
        mux_id = kwargs.pop("__rtpu_mux_id", "")
        deadline = kwargs.pop(DEADLINE_KEY, None)
        _set_multiplexed_model_id(mux_id)
        self._begin_request(deadline)
        _set_current_deadline(deadline, self.deployment_name)
        try:
            return self._target(method_name)(*args, **kwargs)
        finally:
            _set_current_deadline(None)
            self._end_request()

    def handle_request_streaming(self, method_name: str, args: tuple,
                                 kwargs: dict):
        """Streaming data plane: a generator actor method (called with
        num_returns="streaming"). The first yield is a meta dict
        {"streaming": bool}; then either the single complete result or the
        user generator's chunks as they are produced."""
        _set_multiplexed_model_id(kwargs.pop("__rtpu_mux_id", ""))
        deadline = kwargs.pop(DEADLINE_KEY, None)
        self._begin_request(deadline)
        _set_current_deadline(deadline, self.deployment_name)
        try:
            target = self._target(method_name)
            if inspect.isgeneratorfunction(target) or \
                    inspect.isgeneratorfunction(
                        getattr(target, "__call__", None)):
                yield {"streaming": True}
                yield from target(*args, **kwargs)
                return
            result = target(*args, **kwargs)
            if inspect.isgenerator(result):
                yield {"streaming": True}
                yield from result
                return
            yield {"streaming": False}
            yield result
        finally:
            _set_current_deadline(None)
            self._end_request()

    # -- control plane --

    def profile(self, seconds: float = 2.0, sample_hz: float = 0.0) -> dict:
        """Per-replica capture: sample this replica's process while it
        serves (called through the actor handle, so it runs concurrently
        with the data plane under max_concurrency), with the card's device
        trace where the replica's engine has initialized CUDA."""
        from ray_tpu_torch.profiling import capture_profile

        return capture_profile(
            seconds, sample_hz=sample_hz or None,
            meta={"kind": "serve_replica",
                  "deployment": self.deployment_name,
                  "source": self.replica_id,
                  "replica_id": self.replica_id})

    def get_metrics(self) -> dict:
        with self._lock:
            return {"replica_id": self.replica_id, "ongoing": self._ongoing,
                    "total": self._total, "shed": self._shed,
                    "expired": self._expired}

    def router_meta(self) -> dict | None:
        """Routing metadata the controller piggybacks on the replica
        snapshot (KV-block-aware prefix routing): user callables that
        define ``router_prefix_blocks() -> {"blocks": [...], "block": n}``
        publish their prefix-cache chain hashes (serve/prefix.py). None =
        this deployment doesn't publish (the controller then stops polling
        this replica). A raising router_prefix_blocks propagates: the
        controller treats a failed call as transient and retries."""
        fn = getattr(self._callable, "router_prefix_blocks", None)
        if not callable(fn):
            return None
        return fn() or None

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if callable(user_check):
            user_check()
        return True

    def reconfigure(self, user_config: Any) -> None:
        user_reconf = getattr(self._callable, "reconfigure", None)
        if callable(user_reconf):
            user_reconf(user_config)

    def prepare_for_shutdown(self, timeout_s: float = 5.0) -> bool:
        """Drain: wait for ongoing requests to finish."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    return True
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        """Release what the callable holds (the process exit of the JAX
        package's replicas): call its ``shutdown()`` where it has one, then
        drop it. Later requests raise."""
        target, self._callable = self._callable, None
        fn = getattr(target, "shutdown", None)
        if callable(fn):
            fn()
