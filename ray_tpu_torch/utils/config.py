"""The runtime flags the port reads.

Port of the part of ray_tpu/utils/config.py that the port reads:
``object_store_memory_bytes`` (also a node's shared-memory arena),
``object_spilling_threshold`` and ``temp_dir`` (``core/store.py``),
``data_split_prefetch_blocks`` (the streaming split's queue bound),
``metrics_exemplar_count`` (``util/metrics.py``), the ``trace_*``
(``util/tracing.py``, Serve's handle), ``goodput_*``
(``observability/goodput.py``) and ``profiler_*`` (``profiling/``)
fields, and the cluster's: leases and the worker pool (``worker_*``,
``lease_keepalive_s``), objects inline in replies
(``inline_object_max_bytes``), liveness (``health_check_*``) and the
function cache (``fn_cache_max_bytes``). The ``watchdog_*`` fields wait
for the head's telemetry (ROADMAP Queue A item (iv)). Each is overridden
from the same environment variable as there (``RTPU_<NAME>``;
``temp_dir`` also from ``RTPU_TEMP_DIR``, and defaults to ``ray_tpu``
under the system's temporary directory), so one setting drives both
packages.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field, fields
from typing import Any

_ENV_PREFIX = "RTPU_"


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class Config:
    """Runtime flags; env var = RTPU_<UPPER_NAME>."""

    # --- object store (reference: plasma + spilling thresholds, ray_config_def.h:680-697) ---
    # Also the capacity of a node's shared-memory arena (core/shm_store.py).
    object_store_memory_bytes: int = 2 * 1024**3
    object_spilling_threshold: float = 0.8

    # --- data: blocks queued per streaming_split consumer (backpressure) ---
    data_split_prefetch_blocks: int = 8

    # --- metrics: exemplars kept per histogram series (0 disables) ---
    metrics_exemplar_count: int = 4

    # --- request tracing (util/tracing.py) ---
    # Head-sampling rate for serve ingress requests: the DeploymentHandle
    # draws one verdict per request and every downstream span (router,
    # replica, batcher, engine) inherits it. Per-deployment override:
    # @serve.deployment(trace_sample_rate=...). Only meaningful once
    # tracing.enable_tracing() turned the master gate on.
    trace_sample_rate: float = 0.01
    # Tail-sampling ring bounds: spans of unsampled traces are ringed per
    # trace id (promotable by a keep when the request ends slow, shed,
    # expired, errored or breaker-implicated). Distinct traces held, spans
    # kept per trace, and the ring TTL; past any bound the oldest die
    # unkept.
    trace_tail_traces: int = 512
    trace_tail_spans_per_trace: int = 64
    trace_tail_ttl_s: float = 30.0
    # "Ended slow" keep verdict: rolling per-deployment latency window and
    # the history the p99 gate needs before it judges.
    trace_slow_window: int = 512
    trace_slow_min_samples: int = 64

    # --- goodput ledger (observability/goodput.py) ---
    # Master gate: every live TrainContext carries a RankLedger that
    # classifies its wall clock into the goodput phases.
    goodput_enabled: bool = True

    # --- on-demand profiler (profiling/) ---
    # Stack-sampler rate (clamped to 1 kHz by the sampler) and the ceiling
    # on one capture's duration (requests are clamped, not rejected).
    profiler_sample_hz: float = 100.0
    profiler_max_capture_s: float = 60.0
    # Allow the device trace (a torch.profiler session with CUDA activity)
    # inside a capture. Named as in ray_tpu, where it is the XLA trace, so
    # one RTPU_PROFILER_XLA_TRACE setting drives both packages.
    profiler_xla_trace: bool = True

    # --- cluster (core/cluster/): leases, the worker pool, liveness ---
    worker_start_timeout_s: float = 120.0
    worker_idle_ttl_s: float = 60.0  # idle pooled workers are reaped after this
    lease_keepalive_s: float = 2.0  # idle driver-cached leases returned after this
    inline_object_max_bytes: int = 100 * 1024  # small results ride in RPC replies
    health_check_period_s: float = 1.0
    health_check_failure_threshold: int = 5
    fn_cache_max_bytes: int = 64 * 1024**2

    # --- misc ---
    temp_dir: str = field(default_factory=lambda: os.environ.get(
        "RTPU_TEMP_DIR", os.path.join(tempfile.gettempdir(), "ray_tpu")))

    @classmethod
    def load(cls) -> "Config":
        cfg = cls()
        for f in fields(cls):
            env_key = _ENV_PREFIX + f.name.upper()
            if env_key in os.environ:
                typ = type(getattr(cfg, f.name))
                setattr(cfg, f.name, _coerce(os.environ[env_key], typ))
        return cfg


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.load()
    return _global_config


def set_config(cfg: Config) -> None:
    """Replace the process's settings (tests reload them from the
    environment with ``set_config(Config.load())``)."""
    global _global_config
    _global_config = cfg
