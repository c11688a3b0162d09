"""The runtime flags the in-process runtime reads.

Port of the part of ray_tpu/utils/config.py that the port reads:
``object_store_memory_bytes``, ``object_spilling_threshold`` and
``temp_dir`` (``core/store.py``), ``data_split_prefetch_blocks`` (the
streaming split's queue bound) and ``metrics_exemplar_count``
(``util/metrics.py``). Each is overridden from the same environment variable as
there (``RTPU_<NAME>``; ``temp_dir`` also from ``RTPU_TEMP_DIR``), so one
setting drives both packages.
"""

from __future__ import annotations

import os
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
    object_store_memory_bytes: int = 2 * 1024**3
    object_spilling_threshold: float = 0.8

    # --- data: blocks queued per streaming_split consumer (backpressure) ---
    data_split_prefetch_blocks: int = 8

    # --- metrics: exemplars kept per histogram series (0 disables) ---
    metrics_exemplar_count: int = 4

    # --- misc ---
    temp_dir: str = field(default_factory=lambda: os.environ.get("RTPU_TEMP_DIR", "/tmp/ray_tpu"))

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
