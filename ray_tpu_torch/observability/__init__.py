"""Observability for the port: the goodput ledger.

Port of ray_tpu/observability/'s goodput names. The watchdog's modules
(``sampler``, ``timeseries``, ``detectors``, ``watchdog``) run on the head
and in the telemetry flushers, and wait for the process workers (ROADMAP
Queue A item (iv)).

- :mod:`~ray_tpu_torch.observability.goodput` — the goodput ledger: every
  rank's wall clock classified into an exhaustive phase taxonomy, rolled up
  into goodput % / badput breakdown in chip-seconds.
"""

from ray_tpu_torch.observability.goodput import (  # noqa: F401
    GOOD_PHASE,
    PHASES,
    GoodputStore,
    RankLedger,
)
