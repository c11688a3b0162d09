"""Trial state tracked by the controller.

Port of ray_tpu/tune/trial.py (reference shape:
python/ray/tune/experiment/trial.py Trial — status FSM
PENDING/RUNNING/PAUSED/TERMINATED/ERROR, config, last_result).
"""

from __future__ import annotations

import uuid
from typing import Any


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def __init__(self, config: dict, experiment_name: str = "exp",
                 trial_id: str | None = None):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.config = config
        self.experiment_name = experiment_name
        self.status = Trial.PENDING
        self.last_result: dict = {}
        self.results: list[dict] = []
        self.error: str | None = None
        self.actor = None  # ActorHandle once launched
        self.pending_step = None  # outstanding ObjectRef
        self.checkpoint: Any = None
        self.pbt_request: dict | None = None
        self.restarts = 0

    def metric_history(self, metric: str) -> list:
        return [r[metric] for r in self.results if metric in r]

    def __repr__(self) -> str:
        return f"Trial({self.trial_id}, {self.status})"
