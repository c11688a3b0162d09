"""Trial schedulers: FIFO, ASHA, median stopping, PBT.

Port of ray_tpu/tune/schedulers.py, a copy (reference:
python/ray/tune/schedulers/). Decisions are made per reported result:
CONTINUE, STOP, or PAUSE; PBT's exploit is a request the Tuner carries
out by checkpoint transfer.
"""

from __future__ import annotations

import math
import random
from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:
    from ray_tpu_torch.tune.trial import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    PAUSE = "PAUSE"

    def set_search_properties(self, metric: str | None, mode: str | None) -> None:
        self.metric, self.mode = metric, mode

    def _score(self, result: dict) -> float:
        v = result[self.metric]
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial: "Trial", result: dict) -> str:
        return self.CONTINUE

    def on_trial_complete(self, trial: "Trial", result: dict | None) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (the default)."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: asynchronous successive halving (reference:
    schedulers/async_hyperband.py). Rungs at grace_period ·
    reduction_factor^k; a trial reaching a rung is stopped unless its score
    is in the top 1/reduction_factor of results recorded at that rung."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: float = 4,
                 max_t: int = 100):
        self._time_attr = time_attr
        self._rf = reduction_factor
        self._max_t = max_t
        self._cut_at: dict[float, set[str]] = {}
        self._rungs: list[tuple[float, list[float]]] = []
        t = grace_period
        while t < max_t:
            self._rungs.append((t, []))
            t = int(math.ceil(t * reduction_factor))
        self._rungs.reverse()  # largest rung first, reference layout

    def on_trial_result(self, trial: "Trial", result: dict) -> str:
        t = result.get(self._time_attr, 0)
        if self.metric not in result:
            return self.CONTINUE
        if t >= self._max_t:
            return self.STOP
        score = self._score(result)
        decision = self.CONTINUE
        for milestone, recorded in self._rungs:
            if t < milestone:
                continue
            if trial.trial_id in self._cut_at.get(milestone, set()):
                continue
            self._cut_at.setdefault(milestone, set()).add(trial.trial_id)
            recorded.append(score)
            if len(recorded) >= self._rf:
                cutoff = sorted(recorded, reverse=True)[
                    max(0, int(len(recorded) / self._rf) - 1)]
                if score < cutoff:
                    decision = self.STOP
            break
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score so far is below the median of other
    trials' running averages at the same step (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self._time_attr = time_attr
        self._grace = grace_period
        self._min_samples = min_samples_required
        self._scores: dict[str, list[float]] = {}

    def on_trial_result(self, trial: "Trial", result: dict) -> str:
        if self.metric not in result:
            return self.CONTINUE
        t = result.get(self._time_attr, 0)
        s = self._score(result)
        self._scores.setdefault(trial.trial_id, []).append(s)
        if t < self._grace or len(self._scores) < self._min_samples:
            return self.CONTINUE
        others = [sum(v) / len(v) for k, v in self._scores.items()
                  if k != trial.trial_id]
        if not others:
            return self.CONTINUE
        others.sort()
        median = others[len(others) // 2]
        best = max(self._scores[trial.trial_id])
        return self.STOP if best < median else self.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: schedulers/pbt.py): every perturbation_interval,
    bottom-quantile trials exploit (clone weights+config from a top-quantile
    trial) and explore (perturb hyperparams by 1.2×/0.8× or resample)."""

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: dict[str, Callable | list] | None = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: int | None = None):
        self._time_attr = time_attr
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._resample_p = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: dict[str, float] = {}
        self._latest: dict[str, tuple[float, "Trial"]] = {}

    def on_trial_result(self, trial: "Trial", result: dict) -> str:
        if self.metric not in result:
            return self.CONTINUE
        t = result.get(self._time_attr, 0)
        self._latest[trial.trial_id] = (self._score(result), trial)
        if t - self._last_perturb.get(trial.trial_id, 0) < self._interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t

        ranked = sorted(self._latest.values(), key=lambda sv: sv[0])
        n = len(ranked)
        if n < 2:
            return self.CONTINUE
        k = max(1, int(n * self._quantile))
        bottom = [tr for _, tr in ranked[:k]]
        top = [tr for _, tr in ranked[-k:]]
        if trial in bottom and trial not in top:
            donor = self._rng.choice(top)
            new_config = self._explore(donor.config)
            # The controller performs the actual clone+restart.
            trial.pbt_request = {"donor": donor, "config": new_config}
        return self.CONTINUE

    def on_trial_complete(self, trial: "Trial", result: dict | None) -> None:
        self._latest.pop(trial.trial_id, None)
        self._last_perturb.pop(trial.trial_id, None)

    def _explore(self, config: dict) -> dict:
        new = dict(config)
        for key, spec in self._mutations.items():
            if self._rng.random() < self._resample_p or key not in new:
                new[key] = (self._rng.choice(spec) if isinstance(spec, list)
                            else spec())
            else:
                factor = 1.2 if self._rng.random() > 0.5 else 0.8
                if isinstance(spec, list):
                    new[key] = self._rng.choice(spec)
                else:
                    new[key] = new[key] * factor
        return new
