"""Tuner: the experiment driver.

Port of ray_tpu/tune/tuner.py on the port's in-process runtime
(reference: python/ray/tune/tuner.py:43 Tuner;
execution/tune_controller.py:67 — launch trials as actors up to the
concurrency limit, poll step results, consult the scheduler, apply PBT
exploit/explore by checkpoint transfer between trial actors). The trials
are actors, so threads of one process: each trial's model and generator
are its own, on a device it names (the current CUDA device is per
thread). ``trial_resources`` passes every key but ``"CPU"`` on to the
actor's resources, so ``{"CPU": 1, "GPU": 0.25}`` puts four trials on a
runtime started with ``init(resources={"GPU": 1})``. One difference from
JAX's: a finished trial's ``stop`` is awaited before its actor is killed,
so a function trainable's thread has ended, and released what it held,
when ``fit()`` returns.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trainable import (
    STOP_JOIN_S,
    Trainable,
    TrialActor,
    wrap_function,
)
from ray_tpu_torch.tune.trial import Trial


@dataclass
class TuneConfig:
    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    search_alg: Searcher | None = None
    scheduler: TrialScheduler | None = None
    seed: int | None = None


@dataclass
class TuneResult:
    config: dict
    metrics: dict
    error: str | None = None
    checkpoint: Any = None
    trial_id: str = ""

    @property
    def metrics_dataframe(self):  # lazy import; optional pandas-free use
        return self.metrics


@dataclass
class ResultGrid:
    results: list[TuneResult] = field(default_factory=list)
    metric: str | None = None
    mode: str = "max"

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i: int) -> TuneResult:
        return self.results[i]

    def get_best_result(self, metric: str | None = None,
                        mode: str | None = None) -> TuneResult:
        metric = metric or self.metric
        mode = mode or self.mode
        scored = [r for r in self.results
                  if r.error is None and metric in r.metrics]
        if not scored:
            raise RuntimeError("no successful trial reported the metric")
        key = (lambda r: r.metrics[metric])
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    @property
    def errors(self) -> list[str]:
        return [r.error for r in self.results if r.error]


class Tuner:
    """Drive an experiment of trials over a search space.

    ``trainable`` may be: a function(config), a Trainable subclass, or a
    trainer instance (``train.TorchTrainer``; it runs under tune as one
    function trial, reference Train-under-Tune nesting).
    """

    def __init__(self, trainable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None,
                 run_config: Any = None,
                 stop: dict | None = None,
                 trial_resources: dict | None = None):
        self._trainable_cls = _as_trainable_cls(trainable)
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config
        self.stop = stop or {}
        self.trial_resources = trial_resources or {"CPU": 1}

    def fit(self) -> ResultGrid:
        ray_tpu_torch.init()
        tc = self.tune_config
        searcher = tc.search_alg or BasicVariantGenerator(seed=tc.seed)
        scheduler = tc.scheduler or FIFOScheduler()
        searcher.set_search_properties(tc.metric, tc.mode, self.param_space)
        scheduler.set_search_properties(tc.metric, tc.mode)

        trials: list[Trial] = []
        exhausted = False
        # Pre-generate for the basic generator so num_samples semantics match
        # the reference (grid × samples).
        if isinstance(searcher, BasicVariantGenerator):
            target = searcher.total_variants(tc.num_samples)
        else:
            target = tc.num_samples

        max_conc = tc.max_concurrent_trials or max(
            1, int(ray_tpu_torch.cluster_resources().get("CPU", 4)))

        RemoteTrial = ray_tpu_torch.remote(TrialActor)

        def launch(trial: Trial, checkpoint=None):
            start_iter = trial.last_result.get("training_iteration", 0)
            trial.actor = RemoteTrial.options(
                num_cpus=self.trial_resources.get("CPU", 1),
                resources={k: v for k, v in self.trial_resources.items()
                           if k != "CPU"} or None,
            ).remote(self._trainable_cls, trial.config, checkpoint, start_iter)
            trial.status = Trial.RUNNING
            trial.pending_step = trial.actor.train_step.remote()

        def finish(trial: Trial, status: str, error: str | None = None):
            trial.status = status
            trial.error = error
            if trial.actor is not None:
                _stop(trial.actor)
                trial.actor = None
            trial.pending_step = None

        while True:
            # Admit new trials.
            running = [t for t in trials if t.status == Trial.RUNNING]
            while (not exhausted and len(trials) < target
                   and len(running) < max_conc):
                trial_id = f"t{len(trials)}"
                cfg = searcher.suggest(trial_id)
                if cfg is None:
                    exhausted = True
                    break
                trial = Trial(cfg, trial_id=trial_id)
                trials.append(trial)
                launch(trial)
                running.append(trial)

            if not running:
                if exhausted or len(trials) >= target:
                    break
                time.sleep(0.01)
                continue

            # Poll outstanding steps.
            ref_to_trial = {t.pending_step: t for t in running}
            ready, _ = ray_tpu_torch.wait(list(ref_to_trial), num_returns=1,
                                    timeout=5.0)
            for ref in ready:
                trial = ref_to_trial[ref]
                try:
                    result = ray_tpu_torch.get(ref)
                except Exception as e:
                    searcher.on_trial_complete(trial.trial_id, error=True)
                    scheduler.on_trial_complete(trial, None)
                    finish(trial, Trial.ERROR, error=repr(e))
                    continue
                if set(result) - {"done", "training_iteration"}:
                    trial.last_result = {**trial.last_result, **result}
                trial.results.append(result)
                searcher.on_trial_result(trial.trial_id, result)

                if result.get("done") or self._hit_stop(result):
                    searcher.on_trial_complete(trial.trial_id, result)
                    scheduler.on_trial_complete(trial, result)
                    # Capture the final checkpoint before tearing down.
                    try:
                        trial.checkpoint = ray_tpu_torch.get(trial.actor.save.remote())
                    except Exception:
                        pass
                    finish(trial, Trial.TERMINATED)
                    continue

                decision = scheduler.on_trial_result(trial, result)
                if decision == TrialScheduler.STOP:
                    searcher.on_trial_complete(trial.trial_id, result)
                    scheduler.on_trial_complete(trial, result)
                    try:
                        trial.checkpoint = ray_tpu_torch.get(trial.actor.save.remote())
                    except Exception:
                        pass
                    finish(trial, Trial.TERMINATED)
                    continue

                if trial.pbt_request is not None:
                    self._apply_pbt(trial, launch)
                    continue

                trial.pending_step = trial.actor.train_step.remote()

        return ResultGrid(
            results=[TuneResult(config=t.config,
                                metrics=t.last_result,
                                error=t.error,
                                checkpoint=t.checkpoint,
                                trial_id=t.trial_id)
                     for t in trials],
            metric=tc.metric, mode=tc.mode)

    def _hit_stop(self, result: dict) -> bool:
        return any(k in result and result[k] >= v for k, v in self.stop.items())

    def _apply_pbt(self, trial: Trial, launch) -> None:
        """Exploit+explore: clone donor checkpoint into this trial with the
        perturbed config (reference: pbt.py _exploit via checkpoint
        transfer)."""
        req, trial.pbt_request = trial.pbt_request, None
        donor: Trial = req["donor"]
        new_config: dict = req["config"]
        checkpoint = None
        if donor.actor is not None:
            try:
                checkpoint = ray_tpu_torch.get(donor.actor.save.remote())
            except Exception:
                checkpoint = donor.checkpoint
        trial.config = new_config
        _stop(trial.actor)
        trial.restarts += 1
        launch(trial, checkpoint)


def _stop(actor) -> None:
    """Unblock a trial actor's report()-parked user thread and wait for it
    to end, then kill the actor."""
    try:
        ray_tpu_torch.get(actor.stop.remote(), timeout=STOP_JOIN_S + 30.0)
    except Exception:
        pass
    try:
        ray_tpu_torch.kill(actor)
    except Exception:
        pass


def _as_trainable_cls(trainable) -> type:
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable) and not hasattr(trainable, "fit"):
        return wrap_function(trainable)
    if hasattr(trainable, "fit"):
        # A Trainer instance: run its fit() as a single-step function trial,
        # threading trial config into train_loop_config (reference: Train-
        # under-Tune nesting, SURVEY §2.3 M2).
        trainer = trainable

        def trainer_fn(config: dict):
            import copy

            t = copy.copy(trainer)
            merged = dict(t.train_loop_config or {})
            merged.update(config.get("train_loop_config", config))
            t.train_loop_config = merged
            res = t.fit()
            from ray_tpu_torch.tune.trainable import report

            report(dict(res.metrics or {}))

        return wrap_function(trainer_fn)
    raise TypeError(f"not a trainable: {trainable!r}")
