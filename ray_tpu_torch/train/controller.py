"""Train controller: the control loop, run as an actor.

Port of ray_tpu/train/controller.py for the in-process runtime: the
controller runs as an actor, builds the worker group, brings up the
backend, runs the train function on every worker and polls them; reports
flow into ``metrics_history`` and rank 0's checkpoints into the checkpoint
registry (top-K retention); on a failure it restarts the group from the
latest checkpoint under ONE failure budget (``max_failures`` counts every
restart, whatever failed), and every restart decision lands in
``restart_log`` and ``Result.restarts``. Elastic scaling picks each
(re)start's world size.

The restore tier is ``checkpoint``, or ``elastic_shrink`` when lost
capacity forced a smaller world: there are no in-cluster replicas here
(ROADMAP Queue A item 7). With no cluster, a failure's trigger is
``worker_error`` (a train function raised), ``worker_dead`` (its actor is
gone) or ``controller_error`` (setup failed). A restart's downtime (failure
detected → the restarted group's first report) is a ``restart_downtime``
goodput event (observability/goodput.py). Out: the flight recorder and the
restart/failure/world-size metrics.
``datasets=`` are split over the group (``streaming_split(world,
equal=True)``) at every (re)start; the splits' producers are closed when
that group ends.
"""

from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.train.backend import TorchBackendConfig, free_port
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import SparePool, WorkerGroup
from ray_tpu_torch.utils.config import get_config


@dataclass
class Result:
    metrics: dict[str, Any] = field(default_factory=dict)
    checkpoint: Any = None
    error: str | None = None
    metrics_history: list[dict] = field(default_factory=list)
    # One entry per worker-group restart: the recorded restart decision
    # (tier, trigger, detection latency, world change).
    restarts: list[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.error is None


class _GroupFailure(RuntimeError):
    """A poll observed the group failing; carries attribution for the
    restart decision record."""

    def __init__(self, trigger: str, message: str,
                 dead: dict[int, str] | None = None,
                 errors: dict[int, str] | None = None,
                 since_last_ok_s: float | None = None):
        super().__init__(message)
        self.trigger = trigger
        self.dead = dict(dead or {})
        self.errors = dict(errors or {})
        self.since_last_ok_s = since_last_ok_s
        self.detected_ts = time.time()  # stamped at observation


def _close_splits(splits: dict) -> None:
    """Stop each split's producer (its executor's pools are shut down: a
    run that ended before reading all of its data leaves them waiting),
    then its coordinator actor."""
    import ray_tpu_torch

    for its in splits.values():
        try:
            its[0].close()
            ray_tpu_torch.kill(its[0]._coord)
        except Exception:  # noqa: BLE001 - the run's result stands
            pass


class TrainController:
    """Runs as an actor (created by the Trainer); drives the worker group."""

    def __init__(self, train_fn: Callable, train_loop_config: dict | None,
                 scaling_config: ScalingConfig, run_config: RunConfig,
                 backend_config: TorchBackendConfig | None = None,
                 datasets: dict | None = None):
        self.train_fn = train_fn
        self.datasets = datasets or {}
        self.train_loop_config = train_loop_config
        self.scaling = scaling_config
        self.run_config = run_config
        self.backend_config = backend_config or TorchBackendConfig()
        storage = run_config.storage_path or os.path.join(
            get_config().temp_dir, "train")
        name = run_config.name or f"train-{int(time.time())}"
        self.ckpt_manager = CheckpointManager(
            f"{storage}/{name}",
            num_to_keep=run_config.checkpoint_config.num_to_keep,
        )
        self.metrics_history: list[dict] = []
        self.restart_log: list[dict] = []
        self._callbacks = list(run_config.callbacks)
        self._run_name = name
        self._rank0_reports = 0  # callback iteration counter (rank-0 only)
        # An open restart-downtime window, closed by the restarted group's
        # first report (goodput's restart_downtime event).
        self._goodput_pending: dict | None = None

    def _cb(self, hook: str, *args) -> None:
        for cb in self._callbacks:
            try:
                getattr(cb, hook)(*args)
            except Exception:  # noqa: BLE001 - a tracker must not kill a run
                traceback.print_exc()

    def _choose_tier(self, world: int, prev_world: int | None) -> str:
        """Restore tier for the NEXT group after a failure: ``elastic_shrink``
        when capacity loss forced a smaller world, else ``checkpoint``."""
        if prev_world is not None and world < prev_world:
            return "elastic_shrink"
        return "checkpoint"

    def _record_restart(self, failure: _GroupFailure | None, tier: str,
                        restart_index: int, world_before: int | None,
                        world_after: int, spares_taken: int) -> None:
        latest = self.ckpt_manager.latest()
        self.restart_log.append({
            "run": self._run_name,
            "restart_index": restart_index,
            "tier": tier,
            "trigger": getattr(failure, "trigger", "controller_error"),
            "detected_ts": getattr(failure, "detected_ts", time.time()),
            "detection_latency_s": getattr(failure, "since_last_ok_s", None),
            "dead_ranks": sorted(getattr(failure, "dead", {})),
            "error_ranks": sorted(getattr(failure, "errors", {})),
            "world_before": world_before,
            "world_after": world_after,
            "checkpoint": latest.path if latest else None,
            "spares_promoted": spares_taken,
        })
        decision = self.restart_log[-1]
        if tier != "abort":
            # Chips proxy: one chip per rank of the NEW world (each of
            # the port's ranks drives one card).
            self._goodput_pending = {
                "start_ts": decision["detected_ts"],
                "tier": tier,
                "restart_index": restart_index,
                "chips": float(world_after or 0),
                "trigger": decision["trigger"],
                "detection_latency_s": decision["detection_latency_s"],
            }

    # --------------------------------------------------------------- run
    def run(self) -> Result:
        """The control loop (reference: controller.py:634). Each (re)start
        consults the scaling policy, picks a restore tier and builds the
        group from spares where there are any."""
        from ray_tpu_torch.train.scaling_policy import make_scaling_policy

        self._cb("on_run_start", self._run_name, self.train_loop_config)
        max_failures = self.run_config.failure_config.max_failures
        policy = make_scaling_policy(self.scaling)
        self._spares = SparePool(self.scaling, self._run_name,
                                 self.ckpt_manager.storage_path,
                                 self.scaling.hot_spares,
                                 warmup=self.scaling.hot_spare_warmup)
        restart_count = 0
        prev_world: int | None = None
        pending_failure: _GroupFailure | None = None
        try:
            while True:
                group = None
                splits: dict = {}
                try:
                    world = policy.decide_world_size(restart_count)
                    recycled: list = []
                    if restart_count > 0:
                        tier = self._choose_tier(world, prev_world)
                        recycled = self._spares.take(world)
                        self._record_restart(
                            pending_failure, tier, restart_count,
                            prev_world, world, len(recycled))
                        pending_failure = None
                    group = WorkerGroup(
                        self.scaling, self.run_config.name or "train",
                        self.ckpt_manager.storage_path, num_workers=world,
                        recycled=recycled,
                    )
                    prev_world = world
                    coordinator = f"127.0.0.1:{free_port()}" \
                        if self.backend_config.distributed else None
                    latest = self.ckpt_manager.latest()
                    group.setup(coordinator, restart_count,
                                latest.path if latest else None)
                    self.backend_config.make_backend().on_start(group,
                                                                coordinator)
                    if self.datasets:
                        # Split per (re)start so elastic world-size changes
                        # get fresh equal splits (reference: datasets= are
                        # streaming_split across the current worker group).
                        splits = {name: ds.streaming_split(world, equal=True)
                                  for name, ds in self.datasets.items()}
                        group.assign_dataset_shards([
                            {name: its[rank] for name, its in splits.items()}
                            for rank in range(world)])
                    group.run(self.train_fn, self.train_loop_config)
                    # Replenish the spare pool only once the group is up:
                    # the run's own workers always get capacity first.
                    self._spares.fill()
                    failures_left = (float("inf") if max_failures < 0
                                     else max_failures - restart_count)
                    result = self._poll_until_done(group, failures_left)
                    result.restarts = list(self.restart_log)
                    self._cb("on_run_end", result)
                    return result
                except Exception as e:  # noqa: BLE001 - worker/actor failures
                    restart_count += 1
                    pending_failure = e if isinstance(e, _GroupFailure) \
                        else _GroupFailure("controller_error", str(e))
                    # The single failure budget: restart_count consumes it
                    # on EVERY path (poll-observed failures raise
                    # _GroupFailure with budget left; setup/backend errors
                    # land here directly).
                    if max_failures >= 0 and restart_count > max_failures:
                        self._record_restart(
                            pending_failure, "abort", restart_count,
                            prev_world, 0, 0)
                        result = Result(
                            error=traceback.format_exc(),
                            checkpoint=self.ckpt_manager.latest(),
                            metrics_history=self.metrics_history,
                            restarts=list(self.restart_log))
                        self._cb("on_run_end", result)
                        return result
                    # else: loop → new worker group, tier chosen at the top
                finally:
                    if group is not None:
                        group.shutdown()
                    _close_splits(splits)
        finally:
            self._spares.shutdown()

    def _poll_until_done(self, group: WorkerGroup,
                         failures_left: float) -> Result:
        """Poll loop; ``failures_left`` is the REMAINING restart budget, so
        whether a failure triggers a restart or ends the run is decided by
        the same counter run() enforces."""
        last_ok = time.monotonic()
        while True:
            status = group.poll_status(timeout=60)
            if status.reports and self._goodput_pending is not None:
                # First post-restart report: the run is stepping again —
                # close the downtime window [failure detected → the
                # earliest worker-stamped report instant].
                pg, self._goodput_pending = self._goodput_pending, None
                try:
                    from ray_tpu_torch.observability import goodput as _goodput

                    end_ts = min((r.get("ts") for r in status.reports
                                  if r.get("ts")), default=None) or time.time()
                    _goodput.record_event(
                        "restart_downtime", run=self._run_name,
                        seconds=max(0.0, end_ts - pg["start_ts"]),
                        chips=pg["chips"], start_ts=pg["start_ts"],
                        detail={k: pg[k] for k in
                                ("tier", "restart_index", "trigger",
                                 "detection_latency_s")})
                except Exception:  # noqa: BLE001 - never break the poll
                    pass
            for rep in status.reports:
                self.metrics_history.append(rep["metrics"])
                if rep.get("rank", 0) == 0:
                    self._rank0_reports += 1
                    self._cb("on_result", rep["metrics"], self._rank0_reports)
                if rep.get("checkpoint") and rep.get("rank", 0) == 0:
                    self.ckpt_manager.register(rep["checkpoint"], rep["metrics"])
                    self._cb("on_checkpoint", rep["checkpoint"], rep["metrics"])
            if status.errors or status.dead:
                parts = [f"rank {r}: {e}"
                         for r, e in sorted(status.errors.items())]
                parts += [f"rank {r} died: {e}"
                          for r, e in sorted(status.dead.items())]
                err = "\n".join(parts)
                trigger = "worker_dead" if status.dead else "worker_error"
                if failures_left > 0:
                    raise _GroupFailure(
                        trigger, f"worker failure (will restart): {err}",
                        dead=status.dead, errors=status.errors,
                        since_last_ok_s=time.monotonic() - last_ok)
                return Result(error=err, checkpoint=self.ckpt_manager.latest(),
                              metrics_history=self.metrics_history,
                              restarts=list(self.restart_log))
            last_ok = time.monotonic()
            if status.finished:
                last = self.metrics_history[-1] if self.metrics_history else {}
                return Result(metrics=last,
                              checkpoint=self.ckpt_manager.latest(),
                              metrics_history=self.metrics_history,
                              restarts=list(self.restart_log))
            time.sleep(0.05)
