"""Trainable API: class trainables and function trainables.

Port of ray_tpu/tune/trainable.py (reference:
python/ray/tune/trainable/trainable.py Trainable — setup/step/
save_checkpoint/load_checkpoint lifecycle; function_trainable.py wraps a
user function whose ``tune.report`` calls become step results).

Trainables run inside a trial actor of the in-process runtime; the Tuner
calls ``train_step`` repeatedly so schedulers can intervene between
steps. A function trainable runs the user function in a thread of its
own; ``cleanup`` (the trial actor's ``stop``) unblocks it at its next
``report`` and waits for it to end, so that what the function holds (a
model on the card, say) is released before the trial is gone. The RL
algorithms subclass ``Trainable``.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Any, Callable

# How long cleanup waits for a stopped function trainable's thread: it
# ends at its next report(), after the step it is running.
STOP_JOIN_S = 120.0


class Trainable:
    """Class trainable: subclass and implement setup/step (+ optionally
    save_checkpoint/load_checkpoint for PBT and fault tolerance)."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.iteration = 0
        self.setup(self.config)

    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        """Return a picklable checkpoint (dict of state)."""
        return None

    def load_checkpoint(self, checkpoint: Any) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Return True if the trainable can hot-swap configs (PBT explore
        without actor restart)."""
        return False

    def cleanup(self) -> None:
        pass

    # -- harness interface (called by the trial actor) --

    def train_step(self) -> dict:
        result = self.step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("done", False)
        return result


class _StopTrial(SystemExit):
    """Raised inside the user fn's thread to unwind a scheduler-stopped
    trial (prevents threads parked forever in report() backpressure)."""


class _ReportChannel:
    """Bridges tune.report() calls in a user thread to step() pulls."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue(maxsize=1)
        self.done = threading.Event()
        self.stopped = threading.Event()
        self.error: BaseException | None = None
        self.latest_checkpoint: Any = None


_local = threading.local()


def _get_channel() -> _ReportChannel:
    ch = getattr(_local, "tune_channel", None)
    if ch is None:
        raise RuntimeError("tune.report() called outside a tune function trainable")
    return ch


def report(metrics: dict, checkpoint: Any = None) -> None:
    """Report one step's metrics from inside a function trainable. Blocks
    until the controller consumes the previous report (backpressure keeps
    report cadence == step cadence, reference function-trainable semantics)."""
    ch = _get_channel()
    item = {"metrics": dict(metrics), "checkpoint": checkpoint}
    while True:
        if ch.stopped.is_set():
            raise _StopTrial()
        try:
            ch.q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def get_checkpoint() -> Any:
    """Inside a function trainable: the checkpoint to restore from, if any."""
    ch = _get_channel()
    return ch.latest_checkpoint


class FunctionTrainable(Trainable):
    """Wraps fn(config) into the step lifecycle: each tune.report() is one
    step result (reference: tune/trainable/function_trainable.py)."""

    _fn: Callable | None = None  # set by subclassing in wrap_function

    def setup(self, config: dict) -> None:
        self._channel = _ReportChannel()
        self._thread: threading.Thread | None = None
        self._checkpoint_to_restore: Any = None

    def _ensure_started(self) -> None:
        if self._thread is not None:
            return
        ch = self._channel
        ch.latest_checkpoint = self._checkpoint_to_restore
        fn = type(self)._fn

        def runner():
            _local.tune_channel = ch
            try:
                fn(self.config)
            except _StopTrial:
                pass
            except BaseException as e:  # surfaced on next step()
                ch.error = e
            finally:
                ch.done.set()

        self._thread = threading.Thread(
            target=runner, daemon=True,
            name=f"rtpu-tune-{getattr(fn, '__name__', 'trainable')}")
        self._thread.start()

    def step(self) -> dict:
        self._ensure_started()
        ch = self._channel
        while True:
            try:
                item = ch.q.get(timeout=0.05)
                if item["checkpoint"] is not None:
                    ch.latest_checkpoint = item["checkpoint"]
                metrics = item["metrics"]
                metrics.setdefault("done", False)
                return metrics
            except queue.Empty:
                if ch.done.is_set() and ch.q.empty():
                    if ch.error is not None:
                        raise ch.error
                    return {"done": True}

    def save_checkpoint(self) -> Any:
        return self._channel.latest_checkpoint

    def load_checkpoint(self, checkpoint: Any) -> None:
        self._checkpoint_to_restore = checkpoint

    def cleanup(self) -> None:
        ch = self._channel
        ch.stopped.set()
        try:
            while True:
                ch.q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(STOP_JOIN_S)
            if self._thread.is_alive():
                print(f"tune: {self._thread.name} still running "
                      f"{STOP_JOIN_S:.0f} s after stop (no report() since)",
                      file=sys.stderr)


def wrap_function(fn: Callable) -> type:
    """Build a FunctionTrainable subclass running ``fn``."""
    return type(f"fn_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})


class TrialActor:
    """The actor hosting one trial's Trainable (reference: trials run in
    remote Trainable actors driven by TuneController)."""

    def __init__(self, trainable_cls: type, config: dict,
                 checkpoint: Any = None, start_iteration: int = 0):
        self._cls = trainable_cls
        self._trainable = trainable_cls(config or {})
        # Restarted trials (PBT clone, fault recovery) keep their place on
        # the training_iteration axis (reference restore semantics).
        self._trainable.iteration = start_iteration
        if checkpoint is not None:
            self._trainable.load_checkpoint(checkpoint)

    def train_step(self) -> dict:
        return self._trainable.train_step()

    def save(self) -> Any:
        return self._trainable.save_checkpoint()

    def restore(self, checkpoint: Any) -> None:
        self._trainable.load_checkpoint(checkpoint)

    def reset(self, new_config: dict, checkpoint: Any = None) -> bool:
        """Try an in-place config swap (PBT); False → caller restarts actor."""
        ok = self._trainable.reset_config(new_config)
        if ok:
            self._trainable.config = new_config
            if checkpoint is not None:
                self._trainable.load_checkpoint(checkpoint)
        return ok

    def stop(self) -> None:
        self._trainable.cleanup()
