"""User-facing error types (port of ray_tpu/core/exceptions.py; the
cluster runtime's errors are not ported).

Capability parity with the reference's exception surface
(reference: python/ray/exceptions.py — RayError/RayTaskError/ActorDiedError/
ObjectLostError/OutOfMemoryError/...): errors raised on ``get`` carry the
remote traceback; actor/object loss is distinguishable and retryable state is
visible to callers.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ``get`` with the remote traceback."""

    def __init__(self, cause: BaseException, task_desc: str = "", remote_tb: str | None = None):
        self.cause = cause
        self.task_desc = task_desc
        self.remote_tb = remote_tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(f"task {task_desc} failed: {cause!r}\nremote traceback:\n{self.remote_tb}")

    def __reduce__(self):
        # Strip the traceback object (not always picklable); keep its text.
        cause = self.cause
        try:
            import pickle

            pickle.dumps(cause)
        except Exception:
            cause = RuntimeError(repr(self.cause))
        return (TaskError, (cause, self.task_desc, self.remote_tb))


class TaskCancelledError(RayTpuError):
    pass


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """``never_sent=True`` marks calls that provably never reached the dead
    actor (queued caller-side / drained from an unstarted mailbox): they
    cannot have executed, so retrying them is safe even for
    non-idempotent methods. Calls that were in flight on the dead
    incarnation keep the default False (at-most-once: they may have run)."""

    def __init__(self, actor_id_hex: str = "", reason: str = "",
                 never_sent: bool = False):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        self.never_sent = never_sent
        super().__init__(f"actor {actor_id_hex[:12]} died: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id_hex, self.reason,
                                 self.never_sent))


class ActorUnavailableError(ActorError):
    """Transient: actor restarting; calls may be retried."""


class ObjectLostError(RayTpuError):
    def __init__(self, object_id_hex: str = "", reason: str = "owner or primary copy lost"):
        self.object_id_hex = object_id_hex
        self.reason = reason
        super().__init__(f"object {object_id_hex[:12]} lost: {reason}")

    def __reduce__(self):
        return (type(self), (self.object_id_hex, self.reason))


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class OutOfMemoryError(RayTpuError):
    pass
