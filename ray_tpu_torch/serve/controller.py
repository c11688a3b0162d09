"""ServeController: the serve control plane.

Port of ray_tpu/serve/controller.py: a named actor owning the desired
state, reconciled in a background thread: the replica state machine
STARTING/RUNNING/STOPPING with rolling updates, health checks, autoscaling
from the replicas' ongoing-request counts, prefix-cache publication, and
graceful drains, with every change pushed to routers through the
long-poll host.

``ray_actor_options["num_gpus"]`` is the counterpart of the JAX package's
``num_tpus``: it demands the runtime's ``"GPU"`` resource. A stopped
replica is drained, then its ``stop`` releases what its callable holds
(serve/replica.py), then it is killed, and it leaves the deployment's
list only once its thread has given its resources back (so
``serve.shutdown()`` returns with them available). The reconcile thread
carries the
runtime's thread-name prefix and ends when the runtime shuts down.

Out: gang placement groups (refused where a deployment is declared,
ROADMAP Queue A item 7(b)) and the cluster runtime's connection-loss
back-off.
"""

from __future__ import annotations

import hashlib
import math
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import ActorDiedError
from ray_tpu_torch.serve.config import DeploymentConfig, DeploymentStatus, ReplicaInfo
from ray_tpu_torch.serve.long_poll import LongPollHost
from ray_tpu_torch.serve.replica import ServeReplica
from ray_tpu_torch.serve.resilience import unwrap

STARTING, RUNNING, STOPPING = "STARTING", "RUNNING", "STOPPING"

# How long a stopping replica's ``stop`` may take (an engine's shutdown
# joins its scheduler thread) before the replica is killed regardless.
STOP_TIMEOUT_S = 60.0

# How long a killed replica's thread may take to give its resources back
# before the controller drops it regardless.
RELEASE_TIMEOUT_S = 10.0

# How often the controller collects each replica's prefix-cache hashes.
PREFIX_PUBLISH_PERIOD_S = 0.5


@dataclass
class _Replica:
    replica_id: str
    actor_name: str
    actor: Any
    version: str
    state: str = STARTING
    ready_ref: Any = None
    health_ref: Any = None
    health_sent_at: float = 0.0
    consecutive_failures: int = 0
    drain_ref: Any = None
    stop_ref: Any = None  # the replica's stop() call, before the kill
    stop_deadline: float = 0.0
    # Killed: kept (STOPPING) until its thread has released its resources.
    killed: bool = False
    # Prefix-cache publication (KV-block-aware routing): last collected
    # router_meta state. prefix_capable None = not yet probed; False =
    # replica answered None once, never polled again (non-LLM deployment).
    prefix_blocks: tuple | None = None
    prefix_block: int = 0
    prefix_capable: bool | None = None
    prefix_ref: Any = None
    prefix_sent_at: float = 0.0


@dataclass
class _DeploymentState:
    name: str
    app_name: str
    cls_blob: bytes
    init_args_blob: bytes
    config: DeploymentConfig
    version: str
    replicas: list[_Replica] = field(default_factory=list)
    deleting: bool = False
    published: list | None = None  # last replica snapshot sent to routers
    # autoscaling bookkeeping
    last_metric_pull: float = 0.0
    total_ongoing: float = 0.0
    desired_since: tuple[int, float] | None = None  # (desired, since_ts)
    autoscale_target: int | None = None
    message: str = ""


class ServeController:
    """Runs as a named actor; reconciles in a background thread."""

    def __init__(self, reconcile_interval_s: float = 0.05):
        from ray_tpu_torch.core.worker import global_worker

        self._interval = reconcile_interval_s
        self._lock = threading.RLock()
        self._deployments: dict[str, _DeploymentState] = {}
        self._apps: dict[str, list[str]] = {}
        self._routes: dict[str, str] = {}  # route_prefix -> deployment name
        self._app_ingress: dict[str, str] = {}  # app name -> ingress dep
        self._long_poll = LongPollHost()
        self._shutdown = threading.Event()
        self._runtime = global_worker.runtime
        self._thread = self._runtime._start_thread(
            self._control_loop, (), "serve-controller")

    # ---- API (called by serve.api / handles / proxies) ----

    def deploy_application(self, app_name: str, deployments: list[dict],
                           ingress_name: str | None,
                           route_prefix: str | None) -> None:
        with self._lock:
            old = set(self._apps.get(app_name, []))
            new_names = []
            for d in deployments:
                name = d["name"]
                new_names.append(name)
                version = d["config"].version or hashlib.sha1(
                    d["cls_blob"] + d["init_args_blob"] +
                    repr(d["config"].user_config).encode() +
                    repr(d["config"].num_replicas).encode()
                ).hexdigest()[:12]
                cur = self._deployments.get(name)
                if cur is None:
                    self._deployments[name] = _DeploymentState(
                        name=name, app_name=app_name, cls_blob=d["cls_blob"],
                        init_args_blob=d["init_args_blob"], config=d["config"],
                        version=version)
                else:
                    cur.cls_blob = d["cls_blob"]
                    cur.init_args_blob = d["init_args_blob"]
                    cur.config = d["config"]
                    cur.version = version
                    cur.deleting = False
            for stale in old - set(new_names):
                self._deployments[stale].deleting = True
            self._apps[app_name] = new_names
            if ingress_name:
                # gRPC routes by app name even when there is no HTTP route
                # prefix (route_prefix=None).
                self._app_ingress[app_name] = ingress_name
            if ingress_name and route_prefix is not None:
                self._routes[route_prefix] = ingress_name
                self._long_poll.notify_changed("routes", dict(self._routes))

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            self._app_ingress.pop(app_name, None)
            for name in self._apps.pop(app_name, []):
                if name in self._deployments:
                    self._deployments[name].deleting = True
            self._routes = {r: d for r, d in self._routes.items()
                            if d in {n for ns in self._apps.values() for n in ns}}
            self._long_poll.notify_changed("routes", dict(self._routes))

    def get_replicas(self, deployment_name: str) -> list[ReplicaInfo]:
        with self._lock:
            ds = self._deployments.get(deployment_name)
            if ds is None:
                return []
            return self._running_infos(ds)

    def listen(self, keys_to_versions: dict, timeout: float = 10.0) -> dict:
        return self._long_poll.listen(keys_to_versions, timeout)

    def get_routes(self) -> dict[str, str]:
        with self._lock:
            return dict(self._routes)

    def report_replica_unhealthy(self, deployment_name: str,
                                 replica_id: str, reason: str = "") -> None:
        """Router circuit-breaker feedback: a breaker opened on this
        replica. Counts as one failed health check AND schedules an
        immediate out-of-band probe — a genuinely sick replica fails it
        and gets replaced for every router, while a healthy-but-slow one
        passes and stays up (blacklisted only where the breaker saw the
        latency). Repeated breaker trips therefore converge on replacement
        without letting one router's opinion kill a replica outright."""
        with self._lock:
            ds = self._deployments.get(deployment_name)
            if ds is None:
                return
            for r in ds.replicas:
                if r.replica_id == replica_id and r.state == RUNNING:
                    # Reports alone must never reach the replacement
                    # threshold — several routers (the program's and each
                    # proxy's) tripping at once would stop a slow-but-healthy
                    # replica before its probe returns. Cap one below:
                    # only an actually failed/timed-out probe pushes over.
                    r.consecutive_failures = min(
                        r.consecutive_failures + 1,
                        ds.config.max_consecutive_health_failures - 1)
                    if r.health_ref is None:
                        # Probe on the next reconcile. Only when no probe
                        # is already outstanding: zeroing health_sent_at
                        # under an in-flight probe would trip the
                        # stale-probe timeout branch — a spurious SECOND
                        # strike that also discards the (likely passing)
                        # probe result.
                        r.health_sent_at = 0.0
                    ds.message = (f"router breaker opened on "
                                  f"{replica_id}: {reason}")
                    break

    def get_app_ingresses(self) -> dict[str, str]:
        """app name -> ingress deployment, including HTTP-less (gRPC-only,
        route_prefix=None) applications."""
        with self._lock:
            return dict(self._app_ingress)

    def status(self) -> dict[str, DeploymentStatus]:
        with self._lock:
            out = {}
            for name, ds in self._deployments.items():
                counts: dict[str, int] = {}
                for r in ds.replicas:
                    counts[r.state] = counts.get(r.state, 0) + 1
                target = self._target_count(ds)
                healthy = sum(1 for r in ds.replicas
                              if r.state == RUNNING and r.version == ds.version)
                status = ("HEALTHY" if healthy >= target and not ds.deleting
                          else "UPDATING")
                out[name] = DeploymentStatus(name=name, status=status,
                                             replica_states=counts,
                                             message=ds.message)
            return out

    def graceful_shutdown(self) -> None:
        with self._lock:
            for ds in self._deployments.values():
                ds.deleting = True
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with self._lock:
                if all(not ds.replicas for ds in self._deployments.values()):
                    break
            time.sleep(0.05)
        self._shutdown.set()
        self._long_poll.close()

    # ---- reconcile loop ----

    def _control_loop(self) -> None:
        rt = self._runtime
        while not self._shutdown.is_set() and not rt._shutdown:
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001 - loop must survive all
                if rt._shutdown:
                    break
                traceback.print_exc()
            self._shutdown.wait(self._interval)
        self._long_poll.close()

    def _reconcile_once(self) -> None:
        with self._lock:
            items = list(self._deployments.items())
        for name, ds in items:
            with self._lock:
                self._check_starting(ds)
                self._check_health(ds)
                self._collect_prefix_state(ds)
                self._autoscale(ds)
                target = 0 if ds.deleting else self._target_count(ds)
                self._scale_and_roll(ds, target)
                self._reap_stopped(ds)
                after = self._running_infos(ds)
                # Compare against the LAST PUBLISHED snapshot, not a
                # same-pass before (a settings-only redeploy swaps
                # ds.config between passes — an intra-pass before/after
                # would already both carry the new settings and compare
                # equal). Dataclass equality covers the settings dict, so
                # draining transitions AND settings-only redeploys (e.g.
                # tightening max_queued_requests during an incident, which
                # rolls no replicas) both reach routers.
                if after != ds.published:
                    ds.published = after
                    self._long_poll.notify_changed(f"replicas:{name}", after)
                if ds.deleting and not ds.replicas:
                    del self._deployments[name]

    def _target_count(self, ds: _DeploymentState) -> int:
        asc = ds.config.autoscaling_config
        if asc is None:
            return ds.config.num_replicas
        if ds.autoscale_target is None:
            ds.autoscale_target = asc.min_replicas
        return ds.autoscale_target

    def _running_infos(self, ds: _DeploymentState) -> list[ReplicaInfo]:
        """Router-facing snapshot: RUNNING replicas plus gracefully-draining
        ones flagged ``draining=True`` (published, never assigned — a
        router that saw the pre-drain snapshot must learn the replica is
        retiring rather than racing new work onto it). Each info carries
        the deployment-level resilience settings dict."""
        settings = ds.config.resilience_settings().to_dict()
        infos = []
        for r in ds.replicas:
            draining = r.state == STOPPING and r.drain_ref is not None
            if r.state != RUNNING and not draining:
                continue
            infos.append(ReplicaInfo(
                replica_id=r.replica_id,
                deployment_name=ds.name,
                actor_name=r.actor_name,
                max_ongoing_requests=ds.config.max_ongoing_requests,
                draining=draining,
                settings=settings,
                # Prefix-cache publication rides the snapshot; dataclass
                # equality against ds.published means a changed hash set
                # republishes (throttled by the collection cadence).
                prefix_blocks=r.prefix_blocks,
                prefix_block=r.prefix_block))
        return infos

    # -- replica lifecycle --

    def _start_replica(self, ds: _DeploymentState) -> "_Replica | None":
        rid = uuid.uuid4().hex[:8]
        actor_name = f"SERVE_REPLICA::{ds.name}#{rid}"
        rep = _Replica(replica_id=rid, actor_name=actor_name, actor=None,
                       version=ds.version)
        ds.replicas.append(rep)
        self._launch_replica_actor(ds, rep)
        return rep if rep in ds.replicas else None

    def _launch_replica_actor(self, ds: _DeploymentState,
                              rep: _Replica) -> None:
        opts = dict(ds.config.ray_actor_options)
        Remote = ray_tpu_torch.remote(ServeReplica)
        # Thread budget must exceed the replica's admission cap
        # (max_ongoing + queue slack) so over-cap calls actually reach the
        # admission check and get an Overloaded answer promptly instead of
        # queuing silently in the actor mailbox.
        slack = getattr(ds.config, "replica_queue_slack", 8)
        try:
            rep.actor = Remote.options(
                name=rep.actor_name, namespace="serve",
                num_cpus=opts.get("num_cpus", 0),
                num_gpus=opts.get("num_gpus", 0),
                resources=opts.get("resources"),
                max_concurrency=ds.config.max_ongoing_requests + slack + 4,
            ).remote(ds.name, rep.replica_id, ds.cls_blob, ds.init_args_blob,
                     ds.config.user_config,
                     max_ongoing_requests=ds.config.max_ongoing_requests,
                     replica_queue_slack=slack)
        except Exception as e:  # noqa: BLE001 - infeasible/registration fail
            ds.message = f"replica actor creation failed: {e!r}"
            ds.replicas.remove(rep)
            return
        rep.ready_ref = rep.actor.get_metrics.remote()  # readiness probe

    def _check_starting(self, ds: _DeploymentState) -> None:
        for r in list(ds.replicas):
            if r.state != STARTING:
                continue
            if r.ready_ref is None:
                continue
            ready, _ = ray_tpu_torch.wait([r.ready_ref], num_returns=1, timeout=0)
            if ready:
                try:
                    ray_tpu_torch.get(r.ready_ref)
                    r.state = RUNNING
                    r.ready_ref = None
                except Exception as e:
                    ds.message = f"replica failed to start: {e!r}"
                    self._stop_replica(ds, r, force=True)

    def _check_health(self, ds: _DeploymentState) -> None:
        now = time.monotonic()
        for r in ds.replicas:
            if r.state != RUNNING:
                continue
            if r.health_ref is None:
                if now - r.health_sent_at >= ds.config.health_check_period_s:
                    r.health_ref = r.actor.check_health.remote()
                    r.health_sent_at = now
                continue
            ready, _ = ray_tpu_torch.wait([r.health_ref], num_returns=1, timeout=0)
            if ready:
                try:
                    ray_tpu_torch.get(r.health_ref)
                    r.consecutive_failures = 0
                except Exception as e:
                    # A DEAD actor is not a flaky health check: skip the
                    # 3-strikes grace and replace it now — every second of
                    # grace is a second of routers retrying into a corpse.
                    if isinstance(unwrap(e), ActorDiedError):
                        r.consecutive_failures = \
                            ds.config.max_consecutive_health_failures
                    else:
                        r.consecutive_failures += 1
                r.health_ref = None
            elif now - r.health_sent_at > ds.config.health_check_timeout_s:
                r.consecutive_failures += 1
                r.health_ref = None
            if r.consecutive_failures >= ds.config.max_consecutive_health_failures:
                ds.message = f"replica {r.replica_id} failed health checks"
                self._stop_replica(ds, r, force=True)

    def _collect_prefix_state(self, ds: _DeploymentState) -> None:
        """Poll each RUNNING replica's router_meta() on a cadence and stash
        its prefix-cache chain hashes on the replica record; _running_infos
        piggybacks them on the long-poll snapshot (KV-block-aware routing,
        serve/prefix.py). Non-blocking like the health checks: one
        outstanding probe per replica, collected on a later pass. A replica
        that answers None once (no router_prefix_blocks on the callable) is
        marked incapable and never polled again."""
        if ds.deleting:
            return
        now = time.monotonic()
        for r in ds.replicas:
            if r.state != RUNNING or r.prefix_capable is False:
                continue
            if r.prefix_ref is None:
                if now - r.prefix_sent_at >= PREFIX_PUBLISH_PERIOD_S:
                    try:
                        r.prefix_ref = r.actor.router_meta.remote()
                        r.prefix_sent_at = now
                    except Exception:  # noqa: BLE001 - replica racing away
                        pass
                continue
            ready, _ = ray_tpu_torch.wait([r.prefix_ref], num_returns=1, timeout=0)
            if ready:
                meta, answered = None, True
                try:
                    meta = ray_tpu_torch.get(r.prefix_ref)
                except Exception:  # noqa: BLE001 - health checks own
                    answered = False  # replica-death handling; retry later
                r.prefix_ref = None
                if not answered:
                    # Transient RPC failure is NOT a "doesn't publish"
                    # answer — marking incapable here would blind every
                    # router to this replica's cache for its lifetime.
                    continue
                if meta is None:
                    if r.prefix_capable is None:
                        r.prefix_capable = False
                    continue
                r.prefix_capable = True
                r.prefix_blocks = tuple(meta.get("blocks") or ())
                r.prefix_block = int(meta.get("block") or 0)
            elif now - r.prefix_sent_at > 10.0:
                r.prefix_ref = None  # wedged probe: retry next period

    def _autoscale(self, ds: _DeploymentState) -> None:
        asc = ds.config.autoscaling_config
        if asc is None or ds.deleting:
            return
        now = time.monotonic()
        if now - ds.last_metric_pull >= asc.metrics_interval_s:
            ds.last_metric_pull = now
            refs = [r.actor.get_metrics.remote() for r in ds.replicas
                    if r.state == RUNNING]
            total = 0.0
            try:
                for m in ray_tpu_torch.get(refs, timeout=2.0):
                    total += m["ongoing"]
            except Exception:
                return
            ds.total_ongoing = total
        cur = ds.autoscale_target or asc.min_replicas
        raw = math.ceil(ds.total_ongoing / max(asc.target_ongoing_requests, 1e-9))
        desired = max(asc.min_replicas, min(asc.max_replicas, raw))
        if desired == cur:
            ds.desired_since = None
            return
        if ds.desired_since is None or ds.desired_since[0] != desired:
            ds.desired_since = (desired, now)
            return
        delay = (asc.upscale_delay_s if desired > cur
                 else asc.downscale_delay_s)
        if now - ds.desired_since[1] >= delay:
            ds.autoscale_target = desired
            ds.desired_since = None

    def _scale_and_roll(self, ds: _DeploymentState, target: int) -> None:
        live = [r for r in ds.replicas if r.state in (STARTING, RUNNING)]
        current_version = [r for r in live if r.version == ds.version]
        old_version = [r for r in live if r.version != ds.version]

        # Scale up with current-version replicas (also drives rolling
        # updates: new version starts first, old stops as new turn RUNNING).
        while len(current_version) < target:
            rep = self._start_replica(ds)
            if rep is None:  # PG creation / actor registration failed
                break        # ds.message set; next reconcile pass retries
            current_version.append(rep)

        running_new = sum(1 for r in current_version if r.state == RUNNING)
        # Retire old-version replicas as replacements come up.
        for r in list(old_version):
            if running_new > 0:
                self._stop_replica(ds, r)
                running_new -= 1

        # Scale down extras (prefer STARTING ones).
        extras = len(current_version) - target
        if extras > 0:
            victims = sorted(current_version,
                             key=lambda r: 0 if r.state == STARTING else 1)
            for r in victims[:extras]:
                self._stop_replica(ds, r)

    def _stop_replica(self, ds: _DeploymentState, r: _Replica,
                      force: bool = False) -> None:
        if r.state == STOPPING:
            return
        was_running = r.state == RUNNING
        r.state = STOPPING
        if force or not was_running:
            self._send_stop(r)
        else:
            # Drain in-flight requests, then kill once drained/timed out.
            timeout = ds.config.graceful_shutdown_timeout_s
            r.drain_ref = r.actor.prepare_for_shutdown.remote(timeout)
            r.stop_deadline = time.monotonic() + timeout + 1.0

    @staticmethod
    def _send_stop(r: _Replica) -> None:
        """Ask the replica to release its callable's resources; the kill
        follows once that call returns (or STOP_TIMEOUT_S passes)."""
        r.drain_ref = None
        r.stop_ref = r.actor.stop.remote()
        r.stop_deadline = time.monotonic() + STOP_TIMEOUT_S

    def _reap_stopped(self, ds: _DeploymentState) -> None:
        keep = []
        now = time.monotonic()
        for r in ds.replicas:
            if r.state != STOPPING:
                keep.append(r)
                continue
            if r.drain_ref is not None:
                done, _ = ray_tpu_torch.wait([r.drain_ref], num_returns=1,
                                             timeout=0)
                if not done and now < r.stop_deadline:
                    keep.append(r)
                    continue
                self._send_stop(r)
                keep.append(r)
                continue
            if not r.killed:
                done, _ = ray_tpu_torch.wait([r.stop_ref], num_returns=1,
                                             timeout=0)
                if not done and now < r.stop_deadline:
                    keep.append(r)
                    continue
                try:
                    ray_tpu_torch.kill(r.actor)
                except Exception:
                    pass
                r.killed = True
                r.stop_deadline = now + RELEASE_TIMEOUT_S
            # Drop the replica only once its resources are back, so that
            # graceful_shutdown (which waits for an empty list) returns
            # with them available.
            if (not ray_tpu_torch.api.wait_released(r.actor, 0)
                    and now < r.stop_deadline):
                keep.append(r)
        ds.replicas = keep
