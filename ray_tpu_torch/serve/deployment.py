"""@serve.deployment and application graphs.

Port of ray_tpu/serve/deployment.py: ``.bind(...)`` builds an application
node whose Application-typed args are replaced by DeploymentHandles at
deploy time (model composition); ``.options(...)`` overrides the config.

Refused where the deployment is declared, so the error does not surface
later as a serve.run timeout: ``placement_group_bundles`` (gang placement
groups, ROADMAP Queue A item 7(b)). ``trace_sample_rate`` is the
deployment's request-tracing head-sampling rate.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.resilience import CircuitBreakerConfig, RetryPolicy


def _refuse_pg(bundles: list | None, strategy: str | None) -> None:
    if bundles is not None or strategy not in (None, "PACK"):
        raise NotImplementedError(
            "placement_group_bundles: per-replica gang placement groups "
            "need the cluster runtime (ROADMAP Queue A item 7(b)); the "
            "in-process runtime has one node")


class Application:
    """A bound deployment node (reference: serve/_private/build_app.py)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class: Callable, name: str,
                 config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, *, name: str | None = None, num_replicas: int | None = None,
                max_ongoing_requests: int | None = None,
                autoscaling_config: AutoscalingConfig | dict | None = None,
                user_config: Any = None, version: str | None = None,
                health_check_period_s: float | None = None,
                graceful_shutdown_timeout_s: float | None = None,
                ray_actor_options: dict | None = None,
                placement_group_bundles: list | None = None,
                placement_group_strategy: str | None = None,
                request_timeout_s: float | None = None,
                max_queued_requests: int | None = None,
                replica_queue_slack: int | None = None,
                retry_policy: RetryPolicy | dict | None = None,
                circuit_breaker: CircuitBreakerConfig | dict | None = None
                ) -> "Deployment":
        _refuse_pg(placement_group_bundles, placement_group_strategy)
        cfg = replace(self.config)
        if request_timeout_s is not None:
            cfg.request_timeout_s = request_timeout_s
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if replica_queue_slack is not None:
            cfg.replica_queue_slack = replica_queue_slack
        if retry_policy is not None:
            cfg.retry_policy = (RetryPolicy(**retry_policy)
                                if isinstance(retry_policy, dict)
                                else retry_policy)
        if circuit_breaker is not None:
            cfg.circuit_breaker = (CircuitBreakerConfig(**circuit_breaker)
                                   if isinstance(circuit_breaker, dict)
                                   else circuit_breaker)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if user_config is not None:
            cfg.user_config = user_config
        if version is not None:
            cfg.version = version
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        return Deployment(self.func_or_class, name or self.name, cfg)


def deployment(_func_or_class: Callable | None = None, *,
               name: str | None = None, num_replicas: int = 1,
               max_ongoing_requests: int = 16,
               autoscaling_config: AutoscalingConfig | dict | None = None,
               user_config: Any = None, version: str | None = None,
               health_check_period_s: float = 1.0,
               graceful_shutdown_timeout_s: float = 5.0,
               ray_actor_options: dict | None = None,
               placement_group_bundles: list | None = None,
               placement_group_strategy: str = "PACK",
               request_timeout_s: float = 30.0,
               max_queued_requests: int = 256,
               replica_queue_slack: int = 8,
               retry_policy: RetryPolicy | dict | None = None,
               circuit_breaker: CircuitBreakerConfig | dict | None = None,
               trace_sample_rate: float | None = None):
    """``@serve.deployment``.

    Resilience knobs (full semantics on DeploymentConfig /
    serve/resilience.py): ``request_timeout_s`` is the default per-request
    budget, ``max_queued_requests`` bounds the router queue (shed with
    Overloaded beyond it), ``replica_queue_slack`` bounds replica-side
    admission, ``retry_policy`` configures assignment retries and tail
    hedging, ``circuit_breaker`` the per-replica blacklist,
    ``trace_sample_rate`` the deployment's request-tracing head-sampling
    rate (None = the process default Config.trace_sample_rate).
    ``ray_actor_options={"num_gpus": n}`` gives each replica n of the
    runtime's ``"GPU"`` resource."""
    _refuse_pg(placement_group_bundles, placement_group_strategy)

    def deco(func_or_class: Callable) -> Deployment:
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        rp = (RetryPolicy(**retry_policy) if isinstance(retry_policy, dict)
              else retry_policy) or RetryPolicy()
        cb = (CircuitBreakerConfig(**circuit_breaker)
              if isinstance(circuit_breaker, dict)
              else circuit_breaker) or CircuitBreakerConfig()
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=asc,
            user_config=user_config,
            version=version,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=ray_actor_options or {},
            request_timeout_s=request_timeout_s,
            max_queued_requests=max_queued_requests,
            replica_queue_slack=replica_queue_slack,
            retry_policy=rp,
            circuit_breaker=cb,
            trace_sample_rate=trace_sample_rate,
        )
        return Deployment(func_or_class,
                          name or func_or_class.__name__, cfg)

    return deco(_func_or_class) if _func_or_class is not None else deco
