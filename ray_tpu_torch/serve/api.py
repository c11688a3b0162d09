"""serve.run / serve.start / serve.status / serve.shutdown.

Port of ray_tpu/serve/api.py: ``run`` deploys an application graph,
blocks until it is healthy and returns the ingress handle; ``start``
creates the controller and the HTTP proxy.

A replica demand the runtime cannot meet at all (``num_gpus`` on a runtime
started without a ``"GPU"`` resource) raises ``ValueError`` in ``run``,
before anything is deployed. The gRPC proxy raises
``NotImplementedError``: the card machine has no ``grpcio``.
"""

from __future__ import annotations

import time
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE, DeploymentHandle
from ray_tpu_torch.serve.http_proxy import ProxyActor
from ray_tpu_torch.utils import serialization

_PROXY_NAME = "SERVE_PROXY"

_NO_GRPC = ("the gRPC proxy is not ported to ray_tpu_torch: the machine "
            "with the card has no grpcio; serve over HTTP")


def start(http_options: dict | None = None, detached: bool = True,
          grpc_options: dict | None = None):
    """Idempotently create the controller (and the HTTP proxy if
    requested). ``detached`` is accepted for the JAX package's signature:
    the in-process runtime's actors live until it shuts down."""
    if grpc_options is not None:
        raise NotImplementedError(_NO_GRPC)
    ray_tpu_torch.init()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                             namespace=SERVE_NAMESPACE)
    except ValueError:
        Controller = ray_tpu_torch.remote(ServeController)
        controller = Controller.options(
            name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE, num_cpus=0,
            max_concurrency=32,
        ).remote()
    if http_options is not None:
        try:
            ray_tpu_torch.get_actor(_PROXY_NAME, namespace=SERVE_NAMESPACE)
        except ValueError:
            Proxy = ray_tpu_torch.remote(ProxyActor)
            proxy = Proxy.options(
                name=_PROXY_NAME, namespace=SERVE_NAMESPACE, num_cpus=0,
                max_concurrency=32,
            ).remote(http_options.get("host", "127.0.0.1"),
                     http_options.get("port", 0))
            ray_tpu_torch.get(proxy.ready.remote())
    return controller


def _check_feasible(target: Application) -> None:
    """Raise at once for a replica demand larger than the runtime's total
    of some resource (the replica would otherwise die in its actor thread
    and serve.run would wait out its timeout)."""
    ray_tpu_torch.init()
    totals = ray_tpu_torch.cluster_resources()
    seen: set[int] = set()

    def walk(app: Application) -> None:
        if id(app) in seen:
            return
        seen.add(id(app))
        opts = app.deployment.config.ray_actor_options
        demand = {"CPU": opts.get("num_cpus", 0),
                  "GPU": opts.get("num_gpus", 0),
                  **(opts.get("resources") or {})}
        for k, v in demand.items():
            if v and totals.get(k, 0.0) < v:
                raise ValueError(
                    f"deployment {app.deployment.name!r} asks for {k}={v} "
                    f"per replica; the runtime has {totals.get(k, 0.0)} "
                    f"(start it with init(resources={{{k!r}: n}}))")
        for a in (*app.args, *app.kwargs.values()):
            if isinstance(a, Application):
                walk(a)

    walk(target)


def _controller():
    return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)


def run(target: Application, *, name: str = "default",
        route_prefix: str | None = "/", http: bool = False,
        http_port: int = 0, grpc: bool = False, grpc_port: int = 0,
        _blocking_timeout: float = 60.0) -> DeploymentHandle:
    """Deploy an application graph; block until healthy; return the ingress
    deployment's handle."""
    if grpc:
        raise NotImplementedError(_NO_GRPC)
    _check_feasible(target)
    controller = start(http_options={"port": http_port} if http else None)

    # Flatten the graph: depth-first over bound args, children first.
    seen: dict[int, str] = {}
    deployments: list[dict] = []

    def build(app: Application) -> str:
        if id(app) in seen:
            return seen[id(app)]
        dep: Deployment = app.deployment
        args = tuple(DeploymentHandle(build(a)) if isinstance(a, Application)
                     else a for a in app.args)
        kwargs = {k: (DeploymentHandle(build(v)) if isinstance(v, Application)
                      else v) for k, v in app.kwargs.items()}
        deployments.append({
            "name": dep.name,
            "cls_blob": serialization.serialize(dep.func_or_class),
            "init_args_blob": serialization.serialize((args, kwargs)),
            "config": dep.config,
        })
        seen[id(app)] = dep.name
        return dep.name

    ingress = build(target)
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, deployments, ingress, route_prefix))

    # Block until every deployment reports HEALTHY (reference: run waits for
    # the application to be RUNNING).
    deadline = time.monotonic() + _blocking_timeout
    while time.monotonic() < deadline:
        statuses = ray_tpu_torch.get(controller.status.remote())
        mine = [statuses[d["name"]] for d in deployments
                if d["name"] in statuses]
        if mine and all(s.status == "HEALTHY" for s in mine):
            break
        time.sleep(0.05)
    else:
        bad = {s.name: (s.status, s.message)
               for s in ray_tpu_torch.get(controller.status.remote()).values()
               if s.status != "HEALTHY"}
        raise TimeoutError(f"application {name!r} not healthy: {bad}")

    if http:
        proxy = ray_tpu_torch.get_actor(_PROXY_NAME, namespace=SERVE_NAMESPACE)
        ray_tpu_torch.get(proxy.update_routes.remote(
            ray_tpu_torch.get(controller.get_routes.remote())))
    return DeploymentHandle(ingress, app_name=name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    routes = ray_tpu_torch.get(_controller().get_routes.remote())
    for _, dep in routes.items():
        return DeploymentHandle(dep, app_name=name)
    raise ValueError(f"no application {name!r}")


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name=app_name)


def status() -> dict[str, Any]:
    return ray_tpu_torch.get(_controller().status.remote())


def delete(name: str = "default") -> None:
    ray_tpu_torch.get(_controller().delete_application.remote(name))


def http_port() -> int:
    proxy = ray_tpu_torch.get_actor(_PROXY_NAME, namespace=SERVE_NAMESPACE)
    return ray_tpu_torch.get(proxy.port.remote())


def grpc_port() -> int:
    raise NotImplementedError(_NO_GRPC)


def shutdown() -> None:
    try:
        controller = _controller()
    except ValueError:
        return
    try:
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=15)
    except Exception:
        pass
    try:
        proxy = ray_tpu_torch.get_actor(_PROXY_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        proxy = None
    if proxy is not None:
        try:
            ray_tpu_torch.get(proxy.shutdown.remote(), timeout=15)
        except Exception:
            pass
        ray_tpu_torch.kill(proxy)
    try:
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    from ray_tpu_torch.serve.handle import _reset_routers

    _reset_routers()
