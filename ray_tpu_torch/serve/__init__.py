"""ray_tpu_torch.serve: online serving over replica actors (port of
ray_tpu.serve on the port's in-process runtime).

The controller reconciles replicas (rolling updates, health checks,
autoscaling, graceful drains) and pushes them to routers by long-poll;
handles route through a power-of-two router with deadlines, admission
control, retries, hedging, circuit breakers and prefix-aware placement;
replicas batch (``@serve.batch``), multiplex models and stream generator
results; the HTTP proxy serves JSON and SSE. Out: the gRPC proxy (the
machine with the card has no ``grpcio``), gang placement groups, and the
metrics and chaos hooks. Requests are traced (``util/tracing.py``) once
``enable_tracing()`` is on, at the deployment's ``trace_sample_rate``.
Importing it starts no thread.
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    grpc_port,
    http_port,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.grpc_proxy import GrpcRequest
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.http_proxy import Request, Response
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.resilience import (
    CircuitBreakerConfig,
    DeadlineExceeded,
    Overloaded,
    RetryPolicy,
)
from ray_tpu_torch.serve.resilience import current_deadline as request_deadline

__all__ = [
    "deployment", "Deployment", "Application",
    "run", "start", "shutdown", "status", "delete",
    "get_app_handle", "get_deployment_handle", "http_port", "grpc_port",
    "GrpcRequest",
    "DeploymentHandle", "DeploymentResponse",
    "AutoscalingConfig", "DeploymentConfig",
    "batch", "Request", "Response",
    "multiplexed", "get_multiplexed_model_id",
    "Overloaded", "DeadlineExceeded", "RetryPolicy",
    "CircuitBreakerConfig", "request_deadline",
]
