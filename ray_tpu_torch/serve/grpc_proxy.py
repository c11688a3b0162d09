"""gRPC ingress: only the request type is ported.

Port of the ``GrpcRequest`` dataclass of ray_tpu/serve/grpc_proxy.py, so a
deployment written for both ingresses keeps its signature. The gRPC proxy
itself is not ported: the machine with the card has no ``grpcio``, and
``serve.start(grpc_options=...)``, ``serve.run(grpc=True)`` and
``serve.grpc_port()`` raise ``NotImplementedError`` (serve/api.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class GrpcRequest:
    """What an ingress deployment's __call__ receives for a gRPC request."""

    method: str                                  # "/pkg.Service/Method"
    data: bytes = b""
    metadata: dict[str, str] = field(default_factory=dict)

    def json(self):
        return json.loads(self.data) if self.data else None
