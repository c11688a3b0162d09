"""ray_tpu_torch.collective: the collective API over the host backend
(``collective``, ``host_backend``; port of ray_tpu.collective without its
XLA backend) and the int8 wire format of the quantized cross-slice
gradient stage (``quant``)."""

from ray_tpu_torch.collective.collective import (
    allgather,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    destroy_collective_group,
    get_group,
    init_collective_group,
    recv,
    reduce,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.host_backend import HostCollectiveGroup

__all__ = [
    "init_collective_group", "destroy_collective_group", "get_group",
    "allreduce", "allgather", "reducescatter", "alltoall", "broadcast",
    "reduce", "barrier", "send", "recv", "HostCollectiveGroup",
]
