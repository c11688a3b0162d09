"""State API: the in-process profiling, stack, memory, straggler and
goodput verbs (port of ray_tpu/util/state/; the entity listings wait for
the process workers, ROADMAP Queue A item (iv))."""

from ray_tpu_torch.util.state.api import (
    device_memory,
    get_goodput,
    get_stack,
    profile_cluster,
    stack_cluster,
    stragglers,
)

__all__ = [
    "device_memory",
    "get_goodput",
    "get_stack",
    "profile_cluster",
    "stack_cluster",
    "stragglers",
]
