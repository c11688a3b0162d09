"""Process-group bring-up for a training rank.

Port of ray_tpu/train/backend.py's ``free_port`` and
``_init_jax_distributed``: every rank calls ``init_distributed`` with the
coordinator's address, the number of processes and its own id; rank 0
hosts the ``TCPStore`` the others meet at.
"""

from __future__ import annotations

import os
import random
import socket
from datetime import timedelta

import torch

# How long a rank waits for the others at the store and at a collective.
TIMEOUT = timedelta(seconds=300)


def _ephemeral_floor() -> int:
    """The lowest port of the kernel's ephemeral range (Linux's default
    32768 where it cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing holds now, drawn at random
    from below the kernel's ephemeral range. A port the kernel hands out
    for port 0 comes from that range, which every connection and every
    gloo listener draws from too, so between this call and the caller's
    bind another process could take it; below the range only another
    caller's random pick can. Falls back to a port-0 pick when none is
    free."""
    floor = _ephemeral_floor()
    rng = random.SystemRandom()
    for _ in range(64):
        port = rng.randrange(max(1024, floor // 2), floor)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_addr: str, num_processes: int,
                     process_id: int, device: str = "cuda") -> torch.device:
    """Join the default process group: NCCL on ``"cuda"`` (this process
    takes ``cuda:LOCAL_RANK``, LOCAL_RANK defaulting to ``process_id``),
    gloo on ``"cpu"``; ``coordinator_addr`` is "host:port" (a
    "tcp://" prefix is accepted). Idempotent per process: a second call
    returns the device and leaves the group as it is. Raises when
    ``"cuda"`` is asked for and there is no card or no NCCL; nothing falls
    back to gloo or to the CPU. Returns the rank's device."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA "
                               "device is available")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed(device='cuda'): this "
                               "torch build has no NCCL")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device} (cuda or cpu)")
    if dist.is_initialized():
        return dev
    addr = coordinator_addr.removeprefix("tcp://")
    host, port = addr.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=TIMEOUT)
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", store=store,
        rank=process_id, world_size=num_processes,
        timeout=TIMEOUT,
        **({"device_id": dev} if kind == "cuda" else {}))
    return dev
