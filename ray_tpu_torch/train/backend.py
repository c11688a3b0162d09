"""Framework backends: per-worker bring-up, and process-group bring-up
for a training rank.

Port of ray_tpu/train/backend.py: ``BackendConfig``/``Backend``, and
``TorchBackendConfig``/``TorchBackend``, the twins of
``JaxBackendConfig``/``JaxBackend``. ``init_distributed`` is the twin of
``_init_jax_distributed``: every rank calls it with the coordinator's
address, the number of processes and its own id; rank 0 hosts the
``TCPStore`` the others meet at. Out: the XLA flags and the multi-slice
environment.
"""

from __future__ import annotations

import os
import random
import socket
from datetime import timedelta

from dataclasses import dataclass

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
        # A cluster worker takes its local rank's share of the cards its
        # lease holds (the first it sees).
        from ray_tpu_torch.accelerators.gpu import leased_cards

        local = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local % (leased_cards()
                                            or torch.cuda.device_count()))
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


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device for ``"cuda"``: card ``rank % n`` of the
    ``n`` cards a cluster worker's lease holds (the first it sees), or of
    every card this process sees elsewhere; raises where there is none."""
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.accelerators.gpu import leased_cards

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % (leased_cards()
                                           or torch.cuda.device_count()))
    return dev


@dataclass
class BackendConfig:
    distributed: bool = False

    def validate(self, scaling) -> None:
        """Refuse a configuration before any worker starts."""

    def make_backend(self) -> "Backend":
        return Backend()


class Backend:
    def on_start(self, worker_group, coordinator_addr: str | None) -> None:
        pass


@dataclass
class TorchBackendConfig(BackendConfig):
    """Each worker's device, and optionally a ``torch.distributed`` world.

    ``device="cuda"`` (the default) runs rank r's train function on card
    ``r % device_count`` (one card a rank where there are enough; every
    rank on card 0 where there is one; on a cluster, the card its
    process's lease holds) and raises where there is no card; ``device="cpu"`` runs on the CPU.
    ``distributed=True`` has every worker join the default process group
    through ``init_distributed`` (NCCL on the card, gloo on the CPU) at
    the controller's coordinator address. On a cluster
    (``init(address=...)``) each worker is a process, one rank each. The
    in-process runtime's workers are threads of one process, which holds
    one rank of one default group, so there ``distributed=True`` takes
    one worker: more raise ``NotImplementedError``. Without it, ranks
    sync gradients through ``ray_tpu_torch.collective``'s host backend.
    """

    device: str = "cuda"

    def validate(self, scaling) -> None:
        from ray_tpu_torch._device import resolve_device

        from ray_tpu_torch.core.worker import global_worker

        most = max(scaling.num_workers, scaling.max_workers or 0)
        if self.distributed and most > 1 and global_worker.mode != "cluster":
            raise NotImplementedError(
                f"TorchBackendConfig(distributed=True) with {most} workers: "
                "the in-process runtime's workers are threads of one "
                "process, which holds one rank of one process group; more "
                "ranks need process workers (connect to a cluster with "
                "init(address=...)). Or use distributed=False and "
                "ray_tpu_torch.collective's host backend, or one worker")
        if global_worker.mode != "cluster":
            # A cluster's driver may see no card; its ranks' processes do.
            resolve_device(self.device)

    def make_backend(self) -> "TorchBackend":
        return TorchBackend(self)


class TorchBackend(Backend):
    def __init__(self, cfg: TorchBackendConfig):
        self.cfg = cfg

    def on_start(self, worker_group, coordinator_addr: str | None) -> None:
        import ray_tpu_torch

        workers = worker_group.workers
        # Each worker picks its card in its own process: on a cluster, the
        # card its lease holds (the first that process sees).
        ray_tpu_torch.get([w.set_device.remote(self.cfg.device, rank)
                           for rank, w in enumerate(workers)], timeout=120)
        if not self.cfg.distributed:
            return
        # Every worker joins against the coordinator's address (reference:
        # v2/jax/config.py:84). A restarted group meets at a new address;
        # a one-rank group a process already holds stays as it is.
        ray_tpu_torch.get([
            w.exec_fn.remote(init_distributed, coordinator_addr,
                             len(workers), rank, self.cfg.device)
            for rank, w in enumerate(workers)
        ], timeout=300)
