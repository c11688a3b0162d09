"""Host (CPU) collective backend: rendezvous + reduction through a named
async actor.

Port of ray_tpu/collective/host_backend.py: each rank calls the op with its
local array; a per-group coordination actor (async, so ranks interleave)
gathers world_size contributions, combines them in rank order, and releases
all waiters. Numpy arrays combine exactly as in ray_tpu. A torch tensor
(on any device, in any dtype) goes to the host as a CPU tensor, combines
there by the same rank-order arithmetic in its own dtype (a bfloat16 sum
rounds after every add, as ml_dtypes' does), and comes back on the
caller's device and in its dtype. Correctness over speed: an NCCL backend
is ROADMAP Queue A item 7.
"""

from __future__ import annotations

import asyncio
import functools
import sys

import numpy as np

# How long a rank waits for the others at one op (seconds).
OP_TIMEOUT_S = 120


def _torch_of(x):
    """The torch module when ``x`` is a tensor, else None (no import)."""
    torch = sys.modules.get("torch")
    return torch if torch is not None and isinstance(x, torch.Tensor) else None


def _split(x, n: int):
    torch = _torch_of(x)
    return torch.tensor_split(x, n, dim=0) if torch else np.array_split(x, n, axis=0)


def _concat(parts):
    torch = _torch_of(parts[0])
    return torch.cat(parts, dim=0) if torch else np.concatenate(parts, axis=0)


def _copy(x):
    return x.clone() if _torch_of(x) else x.copy()


class _GroupCoordinator:
    """Async actor: one instance per collective group (named actor)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._rounds: dict[str, dict] = {}
        self._lock = asyncio.Lock()

    def _round(self, key: str) -> dict:
        r = self._rounds.get(key)
        if r is None:
            r = {"parts": {}, "event": asyncio.Event(), "result": None}
            self._rounds[key] = r
        return r

    async def contribute(self, key: str, rank: int, data, op: str):
        async with self._lock:
            r = self._round(key)
            r["parts"][rank] = data
            if len(r["parts"]) == self.world_size:
                r["result"] = self._combine(r["parts"], op)
                r["event"].set()
        await r["event"].wait()
        result = r["result"]
        async with self._lock:
            r["waiters"] = r.get("waiters", 0) + 1
            if r["waiters"] == self.world_size:
                self._rounds.pop(key, None)  # round complete: free memory
        return result if not isinstance(result, dict) else result.get(rank)

    def _combine(self, parts: dict[int, object], op: str):
        ordered = [parts[r] if _torch_of(parts[r]) else np.asarray(parts[r])
                   for r in sorted(parts)]
        torch = _torch_of(ordered[0])
        if op == "sum":
            return sum(ordered[1:], _copy(ordered[0]))
        if op == "max":
            return functools.reduce(torch.maximum, ordered) if torch \
                else np.maximum.reduce(ordered)
        if op == "min":
            return functools.reduce(torch.minimum, ordered) if torch \
                else np.minimum.reduce(ordered)
        if op == "gather":
            return _concat(ordered)
        if op == "alltoall":
            # rank r receives chunk r of every rank's array, concatenated
            n = self.world_size
            return {r: _concat([_split(p, n)[r] for p in ordered])
                    for r in range(n)}
        if op == "barrier":
            return 0
        if op.startswith("broadcast"):
            src = int(op.split(":")[1])
            return parts[src] if _torch_of(parts[src]) else np.asarray(parts[src])
        if op.startswith("reducescatter"):
            red = sum(ordered[1:], _copy(ordered[0]))
            return {r: _split(red, self.world_size)[r]
                    for r in range(self.world_size)}
        raise ValueError(f"unknown op {op}")

    async def p2p_put(self, key: str, data):
        async with self._lock:
            r = self._round(key)
            r["result"] = data
            r["event"].set()
        return True

    async def p2p_take(self, key: str):
        r = self._round(key)
        await r["event"].wait()
        async with self._lock:
            self._rounds.pop(key, None)
        return r["result"]


def _to_host(x):
    """What a rank sends: a numpy array, or a tensor as a CPU tensor."""
    return x.detach().cpu() if _torch_of(x) else np.asarray(x)


def _from_host(out, like):
    """The result back on ``like``'s device and in its dtype (tensors)."""
    if _torch_of(like) and _torch_of(out):
        return out.to(device=like.device, dtype=like.dtype)
    return out


class HostCollectiveGroup:
    def __init__(self, world_size: int, rank: int, group_name: str):
        import ray_tpu_torch

        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._seq = 0
        self._p2p_seq: dict[tuple[int, int], int] = {}
        actor_name = f"_rtpu_collective:{group_name}"
        try:
            self._coord = ray_tpu_torch.get_actor(actor_name)
        except ValueError:
            Coordinator = ray_tpu_torch.remote(_GroupCoordinator)
            try:
                self._coord = Coordinator.options(
                    name=actor_name, num_cpus=0
                ).remote(world_size)
            except ValueError:
                self._coord = ray_tpu_torch.get_actor(actor_name)  # lost the race

    def _key(self, op: str) -> str:
        self._seq += 1
        return f"{op}:{self._seq}"

    def _run(self, op_tag: str, x, op: str):
        import ray_tpu_torch

        out = ray_tpu_torch.get(
            self._coord.contribute.remote(self._key(op_tag), self.rank,
                                          _to_host(x), op),
            timeout=OP_TIMEOUT_S,
        )
        return _from_host(out, x)

    def allreduce(self, x, op: str = "sum"):
        return self._run("ar", x, op)

    def allgather(self, x):
        return self._run("ag", x, "gather")

    def reducescatter(self, x, op: str = "sum"):
        return self._run("rs", x, f"reducescatter:{op}")

    def alltoall(self, x):
        return self._run("a2a", x, "alltoall")

    def broadcast(self, x, src_rank: int = 0):
        return self._run("bc", x, f"broadcast:{src_rank}")

    def reduce(self, x, dst_rank: int = 0, op: str = "sum"):
        return self._run("rd", x, op)

    def barrier(self):
        self._run("bar", 0, "barrier")

    def send(self, x, dst_rank: int):
        import ray_tpu_torch

        pair = (self.rank, dst_rank)
        self._p2p_seq[pair] = self._p2p_seq.get(pair, 0) + 1
        key = f"p2p:{pair[0]}->{pair[1]}:{self._p2p_seq[pair]}"
        ray_tpu_torch.get(self._coord.p2p_put.remote(key, _to_host(x)),
                          timeout=OP_TIMEOUT_S)

    def recv(self, shape, dtype, src_rank: int):
        """The value ``src_rank`` sent, on the host (a tensor as a CPU
        tensor)."""
        import ray_tpu_torch

        pair = (src_rank, self.rank)
        self._p2p_seq[pair] = self._p2p_seq.get(pair, 0) + 1
        key = f"p2p:{pair[0]}->{pair[1]}:{self._p2p_seq[pair]}"
        return ray_tpu_torch.get(self._coord.p2p_take.remote(key),
                                 timeout=OP_TIMEOUT_S)

    def destroy(self):
        pass
