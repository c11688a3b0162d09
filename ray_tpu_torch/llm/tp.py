"""Tensor-parallel serving: an engine's tp ranks as processes.

Port of ``LLMEngine._shard_for_tp`` (ray_tpu/llm/engine.py:1950). JAX's
engine is one process that jits over a ``tp`` mesh axis. Here the
caller's process is rank 0: it keeps the scheduler, the queues and the
public API, and starts ``tp - 1`` follower processes, rank r on
``cuda:r`` (on the CPU when the engine runs there). Every device call of
the scheduler goes to the followers first as a small header (the call's
name and its host arguments: tokens, positions, slots, block tables,
temperatures, top-p); then every rank runs the same function on its own
blocks, and the ranks meet in collectives.

- The split is Megatron's, what ``ShardingRules()``'s defaults ask of
  JAX on ``MeshSpec(tp=n)``: q heads, kv heads, the MLP's inner dim and
  the vocabulary over tp. ``wo`` and ``w_down`` are row-parallel (one
  all-reduce each a layer), the embedding vocabulary-parallel (one
  all-reduce), the f32 head this rank's vocabulary columns (one
  all-gather of the logits). Where tp does not divide the kv heads, a
  rank holds the kv heads its q heads read (``rank_layout``): those heads
  are replicated.
- The group is the engine's own, built from its own ``TCPStore``: the
  default process group is never created or used, so engines live side
  by side in one process and inside a trainer's worker. NCCL on the
  card, gloo on the CPU.
- Weights: rank 0 initialises, loads or converts the whole tree and
  scatters each leaf's blocks (``rank_blocks``), one leaf at a time.

Failure: a follower that exits (killed, or raising in a call, which it
reports and then exits) breaks the group; rank 0's monitor aborts an
NCCL communicator so that no call of rank 0 waits forever, and the
engine fails its requests. A follower exits when rank 0 does: its
control socket's end of file, or its parent gone. ``TPGroup.close``
leaves no live follower.

Followers run ``python -m ray_tpu_torch.llm.tp`` (a fresh interpreter:
the caller's ``__main__`` is never imported again there), started by
``TPGroup`` only.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import traceback
import weakref
from dataclasses import dataclass, replace
from multiprocessing.connection import Connection

import torch

from ray_tpu_torch.models.llama import LlamaConfig, param_logical_axes
from ray_tpu_torch.parallel.mesh import tp_mesh
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    at_path,
    shard_params,
    tree_paths,
)

START_TIMEOUT_S = 180.0  # a follower imports torch and reaches its card
GROUP_TIMEOUT_S = 600.0  # a collective that waits longer raises
STOP_TIMEOUT_S = 10.0    # close(): a follower's exit, then it is killed
_HOST = "127.0.0.1"


# ---------------------------------------------------------------------------
# The split.


@dataclass(frozen=True)
class RankLayout:
    """What rank ``rank`` of ``size`` holds: q heads [lo, hi), the kv heads
    [lo, hi) they read, vocabulary rows [lo, hi)."""
    rank: int
    size: int
    heads: tuple[int, int]
    kv_heads: tuple[int, int]
    vocab: tuple[int, int]


def rank_layout(cfg: LlamaConfig, tp: int, rank: int) -> RankLayout:
    """Rank ``rank``'s share of ``cfg`` at tensor parallelism ``tp``. A rank
    holds whole q heads, so tp must divide ``num_heads``; its kv heads are
    the ones its q heads read, a split of the kv heads where tp divides
    them and one head replicated over ``tp / num_kv_heads`` ranks where it
    does not (ValueError where neither holds)."""
    if tp < 1 or not 0 <= rank < tp:
        raise ValueError(f"rank {rank} of tensor_parallel_size={tp}")
    if cfg.num_heads % tp:
        raise ValueError(
            f"tensor_parallel_size={tp} does not divide num_heads="
            f"{cfg.num_heads}: a rank holds whole query heads")
    if cfg.vocab_size % tp:
        raise ValueError(
            f"tensor_parallel_size={tp} does not divide vocab_size="
            f"{cfg.vocab_size} (JAX's device_put refuses it too)")
    hq = cfg.num_heads // tp
    rep = cfg.num_heads // cfg.num_kv_heads
    if hq % rep and rep % hq:
        raise ValueError(
            f"tensor_parallel_size={tp}: a rank's {hq} query heads neither "
            f"cover whole kv-head groups of {rep} nor fit inside one")
    lo, hi = rank * hq, (rank + 1) * hq
    v = cfg.vocab_size // tp
    return RankLayout(rank, tp, (lo, hi), (lo // rep, (hi - 1) // rep + 1),
                      (rank * v, (rank + 1) * v))


def local_config(cfg: LlamaConfig, layout: RankLayout) -> LlamaConfig:
    """The geometry a rank's device functions see: its heads, kv heads,
    MLP columns and vocabulary rows."""
    return replace(cfg, num_heads=layout.heads[1] - layout.heads[0],
                   num_kv_heads=layout.kv_heads[1] - layout.kv_heads[0],
                   intermediate_size=cfg.intermediate_size // layout.size,
                   vocab_size=layout.vocab[1] - layout.vocab[0])


def _leaf_block(cfg: LlamaConfig, path: tuple, t: torch.Tensor, tp: int,
                rank: int) -> torch.Tensor:
    if path[-1] in ("wk", "wv"):
        lo, hi = rank_layout(cfg, tp, rank).kv_heads
        d = cfg.head_dim
        return t[..., lo * d:hi * d].contiguous()
    logical = at_path(param_logical_axes(cfg), path)
    one, axes = {}, {}
    node, anode = one, axes
    for k in path[:-1]:
        node = node.setdefault(k, {})
        anode = anode.setdefault(k, {})
    node[path[-1]], anode[path[-1]] = t, logical
    return at_path(shard_params(one, tp_mesh(tp, rank), axes,
                                ShardingRules()), path)


def rank_blocks(cfg: LlamaConfig, params: dict, tp: int):
    """(path, [rank 0's block, ..., rank tp-1's]) for every leaf, in tree
    order: what rank 0 scatters, one leaf at a time. A block is JAX's
    ``shard_params`` under ``ShardingRules()`` on ``MeshSpec(dp=1, fsdp=1,
    tp=tp)`` (a dim tp does not divide raises ValueError, as JAX's
    ``device_put`` does); the kv projections are cut by ``rank_layout``'s
    kv heads."""
    for path, t in tree_paths(params):
        yield path, [_leaf_block(cfg, path, t, tp, r) for r in range(tp)]


# ---------------------------------------------------------------------------
# The engine's own process group.


def _backend(store, rank: int, size: int, device: torch.device):
    """A gloo (CPU) or NCCL (card) backend object on ``store``: collectives
    are called on it directly, no default group behind it."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if device.type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, timeout)


def _store(port: int, world: int, master: bool):
    import torch.distributed as dist

    store = dist.TCPStore(_HOST, port, world, master,
                          timeout=datetime.timedelta(seconds=START_TIMEOUT_S),
                          wait_for_workers=False)
    return store, dist.PrefixStore("ray_tpu_torch.llm.tp", store)


class Comm:
    """The collectives of the split over one engine's group. ``collectives``
    counts the calls issued (every rank issues the same ones, in one
    order), ``collective_s`` the host time spent issuing them."""

    def __init__(self, pg, rank: int, size: int, device: torch.device):
        self.pg, self.rank, self.size, self.device = pg, rank, size, device
        self.collectives, self.collective_s = 0, 0.0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        t0 = time.perf_counter()
        self.pg.allreduce([t]).wait()
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t``, in rank order."""
        t0 = time.perf_counter()
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        self.pg._allgather_base(out, t).wait()
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return out.view(self.size, *t.shape)

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` joined along the last dim, in rank order."""
        out = self.all_gather(t)
        return out.movedim(0, -2).reshape(*t.shape[:-1], -1)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self.pg.broadcast([t], opts).wait()
        return t

    def scatter(self, out: torch.Tensor, blocks=None) -> torch.Tensor:
        """Rank r receives ``blocks[r]`` of rank 0 into ``out``."""
        import torch.distributed as dist

        opts = dist.ScatterOptions()
        opts.rootRank = 0
        self.pg.scatter([out], [list(blocks)] if blocks is not None else [],
                        opts).wait()
        return out

    def abort(self) -> None:
        """Make every pending and later collective of this group fail."""
        try:
            self.pg.abort()
        except Exception:  # noqa: BLE001 - already torn down
            pass

    def shutdown(self) -> None:
        """Free the group (its NCCL communicator's memory)."""
        try:
            self.pg.shutdown()
        except Exception:  # noqa: BLE001 - no such call, or aborted
            pass


def _ready(conn: Connection, proc: subprocess.Popen, rank: int,
           deadline: float, what: str):
    """The next message of a follower, waiting while it lives (RuntimeError
    when it exits or the deadline passes first)."""
    while not conn.poll(0.05):
        if proc.poll() is not None:
            raise RuntimeError(
                f"tensor-parallel rank {rank} exited with code "
                f"{proc.returncode} before {what}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"tensor-parallel rank {rank} did not report "
                               f"{what} within {START_TIMEOUT_S} s")
    kind, body = conn.recv()
    if kind == "error":
        raise RuntimeError(f"tensor-parallel rank {rank} failed before "
                           f"{what}:\n{body}")
    return body


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


class TPGroup:
    """Rank 0's side of a tensor-parallel engine: the followers, the
    control channel and the group.

    ``TPGroup(world, device)`` starts ranks 1..world-1 and forms the
    group; ``send`` hands every follower one call, ``replies`` reads one
    answer from each; ``broken`` holds why the group failed (None while it
    is whole); ``close`` ends it. ``headers``/``header_s`` count the calls
    sent and the host time spent sending them."""

    def __init__(self, world: int, device: torch.device, on_broken=None):
        self.world, self.device = world, device
        self.broken: str | None = None
        self.headers, self.header_s = 0, 0.0
        self._on_broken = on_broken
        self._closing = False
        self.procs: list[subprocess.Popen] = []
        self.conns: list[Connection] = []
        store, prefixed = _store(0, world, True)
        self._store = store  # the rendezvous NCCL's communicator uses too
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        try:
            for r in range(1, world):
                mine, theirs = socket.socketpair()
                dev = f"cuda:{r}" if device.type == "cuda" else "cpu"
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.llm.tp", str(r),
                     str(world), str(store.port), str(theirs.fileno()), dev,
                     str(os.getpid())],
                    pass_fds=(theirs.fileno(),), env=env))
                theirs.close()
                self.conns.append(Connection(mine.detach()))
            deadline = time.monotonic() + START_TIMEOUT_S
            for r, (c, p) in enumerate(zip(self.conns, self.procs), 1):
                _ready(c, p, r, deadline, "joining the store")
            self.comm = Comm(_backend(prefixed, 0, world, device), 0, world,
                             device)
        except BaseException:
            _kill(self.procs)
            raise
        self._finalizer = weakref.finalize(self, _kill, list(self.procs))
        for r, p in enumerate(self.procs, 1):
            threading.Thread(target=self._watch, args=(r, p), daemon=True,
                             name=f"tp-watch-{r}").start()

    def wait_ready(self) -> None:
        """Every follower's report that it holds its weights and cache."""
        deadline = time.monotonic() + START_TIMEOUT_S
        for r, (c, p) in enumerate(zip(self.conns, self.procs), 1):
            _ready(c, p, r, deadline, "its weights and cache")

    def _watch(self, rank: int, proc: subprocess.Popen) -> None:
        code = proc.wait()
        if self._closing:
            return
        self.broken = (f"tensor-parallel rank {rank} exited with code {code}"
                       + self._follower_error(rank))
        if self.device.type == "cuda":
            self.comm.abort()
        if self._on_broken is not None:
            self._on_broken(self.broken)

    def _follower_error(self, rank: int) -> str:
        conn = self.conns[rank - 1]
        try:
            if conn.poll(0):
                kind, body = conn.recv()
                if kind == "error":
                    return f":\n{body}"
        except (EOFError, OSError):
            pass
        return ""

    def send(self, name: str, args: tuple) -> None:
        """Hand every follower the call ``name(*args)``."""
        if self.broken:
            raise RuntimeError(self.broken)
        t0 = time.perf_counter()
        data = pickle.dumps((name, args), protocol=pickle.HIGHEST_PROTOCOL)
        try:
            for c in self.conns:
                c.send_bytes(data)
        except OSError as e:
            raise RuntimeError(self.broken or
                               f"tensor-parallel control channel: {e!r}")
        self.header_s += time.perf_counter() - t0
        self.headers += 1

    def replies(self) -> list:
        """One answer from each follower, in rank order."""
        out = []
        for r, c in enumerate(self.conns, 1):
            try:
                kind, body = c.recv()
            except (EOFError, OSError):
                raise RuntimeError(self.broken or
                                   f"tensor-parallel rank {r} is gone")
            if kind == "error":
                raise RuntimeError(f"tensor-parallel rank {r}:\n{body}")
            out.append(body)
        return out

    def close(self) -> None:
        """Stop every follower (killed after ``STOP_TIMEOUT_S``) and free
        the group."""
        if self._closing:
            return
        self._closing = True
        for c in self.conns:
            try:
                c.send_bytes(pickle.dumps(("stop", ())))
            except OSError:
                pass
        deadline = time.monotonic() + STOP_TIMEOUT_S
        for p in self.procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        _kill(self.procs)
        for c in self.conns:
            c.close()
        if self.device.type == "cuda":  # local: no peer is left to meet
            self.comm.abort()
        else:
            self.comm.shutdown()
        self._finalizer.detach()

    def alive(self) -> list[bool]:
        return [p.poll() is None for p in self.procs]


# ---------------------------------------------------------------------------
# A follower.


def _watch_parent(ppid: int) -> None:
    """End this follower when rank 0's process is gone (killed rank 0
    closes no socket a blocked collective would notice)."""
    while True:
        if os.getppid() != ppid:
            os._exit(3)
        time.sleep(0.2)


def _follower_main(argv: list[str]) -> None:
    rank, world, port, fd = (int(a) for a in argv[:4])
    device, ppid = torch.device(argv[4]), int(argv[5])
    threading.Thread(target=_watch_parent, args=(ppid,), daemon=True).start()
    conn = Connection(fd)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # CPU ranks share the host's cores with rank 0
            torch.set_num_threads(1)
        _, prefixed = _store(port, world, False)
        conn.send(("ok", None))
        comm = Comm(_backend(prefixed, rank, world, device), rank, world,
                    device)
        name, args = conn.recv()
        if name != "init":
            raise RuntimeError(f"expected the init call, got {name!r}")
        from ray_tpu_torch.llm.engine import TPFollower

        with torch.no_grad():
            state = TPFollower(comm, **args[0])
            conn.send(("ok", None))
            while True:
                try:
                    name, args = conn.recv()
                except (EOFError, OSError):
                    break
                if name == "stop":
                    break
                out = getattr(state, "_c_" + name)(*args)
                if name == "query":
                    conn.send(("ok", out))
    except BaseException:  # noqa: BLE001 - reported to rank 0, then exit
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        sys.stderr.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)


if __name__ == "__main__":
    _follower_main(sys.argv[1:])
