"""Checkpointing: trees of tensors through ``torch.distributed.checkpoint``
(DCP), plus write-behind saving and a top-K retention manager.

Port of ray_tpu/train/checkpoint.py (``Checkpoint``, ``save_pytree``,
``restore_pytree``, ``AsyncCheckpointWriter``, ``CheckpointManager``), with
DCP in place of orbax:

- a tree is a nest of dicts, tuples, lists and NamedTuples whose leaves
  are tensors, :class:`FlatShard` or :class:`BlockShard` pieces or
  picklable objects; it is saved under flat keys (the path joined by
  "."). Tensors are replicated (DCP writes one copy); a ``FlatShard`` is
  one rank's contiguous piece of a flat tensor, a ``BlockShard`` one
  rank's block of a tensor (a param split over fsdp and tp, say), and
  every rank writes its own pieces (a ShardedTensor whose shards are the
  ranks' pieces);
- ``restore_pytree(directory, template)`` loads into the template's
  tensors in place; the template's pieces may cut the tensors at other
  offsets than the saved ones (another world size or mesh), since DCP
  reads whatever saved chunks overlap each piece, and a whole tensor
  saved in another shape of the same size (a moment saved leaf-shaped,
  restored as a flat view) loads through a view. Without a template it
  returns nested dicts of whole CPU tensors. A piece whose tensor was
  saved in another shape of the same size (a moment saved as a flat
  ``FlatShard`` view, restored as a leaf-shaped ``BlockShard``, or the
  other way) is read whole by every rank and cut: the whole tensor of
  each such key is alive during the load.

``TrainState.checkpoint_tree()`` (train/spmd.py) gives a step's state in
this form: a ZeRO-1 state saved at 4 ranks restores at 2 or 1, an FSDP/TP
state saved at fsdp2 x tp2 restores at dp=2 or with no mesh, with or
without ZeRO-1 on either side.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from dataclasses import dataclass, replace
from typing import Any

import torch

KEY_SEP = "."


@dataclass
class FlatShard:
    """This rank's piece ``local[:length]`` of a flat tensor of ``numel``
    elements, at ``offset``. ``local`` may run past ``length`` (padding,
    not saved). ``replicas``: a process group whose ranks hold the same
    piece, where only the ``owner`` writes it and a restore broadcasts it
    from the group's rank 0 to the others."""
    local: torch.Tensor
    numel: int
    offset: int
    length: int
    replicas: Any = None
    owner: bool = True


@dataclass
class BlockShard:
    """This rank's block ``local`` of a tensor of ``shape``, at
    ``offsets`` (one a dim). ``replicas``/``owner`` as FlatShard's.
    ``after_load(local)``, when given, is called once a restore has
    filled ``local``. With ``gather``, no rank holds the block: ``local``
    is a meta tensor of its shape and dtype, a save calls ``gather()``
    for it (a collective: every rank calls it, in the tree's order) and
    only the ``owner`` keeps what it returns for the write, and a restore
    reads the block into a new tensor on ``device`` and hands it to
    ``after_load``, which cuts this rank's own piece from it."""
    local: torch.Tensor
    shape: tuple
    offsets: tuple
    replicas: Any = None
    owner: bool = True
    after_load: Any = None
    gather: Any = None
    device: Any = None

    @property
    def whole(self) -> bool:
        return self.gather is None and \
            tuple(self.local.shape) == tuple(self.shape)


def _gathered(piece, load: bool):
    """``piece`` with its block in ``local`` where it is a ``gather``ed
    BlockShard: for a save the gathered block on its owner (an empty
    tensor elsewhere, so each rank holds only the blocks it writes), for
    a restore a new tensor to read it into."""
    if not isinstance(piece, BlockShard) or piece.gather is None:
        return piece
    if load:
        local = torch.empty(piece.local.shape, dtype=piece.local.dtype,
                            device=piece.device)
    else:
        local = piece.gather()
        if not piece.owner:
            local = local[:0]
    return replace(piece, local=local, gather=None)


_PIECES = (FlatShard, BlockShard)


def _is_whole(piece) -> bool:
    if isinstance(piece, BlockShard):
        return piece.whole
    return piece.offset == 0 and piece.length == piece.numel


@dataclass
class Checkpoint:
    path: str

    def metadata(self) -> dict:
        meta_path = os.path.join(self.path, "rtpu_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
        return {}


def tree_items(tree, path=()):
    """(key, leaf) pairs of a tree, in a fixed order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from tree_items(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (str(i),))
    else:
        yield KEY_SEP.join(path), tree


def tree_rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in ``tree_items``'s order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(tree)


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _sharded(piece, coordinated: bool):
    """A FlatShard or BlockShard as DCP takes it: whole (one process) or,
    when the ranks save together, a ShardedTensor over the world whose
    shards are the ranks' pieces. Collective then: every rank calls it for
    the same keys, in one order."""
    block = isinstance(piece, BlockShard)
    if not coordinated:
        if not _is_whole(piece):
            raise ValueError(f"a {type(piece).__name__} that is not the "
                             f"whole tensor needs the ranks to save "
                             f"together (save_pytree under a process "
                             f"group)")
        return piece.local if block else piece.local[:piece.length]
    import torch.distributed as dist
    from torch.distributed._shard.sharded_tensor import (
        Shard,
        ShardMetadata,
        init_from_local_shards,
    )

    if block:
        t, offsets, size = piece.local, list(piece.offsets), piece.shape
        keep = t.numel() > 0 and piece.owner
    else:
        t, offsets = piece.local[:piece.length], [piece.offset]
        size, keep = (piece.numel,), piece.length > 0 and piece.owner
    shards = []
    if keep:
        shards.append(Shard(t, ShardMetadata(
            shard_offsets=offsets, shard_sizes=list(t.shape),
            placement=f"rank:{dist.get_rank()}/{t.device}")))
    return init_from_local_shards(shards, *size)


def _state_dict(flat, coordinated: bool):
    return {k: (_sharded(v, coordinated) if isinstance(v, _PIECES) else v)
            for k, v in flat}


def _save_dict(tree, coordinated: bool):
    """The state dict DCP saves: each gathered block made one leaf at a
    time, kept by its owner only."""
    return _state_dict(((k, _gathered(v, load=False))
                        for k, v in tree_items(tree)), coordinated)


def _write(tree: Any, directory: str, step: int | None,
           coordinated: bool) -> str:
    """Write ``tree`` under ``directory``: every rank together
    (``coordinated``: barriers and DCP's plan exchange on the default
    group), or this process alone, with no collective."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(directory)
    target = os.path.join(directory, "state")
    lead = not coordinated or dist.get_rank() == 0
    if lead:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(target):
            shutil.rmtree(target)
    if coordinated:
        dist.barrier()
    dcp.save(_save_dict(tree, coordinated), checkpoint_id=target,
             no_dist=not coordinated)
    if lead:  # last: a directory without it is a partial write
        with open(os.path.join(directory, "rtpu_meta.json"), "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
    if coordinated:
        dist.barrier()
    return directory


def save_pytree(tree: Any, directory: str, step: int | None = None) -> str:
    """Write a tree checkpoint under ``directory``; with a process group,
    every rank calls it and writes its own pieces."""
    return _write(tree, directory, step, _distributed())


def restore_pytree(directory: str, template: Any = None) -> Any:
    """Restore a tree. With ``template`` (the same structure; tensors and
    FlatShard pieces on their devices), its tensors are filled in place and
    the template comes back with any non-tensor leaves replaced; without,
    nested dicts of whole CPU tensors."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    target = os.path.join(os.path.abspath(directory), "state")
    if template is None:
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata,
        )

        meta = dcp.FileSystemReader(target).read_metadata()
        sd = {k: (torch.empty(m.size, dtype=m.properties.dtype)
                  if isinstance(m, TensorStorageMetadata) else None)
              for k, m in meta.state_dict_metadata.items()}
        dcp.load(sd, checkpoint_id=target)
        out: dict = {}
        for k, v in sd.items():
            node = out
            *head, last = k.split(KEY_SEP)
            for part in head:
                node = node.setdefault(part, {})
            node[last] = v
        return out
    flat = [(k, _gathered(v, load=True)) for k, v in tree_items(template)]
    saved = dcp.FileSystemReader(target).read_metadata().state_dict_metadata
    # Pieces of a tensor saved in another shape of the same size: read
    # whole, cut below (the same keys on every rank, so the collective
    # ShardedTensor builds stay in one order).
    reshaped = {}
    for k, v in flat:
        size = getattr(saved.get(k), "size", None)
        if isinstance(v, _PIECES) and size is not None:
            shape = tuple(v.shape) if isinstance(v, BlockShard) \
                else (v.numel,)
            if tuple(size) != shape and size.numel() == math.prod(shape):
                reshaped[k] = torch.empty(tuple(size), dtype=v.local.dtype,
                                          device=v.local.device)
    sd = _state_dict([(k, v) for k, v in flat if k not in reshaped],
                     _distributed())
    sd.update(reshaped)
    for k, v in flat:  # a whole tensor saved in another shape
        m = saved.get(k)
        if type(v) is torch.Tensor and getattr(m, "size", None) is not None \
                and tuple(m.size) != tuple(v.shape) and \
                m.size.numel() == v.numel():
            sd[k] = v.view(tuple(m.size))
    dcp.load(sd, checkpoint_id=target)
    leaves = []
    for k, v in flat:
        if k in reshaped:
            _cut(v, reshaped.pop(k))
        elif isinstance(v, _PIECES) and v.replicas is not None:
            dist.broadcast(v.local, src=dist.get_global_rank(
                v.replicas, 0), group=v.replicas)
        if isinstance(v, _PIECES):
            if getattr(v, "after_load", None) is not None:
                v.after_load(v.local)
            leaves.append(v.local)
        elif isinstance(v, torch.Tensor):
            leaves.append(v)
        else:
            leaves.append(sd[k])
    return tree_rebuild(template, leaves)


def _cut(piece, whole: torch.Tensor) -> None:
    """Fill ``piece`` from the whole tensor it is a piece of (read in
    another shape of the same size)."""
    if isinstance(piece, BlockShard):
        whole = whole.reshape(piece.shape)
        piece.local.copy_(whole[tuple(
            slice(o, o + n) for o, n in zip(piece.offsets,
                                            piece.local.shape))])
    else:
        piece.local[:piece.length].copy_(
            whole.reshape(-1)[piece.offset:piece.offset + piece.length])


def _host_snapshot(tree):
    def one(x):
        if isinstance(x, _PIECES):
            x = _gathered(x, load=False)
            return replace(x, local=x.local.detach().cpu().clone())
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        return x

    return tree_rebuild(tree, [one(v) for _, v in tree_items(tree)])


class AsyncCheckpointWriter:
    """Write-behind checkpointing: ``save()`` snapshots the tree to host
    memory inline (the step may overwrite its tensors right after) and runs
    the write on a background thread. The next ``save()`` (or ``wait()``)
    barriers on the previous write, re-raising its error, so writes stay
    ordered and at most one checkpoint is in flight. ``completed()`` gives
    the directories whose writes finished: report those, not the one just
    queued. The write runs no collective (one from this thread would race
    the training thread's on the same communicator), so it writes one
    process's tree: under a process group of more than one rank, a tree
    whose every leaf is whole on every rank (a flat data-parallel state:
    its layout holds no pieces) is written by rank 0 alone, and the other
    ranks return the directory without writing (only rank 0 lists it in
    ``completed()``); a tree that holds pieces (ZeRO-1 or hierarchical
    moments, params split over fsdp or tp) raises, and keeps the
    synchronous ``save_pytree`` on every rank."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        self._done: list[str] = []
        self._lock = threading.Lock()

    def save(self, tree: Any, directory: str, step: int | None = None) -> str:
        import torch.distributed as dist

        if _distributed() and dist.get_world_size() > 1:
            pieces = [k for k, v in tree_items(tree)
                      if isinstance(v, _PIECES) and not _is_whole(v)]
            if pieces:
                raise RuntimeError(
                    f"AsyncCheckpointWriter writes one process's tree, and "
                    f"this state holds this rank's pieces of "
                    f"{len(pieces)} tensors (e.g. {pieces[0]}) of a group "
                    f"of {dist.get_world_size()} ranks: save it with "
                    f"save_pytree on every rank")
            if dist.get_rank() != 0:
                return directory  # rank 0 writes the replicated state
        t0 = time.perf_counter()
        self.wait()  # barrier on (and surface errors from) the last write
        host_tree = _host_snapshot(tree)
        # Goodput: the barrier + host snapshot above is the SYNC portion
        # the train step pays for checkpointing (the write runs behind);
        # stamp it on the calling thread's ledger, if any.
        try:
            from ray_tpu_torch.observability import goodput as _goodput

            _goodput.add_active_pending(
                "checkpoint", time.perf_counter() - t0)
        except Exception:
            pass

        def work():
            try:
                _write(host_tree, directory, step, coordinated=False)
                with self._lock:
                    self._done.append(directory)
            except BaseException as e:  # noqa: BLE001 - re-raised at wait
                with self._lock:
                    self._exc = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="ckpt-write-behind")
        self._thread.start()
        return directory

    def wait(self, timeout: float | None = None) -> None:
        """Barrier on the in-flight write; re-raises its error, if any."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if not t.is_alive():
                self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def completed(self) -> list[str]:
        """Directories whose writes finished since the last call, in write
        order."""
        with self._lock:
            out, self._done = self._done, []
        return out


class CheckpointManager:
    """Tracks reported checkpoints, retains the last K, exposes the latest
    and the best by a metric."""

    def __init__(self, storage_path: str, num_to_keep: int | None = None):
        self.storage_path = os.path.abspath(storage_path)
        os.makedirs(self.storage_path, exist_ok=True)
        self.num_to_keep = num_to_keep
        self._checkpoints: list[tuple[float, Checkpoint, dict]] = []

    def register(self, checkpoint_dir: str,
                 metrics: dict | None = None) -> Checkpoint:
        ckpt = Checkpoint(checkpoint_dir)
        self._checkpoints.append((time.time(), ckpt, metrics or {}))
        self._enforce_retention()
        return ckpt

    def latest(self) -> Checkpoint | None:
        return self._checkpoints[-1][1] if self._checkpoints else None

    def best(self, metric: str, mode: str = "min") -> Checkpoint | None:
        scored = [(m.get(metric), c) for _, c, m in self._checkpoints
                  if m.get(metric) is not None]
        if not scored:
            return self.latest()
        scored.sort(key=lambda t: t[0], reverse=(mode == "max"))
        return scored[0][1]

    def next_checkpoint_dir(self, step: int) -> str:
        return os.path.join(self.storage_path, f"checkpoint_{step:08d}")

    def _enforce_retention(self):
        if self.num_to_keep is None:
            return
        while len(self._checkpoints) > self.num_to_keep:
            _, old, _ = self._checkpoints.pop(0)
            if os.path.isdir(old.path) and \
                    old.path.startswith(self.storage_path):
                shutil.rmtree(old.path, ignore_errors=True)
