"""Logical-axis sharding rules: how tensors map onto the mesh.

Port of ray_tpu/parallel/sharding.py. Params and activations carry
*logical* axis names; a rule table maps each onto mesh axes. A spec is a
plain tuple with one entry per tensor dim: a mesh-axis name, a tuple of
them, or None (replicated), the entries of JAX's ``PartitionSpec``.

The training step reads the rules for two things: the batch axes (the
data-parallel domain its gradients average over and its ZeRO-1 update
shards over) and, per param leaf, the dims it shards over mesh axes (FSDP
and TP param sharding). ``shard_params`` cuts a whole tree into this
rank's blocks, as ``jax.device_put`` with ``NamedSharding(mesh,
rules.spec(*logical))`` lays a leaf out (an entry's axes major to minor,
a dim its axes do not divide refused, as JAX refuses it);
``gather_params`` is its inverse. ``zero1_dims`` is JAX's
``zero1_shardings`` as the choice of the dim a leaf's update shards over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

# Default rule table for transformer training (MaxText-style conventions):
# logical axis name -> mesh axis (or tuple of mesh axes, or None = replicate).
DEFAULT_RULES: dict[str, object] = {
    # params
    "vocab": "tp",
    "embed": ("fsdp",),          # weight-shard over fsdp
    "mlp": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "layers": None,              # stacked-layer leading axis
    "expert": "ep",
    # activations
    "batch": ("dp", "fsdp"),     # global batch split over both data axes
    "seq": "sp",
    "act_embed": None,
    "act_heads": "tp",
}

Spec = tuple  # entries: str | tuple[str, ...] | None


@dataclass
class ShardingRules:
    rules: dict[str, object] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def spec(self, *logical_axes: str | None) -> Spec:
        """The spec of a tensor whose dims have these logical names; a mesh
        axis is used at most once (a later dim that maps to it again is
        replicated)."""
        out = []
        used: set[str] = set()
        for ax in logical_axes:
            if ax is None:
                out.append(None)
                continue
            mesh_ax = self.rules.get(ax)
            if mesh_ax is None:
                out.append(None)
            elif isinstance(mesh_ax, tuple):
                fresh = tuple(m for m in mesh_ax if m not in used)
                used.update(fresh)
                out.append(fresh if len(fresh) > 1 else
                           (fresh[0] if fresh else None))
            elif mesh_ax in used:
                out.append(None)
            else:
                used.add(mesh_ax)
                out.append(mesh_ax)
        return tuple(out)

    def override(self, **updates) -> "ShardingRules":
        return ShardingRules({**self.rules, **updates})


def normalize_spec(spec) -> Spec:
    """Canonical spec: 1-tuples collapse to their bare axis and empty tuples
    to None, so specs compare by meaning."""
    out = []
    for e in (spec or ()):
        if isinstance(e, tuple):
            e = e if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    return tuple(out)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if isinstance(entry, tuple):
        return entry
    return (entry,) if entry else ()


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a dict given as is)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_logical(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names or Nones."""
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def tree_specs(logical_tree, rules: ShardingRules | None = None):
    """A tree of logical-axis tuples -> the same tree of specs."""
    rules = rules or ShardingRules()
    if is_logical(logical_tree):
        return rules.spec(*logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_specs(v, rules) for k, v in logical_tree.items()}
    if logical_tree is None:
        return ()
    raise TypeError(f"not a logical-axes tree: {logical_tree!r}")


# -- param sharding over a mesh of ranks ------------------------------------

class DimShard(NamedTuple):
    """One dim of a leaf split over mesh axes: ``n`` blocks (the product of
    the axes' sizes), of which this rank holds block ``index`` (the axes'
    coordinates, major to minor)."""
    dim: int
    axes: tuple[str, ...]
    n: int
    index: int


def leaf_dim_shards(spec, shape, sizes: dict, coords: dict,
                    name: str = "") -> tuple[DimShard, ...]:
    """The sharded dims of a leaf of ``shape`` under ``spec``, at the rank
    with mesh coordinates ``coords``. Size-1 axes count (a one-block
    split). Raises ValueError, as JAX's ``device_put`` does, where a dim's
    axes do not divide it."""
    out = []
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        if not axes:
            continue
        missing = [a for a in axes if a not in sizes]
        if missing:
            raise ValueError(f"{name}: spec {spec} names mesh axes "
                             f"{missing} not in the mesh {tuple(sizes)}")
        n = math.prod(sizes[a] for a in axes)
        if shape[dim] % n:
            raise ValueError(
                f"{name}: spec {spec} splits dim {dim} of shape "
                f"{tuple(shape)} over {axes} ({n} blocks), which does not "
                f"divide {shape[dim]} (JAX's device_put refuses it too)")
        index = int(np.ravel_multi_index([coords[a] for a in axes],
                                         [sizes[a] for a in axes]))
        out.append(DimShard(dim, axes, n, index))
    return tuple(out)


def tree_paths(tree, path=()):
    """(path, leaf) of a nest of dicts, in order; a path is a tuple of
    keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (k,))
    else:
        yield path, tree


def at_path(tree, path):
    """The subtree (or leaf) of a nest of dicts at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def _rebuild(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group of this rank's ranks along ``axes`` of the mesh
    (all of them at once): the mesh's own group for one axis, else one
    ``new_group`` per subgroup, created on every rank in the same order
    and kept on the mesh, so step factories over one mesh share them.
    Collective the first time: every rank calls it, in one order."""
    import torch.distributed as dist

    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_axes_groups", {})
    if axes in cache:
        return cache[axes]
    names = list(mesh.mesh_dim_names)
    layout = mesh.mesh.cpu().numpy()
    free = [names.index(a) for a in axes]
    rest = [i for i in range(layout.ndim) if i not in free]
    n = math.prod(layout.shape[i] for i in free)
    me, mine = dist.get_rank(), None
    for ranks in layout.transpose(rest + free).reshape(-1, n):
        group = dist.new_group(sorted(int(r) for r in ranks))
        if me in ranks:
            mine = group
    cache[axes] = mine
    return mine


def group_blocks(mesh, group, axes: tuple[str, ...]) -> list[int] | None:
    """For each rank of ``group`` (in group-rank order), the block it holds
    of a dim split over ``axes``; None when that is the group-rank order
    itself (the usual case: ranks grow along every axis)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import mesh_coords

    sizes = axis_sizes(mesh)
    blocks = []
    for r in dist.get_process_group_ranks(group):
        c = mesh_coords(mesh, r)
        blocks.append(int(np.ravel_multi_index(
            [c[a] for a in axes], [sizes[a] for a in axes])))
    return None if blocks == list(range(len(blocks))) else blocks


def shard_params(params, mesh, logical_tree,
                 rules: ShardingRules | None = None):
    """This rank's block of every leaf of a whole tree: the port of JAX's
    ``shard_params`` (``jax.device_put`` of each leaf with
    ``NamedSharding(mesh, rules.spec(*logical))``), each block a
    contiguous copy. ``mesh`` is a DeviceMesh (this process's rank) or a
    pair (axis sizes, coordinates)."""
    import torch

    from ray_tpu_torch.parallel.mesh import mesh_coords

    if isinstance(mesh, tuple):
        sizes, coords = mesh
    else:
        sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    specs = tree_specs(logical_tree, rules)

    def one(path, t):
        spec = at_path(specs, path)
        for d in leaf_dim_shards(spec, t.shape, sizes, coords,
                                 "/".join(path)):
            size = t.shape[d.dim] // d.n
            t = t.narrow(d.dim, d.index * size, size)
        return t.clone(memory_format=torch.contiguous_format)

    return _rebuild(params, one)


def gather_params(local, mesh, logical_tree,
                  rules: ShardingRules | None = None):
    """The inverse of :func:`shard_params`: every rank's blocks of each
    leaf all-gathered over the axes that split it, the whole tree on every
    rank. Collective: every rank of the mesh calls it."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import mesh_coords

    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    specs = tree_specs(logical_tree, rules)

    def one(path, t):
        spec = at_path(specs, path)
        full = list(t.shape)
        for dim, e in enumerate(spec):
            full[dim] *= math.prod(sizes[a] for a in entry_axes(e))
        for d in leaf_dim_shards(spec, full, sizes, coords, "/".join(path)):
            if d.n == 1:
                continue
            group = axes_group(mesh, d.axes)
            out = t.new_empty((d.n * t.shape[0], *t.shape[1:]))
            dist.all_gather_into_tensor(out, t.contiguous(), group=group)
            out = out.view(d.n, *t.shape)
            blocks = group_blocks(mesh, group, d.axes)
            if blocks is not None:
                out = out[torch.as_tensor(np.argsort(blocks))]
            t = out.movedim(0, d.dim).flatten(d.dim, d.dim + 1)
        return t

    with torch.no_grad():
        return _rebuild(local, one)


# -- cross-replica weight-update sharding (ZeRO-1, arxiv 2004.13336) --------

def batch_axes(rules: ShardingRules | None = None) -> tuple[str, ...]:
    """The mesh axes the global batch shards over: the data-parallel domain
    a ZeRO-1 update can shard optimizer state across."""
    rules = rules or ShardingRules()
    ax = rules.rules.get("batch")
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, tuple) else (ax,)


# Logical dims a ZeRO-1 update must not shard: "layers" is the stacked
# dim the layer loop walks, and "vocab" is the gather-indexed dim of the
# embedding table.
ZERO1_SKIP_LOGICAL = ("layers", "vocab")


def zero1_spec(spec, shape: tuple[int, ...], mesh,
               axes: tuple[str, ...],
               logical: tuple[str | None, ...] | None = None) -> Spec:
    """Extend a param leaf's spec so one dim is additionally sharded over
    ``axes`` (the data-parallel mesh axes), when divisible: the largest
    dim divisible by the extra factor whose logical name (when ``logical``
    is given) is not in :data:`ZERO1_SKIP_LOGICAL`. Axes already used in
    the spec and axes of size 1 are skipped; a leaf with no such dim keeps
    its spec (its update stays replicated). ``mesh`` is a DeviceMesh or
    a dict of axis sizes."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec or ())
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if not entries or not shape:
        return spec
    used = set()
    for e in entries:
        used.update(entry_axes(e))
    extra = tuple(a for a in axes if a not in used and sizes[a] > 1)
    if not extra:
        return spec
    extra_n = math.prod(sizes[a] for a in extra)
    best = None
    for dim, size in enumerate(shape):
        if logical is not None and dim < len(logical) and \
                logical[dim] in ZERO1_SKIP_LOGICAL:
            continue
        factor = extra_n * math.prod(sizes[a] for a in entry_axes(
            entries[dim]))
        if size % factor:
            continue
        if best is None or size > shape[best]:
            best = dim
    if best is None:
        return spec
    merged = entry_axes(entries[best]) + extra  # existing axes major
    entries[best] = merged if len(merged) > 1 else merged[0]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def zero1_dims(mesh, shapes, specs, axes: tuple[str, ...],
               logical_axes=None):
    """Per param leaf, the dim its ZeRO-1 update shards over ``axes``
    (:func:`zero1_spec`'s choice), or None where the update stays
    replicated. ``shapes`` is a tree of tensors or shapes; ``specs`` and
    ``logical_axes`` (optional) are trees of the same structure."""
    def one(shape, spec, logical):
        shape = tuple(getattr(shape, "shape", shape))
        spec = tuple(spec or ())
        new = zero1_spec(spec, shape, mesh, axes, logical=logical)
        padded = list(spec) + [None] * (len(shape) - len(spec))
        for dim, e in enumerate(list(new) + [None] * (len(shape) - len(new))):
            if entry_axes(e) != entry_axes(padded[dim]):
                return dim
        return None

    def walk(s, sp, lg):
        if isinstance(s, dict):
            return {k: walk(s[k], sp[k], None if lg is None else lg[k])
                    for k in s}
        return one(s, sp, lg)

    return walk(shapes, specs, logical_axes)
