"""Train-step factory: loss + init + optimizer (+ a mesh) -> one training
step.

Port of ray_tpu/train/spmd.py. The JAX factory jits one step over a mesh
and lets XLA insert the collectives its shardings imply; here the step runs
eagerly and calls ``torch.distributed`` itself, once per leaf, at the
gradient boundary. The state is updated in place (params, moments and the
step counter are overwritten, as donated JAX buffers are).

``mesh=None`` trains on one device with no process group. With a mesh
(``ray_tpu_torch.parallel.mesh``, over NCCL on the card or gloo on the
CPU) every rank calls the step on its own rows of the global batch
(``data_sharder``) and the step returns the global batch's loss and
gradient norm, the same on every rank:

- gradients average over the data-parallel domain: the batch axes of
  ``rules`` (default ``("dp", "fsdp")``) and ``sp``. A sum in the
  gradients' own dtype, then a division. With ``sp`` > 1 the Llama step
  gives each sp rank its chunk of the sequence and the ring runs over the
  sp group, so the loss is the whole sequence's;
- replicated update (default): one ``all_reduce`` per leaf, then the
  optimizer on the whole tree on every rank;
- ``zero1``: each leaf's gradient is reduce-scattered so each rank holds
  its piece of the leaf's padded 1-D view, the optimizer runs on that
  piece only (1/world of the moments on each rank), and the new params
  all-gather back into the params' own storage. JAX shards single-slice
  ZeRO-1 on a leaf dim (``zero1_spec``) and multi-slice on padded 1-D
  views; the port uses the padded 1-D views for both (the same numbers);
- ``dcn_axes`` (the batch axes that cross slices): the JAX hierarchy. A
  reduce-scatter within the slice (the ici group) to shard-sized pieces,
  then the cross-slice (dcn) stage on those pieces only: an all-reduce, or
  with ``zero1`` a reduce-scatter made of a destination-chunked
  ``all_to_all`` and a local sum; params gather dcn first, then ici.
  Without ``zero1`` the update shards over the ici group;
- ``dcn_quant``: the dcn stage moves bf16 rows ("bf16") or int8 values
  with one f32 scale per ``dcn_quant_bucket`` elements ("int8"), and sums
  them in f32 after the move. Each leaf pads to ``dcn_n * ici_n *
  bucket`` elements, so buckets fall at JAX's flat offsets;
- ``grad_accum=N``: N microbatches of forward + backward accumulate into
  ``.grad``, scaled by 1/N; one gradient sync and one update at the end.
  Microbatch i is the global batch's rows ``[i B/N, (i+1) B/N)``, as
  JAX splits it, each rank holding its share of every one (outside the
  explicit hierarchy, ``data_sharder`` hands a rank those rows, i-major),
  so a loss that couples a microbatch's rows (Mixtral's routing) sees
  JAX's microbatches;
- ``grad_norm_every=N``: the norm is computed on steps whose counter is a
  multiple of N, -1 on the others.

A one-rank mesh runs every collective of its mode on one-rank groups.

Param sharding (FSDP, TP, EP and any other rule table): whenever the
rules map a param dim onto a mesh axis (JAX's default table: ``embed``
on fsdp, ``heads``/``kv_heads``/``mlp``/``vocab`` on tp, ``expert`` on
ep; size-1 axes count), each rank's ``state.params`` holds its block of
each leaf, as ``NamedSharding(mesh, rules.spec(*logical))`` lays it out,
and the step calls ``loss(params, tokens, targets, param_shard=...)``,
whose model gathers each split dim where it uses it and computes its
local heads, MLP columns and vocabulary rows under tp, and its own
experts under ep (``parallel.param_shard``). Three kinds of axis meet in
a leaf's gradient. A gather over a data axis (one whose ranks hold
different rows: the batch axes and sp) reduce-scatters, so the gradient
arrives summed over the data axes that split the leaf; a gather over an
axis whose ranks hold the same rows (tp, ep or pp splitting a dim the
model does not compute locally) takes this rank's block and sums
nothing; a tp- or ep-local dim does neither (experts over ep with the
batch over ep too arrive summed over ep by the dispatch). The step then
sums each gradient over the data axes that do not split the leaf and
divides by the whole data-parallel size. Context parallelism (sp > 1)
runs under any of these layouts: the ring over sp on the local heads,
the gathers over their own groups. Every mode above applies to the
local blocks: ``zero1`` takes pieces of each block's padded flat view
over the data axes that do not split the leaf. Under ``dcn_axes`` (the
explicit hierarchy) the gradient and the update run on each whole leaf's
padded flat view, as JAX's do, so that pieces and int8 buckets fall at
JAX's flat offsets: a leaf's block gradient is placed in a zeroed whole
leaf (its tp and ep blocks gathered first) and the reduce-scatter over
the slice sums the ranks' blocks, and the updated whole leaf is cut back
to the block; one whole leaf at a time is alive, and each step moves
fsdp times a block's gradient bytes where a reshard would move them once
(ROADMAP Queue A item 1). A dim split over an axis outside the slice's
data axes (a dcn axis, or tp, ep or pp on a dim the model gathers) is
gathered before the forward instead, outside autograd, so its gradient
is this rank's on the whole dim, lands at its offset and sums over the
slice, then over the dcn stage; such a leaf is whole over that dim for
the step. The gradient norm is the whole gradient's: square sums
all-reduced over the axes that split each leaf, a leaf replicated over
tp or ep counted once.

Returns (step_fn, init_state, data_sharder), as the JAX factory does:

- ``init_state(params=None)`` -> TrainState: params from ``init_fn(seed)``,
  or a copy of the given tree (e.g. ``params_from_jax`` of a JAX tree) on
  the step's device, cut to this rank's blocks under param sharding;
  every rank must start from the same (whole) params;
- ``step_fn(state, tokens, targets)`` -> (state, {"loss", "grad_norm"}),
  metrics as device scalars; grad_norm is the global L2 norm of the
  averaged gradients (``optax.global_norm``), summed in f32;
- ``data_sharder(global_array)`` -> this rank's rows over the batch axes,
  on the step's device (every rank passes the same global array).
"""

from __future__ import annotations

import inspect
import math
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device, tree_leaves, tree_map
from ray_tpu_torch.collective.quant import (
    dequantize_int8_buckets,
    quantize_int8_bucketed,
)
from ray_tpu_torch.models import mixtral, vit
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
    loss_fn,
    param_logical_axes,
)
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_coords
from ray_tpu_torch.parallel.param_shard import (
    ParamShard,
    _all_gather,
    _order,
    check_layout,
    split_dims,
    tp_indivisible,
)
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    at_path,
    axes_group,
    axis_sizes,
    batch_axes,
    shard_params,
    tree_paths,
    tree_specs,
)
from ray_tpu_torch.train.optim import (
    GradientTransformation,
    adamw,
    apply_updates,
)

DCN_QUANT_BUCKET = 256  # elements per int8 scale (JAX's config default)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 scalar on the device
    # The step counter's host copy, so grad_norm_every reads no device
    # value; None makes the next step read ``step`` once.
    host_step: int | None = field(default=None, repr=False, compare=False)
    # Per param leaf path: the _Piece of its flat view this rank's moments
    # hold, and its param block (see checkpoint_tree).
    layout: dict | None = field(default=None, repr=False, compare=False)

    def checkpoint_tree(self) -> dict:
        """The state as ``train.checkpoint.save_pytree`` writes it and
        ``restore_pytree`` fills it in place: params leaf-shaped, each
        moment as the flat view of its param ([numel]; under ``zero1`` or
        ``dcn_axes`` this rank's piece of it, so a state saved at one world
        size restores at another). Under param sharding each param and
        (flat mode) each moment is this rank's ``BlockShard`` of the whole
        leaf, so the state restores at another mesh or with none. Under
        ``zero1`` without ``dcn_axes`` a moment is this rank's piece of
        its block's padded flat view, which is no rectangle of the leaf:
        it is a ``BlockShard`` with a ``gather``, which ``save_pytree``
        calls one leaf at a time (an all-gather over the update group),
        and only the block's first holder keeps the block, until the
        write ends; a restore reads the block, with no gather, and each
        rank cuts its own piece from it (``after_load``). Under
        ``dcn_axes`` the moments are pieces of the whole leaf's flat
        view: ``FlatShard``s. Clears ``host_step``, since a restore into
        it may follow."""
        from ray_tpu_torch.train.checkpoint import BlockShard, FlatShard

        self.host_step = None
        layout = self.layout or {}

        def block(t, piece):
            b = piece.block
            return BlockShard(t, b.shape, b.offsets, b.replicas, b.owner)

        def gathered(t, piece):
            import torch.distributed as dist

            c = t.numel()
            b = piece.block

            def gather():
                flat = t.new_empty(c * dist.get_world_size(piece.group))
                dist.all_gather_into_tensor(
                    flat, t.reshape(-1).contiguous(), group=piece.group)
                return flat[:piece.numel].view(b.size)

            def put(loaded, off=piece.offset):
                src = loaded.reshape(-1)[off:off + c]
                t.view(-1)[:src.numel()].copy_(src)
                t.view(-1)[src.numel():].zero_()  # the flat view's padding

            return BlockShard(
                torch.empty(b.size, dtype=t.dtype, device="meta"), b.shape,
                b.offsets, b.replicas, b.owner, put, gather, t.device)

        def moment(t, piece):
            if piece.group is not None:
                return gathered(t, piece)
            if piece.sharded:
                return FlatShard(t, piece.numel, piece.offset, piece.length,
                                 piece.replicas, piece.owner)
            if piece.block is not None:
                return block(t, piece)
            return t.view(-1)

        def walk(t):
            # A subtree with the params' leaf paths mirrors them (the
            # optimizer built it from the params or their pieces).
            if isinstance(t, dict) and \
                    [p for p, _ in tree_paths(t)] == list(layout):
                it = iter(layout.values())
                return tree_map(lambda x: moment(x, next(it)), t)
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, tuple) and hasattr(t, "_fields"):
                return type(t)(*(walk(v) for v in t))
            if isinstance(t, (tuple, list)):
                return type(t)(walk(v) for v in t)
            return t

        params = self.params
        if any(p.block is not None for p in layout.values()):
            it = iter(layout.values())
            params = tree_map(lambda t: block(t, next(it)), params)
        return {"params": params, "opt_state": walk(self.opt_state),
                "step": self.step}


class _Block(NamedTuple):
    """A param leaf's block on this rank under param sharding: the whole
    leaf's ``shape``, the block's ``offsets`` and ``size``, the ranks
    holding the same block (``replicas``) and whether this one writes
    it."""
    shape: tuple
    offsets: tuple
    replicas: Any
    owner: bool
    size: tuple = ()


class _Piece(NamedTuple):
    """A param leaf's update piece on this rank: the elements at ``offset``
    of its (block's) padded flat view, of which ``length`` fall inside its
    ``numel``; ``replicas`` is the group of ranks holding the same
    piece (None: this rank alone), ``owner`` whether this rank writes it
    to a checkpoint; ``block`` the leaf's param block (None: whole);
    ``group`` the update group whose ranks hold the pieces of the block's
    flat view, in order (None: the piece is of the whole leaf's)."""
    numel: int
    offset: int
    length: int
    sharded: bool
    replicas: Any = None
    owner: bool = True
    block: Any = None
    group: Any = None


class _Plan:
    """The collectives of one step factory's mode over a mesh: its process
    groups (built once, here), this rank's rows, and the per-leaf layout
    of the sharded update."""

    def __init__(self, mesh, dev, data_axes, dcn_data, ici_data, zero1,
                 explicit_hier, dcn_quant, bucket, sp_axes=None):
        import torch.distributed as dist

        from ray_tpu_torch.parallel.mesh import mesh_coords

        try:
            mesh.get_group(mesh.mesh_dim_names[0])
        except RuntimeError as e:
            raise ValueError(
                "the mesh has no process groups (single_device_mesh()); "
                "pass mesh=None to train on one device, or build the mesh "
                "after train.backend.init_distributed") from e
        if mesh.device_type != dev.type:
            raise ValueError(f"mesh of {mesh.device_type} ranks, step on "
                             f"{dev}")
        sizes = axis_sizes(mesh)
        coords = mesh_coords(mesh)
        if coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self.dist = dist
        sp = (("sp",) if "sp" in sizes else ()) if sp_axes is None \
            else sp_axes
        self.avg_axes = data_axes + sp
        self.n_avg = math.prod(sizes[a] for a in self.avg_axes)
        self.data_n = math.prod(sizes[a] for a in data_axes)
        self.data_index = int(np.ravel_multi_index(
            [coords[a] for a in data_axes],
            [sizes[a] for a in data_axes])) if data_axes else 0
        self.zero1, self.quant = zero1, dcn_quant
        self.two_level = explicit_hier
        self.sharded = zero1 or explicit_hier
        # Groups, in one order on every rank.
        self.avg = axes_group(mesh, self.avg_axes)
        if self.two_level:
            self.ici_axes = ici_data + sp
            self.ici = axes_group(mesh, self.ici_axes)
            self.dcn = axes_group(mesh, dcn_data)
            self.ici_n = math.prod(sizes[a] for a in self.ici_axes)
            self.dcn_n = math.prod(sizes[a] for a in dcn_data)
            self.ici_rank = dist.get_rank(self.ici)
            self.dcn_rank = dist.get_rank(self.dcn)
            self.upd = self.avg if zero1 else self.ici
            world = self.ici_n * self.dcn_n
        else:
            self.upd = self.avg
            world = self.n_avg
        self.unit = world * (bucket if dcn_quant == "int8" else 1)
        self.bucket = bucket

    # -- the sharded update's layout ---------------------------------------

    def piece(self, numel: int) -> tuple[int, int, int]:
        """(padded numel, this rank's offset in the padded flat view, its
        length) of a leaf's update piece."""
        npad = numel + (-numel) % self.unit
        if not self.two_level:
            c = npad // self.n_avg
            return npad, self.dist.get_rank(self.avg) * c, c
        blk = npad // self.ici_n
        if not self.zero1:
            return npad, self.ici_rank * blk, blk
        c = blk // self.dcn_n
        return npad, self.ici_rank * blk + self.dcn_rank * c, c

    def owner(self) -> bool:
        """Whether this rank writes its piece to a checkpoint: without
        zero1 the dcn slices hold the same pieces, and slice 0 writes."""
        return not self.two_level or self.zero1 or self.dcn_rank == 0

    # -- collectives -------------------------------------------------------

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        self.dist.all_reduce(t, group=self.avg)
        return t.div_(self.n_avg)

    def reduce_grad(self, g: torch.Tensor, npad: int) -> torch.Tensor:
        """A leaf's local gradient -> this rank's piece of the averaged
        gradient's padded flat view, in the gradient's dtype."""
        dist = self.dist
        flat = g.view(-1)
        if npad > flat.numel():
            flat = F.pad(flat, (0, npad - flat.numel()))
        if not self.two_level:
            out = flat.new_empty(npad // self.n_avg)
            dist.reduce_scatter_tensor(out, flat, group=self.avg)
            return out.div_(self.n_avg)
        blk = flat.new_empty(npad // self.ici_n)
        dist.reduce_scatter_tensor(blk, flat, group=self.ici)
        del flat
        blk.div_(self.ici_n)  # this slice's mean, as JAX's per-slice grads
        return self._dcn_stage(blk)

    def _dcn_stage(self, blk: torch.Tensor) -> torch.Tensor:
        """The cross-slice stage on a shard-sized piece."""
        dist, n, dt = self.dist, self.dcn_n, blk.dtype
        if self.quant is None:
            if not self.zero1:
                dist.all_reduce(blk, group=self.dcn)
                return blk.div_(n)
            out = torch.empty_like(blk)
            dist.all_to_all_single(out, blk, group=self.dcn)
            return out.view(n, -1).sum(0).div_(n)
        if self.quant == "bf16":
            x16 = blk.to(torch.bfloat16)
            if self.zero1:
                out = torch.empty_like(x16)
                dist.all_to_all_single(out, x16, group=self.dcn)
            else:
                out = x16.new_empty(n * x16.numel())
                dist.all_gather_into_tensor(out, x16, group=self.dcn)
            g = out.view(n, -1).float().sum(0)
        else:  # int8 values + one f32 scale per bucket
            q, sc = quantize_int8_bucketed(blk.view(-1, self.bucket))
            if self.zero1:
                qo, so = torch.empty_like(q), torch.empty_like(sc)
                dist.all_to_all_single(qo, q, group=self.dcn)
                dist.all_to_all_single(so, sc, group=self.dcn)
            else:
                qo = q.new_empty((n * q.shape[0], self.bucket))
                so = sc.new_empty((n * sc.shape[0], 1))
                dist.all_gather_into_tensor(qo, q, group=self.dcn)
                dist.all_gather_into_tensor(so, sc, group=self.dcn)
            g = dequantize_int8_buckets(qo, so).view(n, -1).sum(0)
        return (g / n).to(dt)

    def gather_params(self, flat: torch.Tensor, off: int, c: int) -> None:
        """All-gather every rank's updated piece into ``flat`` (the param's
        own storage, or its padded copy), in place: dcn first, then ici."""
        dist = self.dist
        if not self.two_level:
            dist.all_gather_into_tensor(flat, flat[off:off + c],
                                        group=self.avg)
            return
        blk = flat.numel() // self.ici_n
        start = self.ici_rank * blk
        if self.zero1:
            dist.all_gather_into_tensor(flat[start:start + blk],
                                        flat[off:off + c], group=self.dcn)
        dist.all_gather_into_tensor(flat, flat[start:start + blk],
                                    group=self.ici)


class _LeafSync(NamedTuple):
    """How one param leaf's gradient is synchronised under param
    sharding: the plan over the data axes that do not split it, the
    divisor of its gathers' sums (the data axes that split it), and the
    group over the axes that split it (its norm's square sums)."""
    plan: Any
    divisor: int
    shard_axes: tuple
    shard_group: Any


def _leaf_syncs(mesh, dev, ps: ParamShard, avg_axes,
                zero1) -> dict[tuple, _LeafSync]:
    """Per param leaf path: its gradient's plan over the data axes (the
    batch axes and sp) that do not split it (one ``_Plan`` per distinct
    set, groups built once, in one order on every rank). Only for the
    one-level sync: under the explicit hierarchy the step runs on whole
    leaves."""
    sizes = axis_sizes(mesh)
    plans: dict = {}
    out = {}
    for path, axes in ps.shard_axes.items():
        axes = tuple(a for a in AXIS_ORDER if a in axes)
        keep = tuple(a for a in avg_axes if a not in axes)
        if keep not in plans:
            plans[keep] = _Plan(mesh, dev, keep, (), (), zero1, False, None,
                                DCN_QUANT_BUCKET, sp_axes=())
        divisor = math.prod(sizes[a] for a in axes if a in avg_axes)
        out[path] = _LeafSync(plans[keep], divisor, axes,
                              axes_group(mesh, axes))
    return out


def _block_index(blk: _Block, shape) -> tuple:
    """The slices of the whole leaf a block of ``shape`` at ``blk``'s
    offsets covers (dims gathered whole, such as tp's, start at 0)."""
    return tuple(slice(o if n != w else 0, (o if n != w else 0) + n)
                 for o, n, w in zip(blk.offsets, shape, blk.shape))


def _block_of(path, shape, spec, mesh) -> _Block:
    """A param leaf's block on this rank (its offsets in the whole leaf of
    ``shape``) and the group of ranks holding the same block, whose
    lowest rank (coordinate 0 on every other axis) writes it."""
    from ray_tpu_torch.parallel.sharding import leaf_dim_shards

    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    offsets = [0] * len(shape)
    size = list(shape)
    used = set()
    for d in leaf_dim_shards(spec, shape, sizes, coords, "/".join(path)):
        size[d.dim] = shape[d.dim] // d.n
        offsets[d.dim] = d.index * size[d.dim]
        used.update(d.axes)
    rest = tuple(a for a in AXIS_ORDER if a not in used)
    return _Block(tuple(shape), tuple(offsets),
                  axes_group(mesh, rest) if rest else None,
                  all(coords[a] == 0 for a in rest), tuple(size))


def _map_paths(tree, fn, path=()):
    """A nest of dicts with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _takes_param_shard(loss: Callable) -> bool:
    """Whether ``loss`` accepts the keyword ``param_shard``."""
    try:
        ps = inspect.signature(loss).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "param_shard" and p.kind != p.POSITIONAL_ONLY
               or p.kind == p.VAR_KEYWORD for p in ps)


def _data_domain(sizes: dict, rules: ShardingRules, dcn_axes, zero1,
                 dcn_quant) -> tuple:
    """The step's data-parallel domain on a mesh of ``sizes``: (the batch
    axes, those of them across slices (dcn), those within a slice (ici),
    the axes the update is sharded over, whether the step runs the
    explicit hierarchy, the normalised ``dcn_quant``). Under the explicit
    hierarchy JAX's step maps the loss over the slices, so whatever spans
    the batch (Mixtral's routing) spans a slice's ici axes only."""
    names = tuple(sizes)
    dcn_axes = tuple(dcn_axes or ())
    unknown = [a for a in dcn_axes if a not in names]
    if unknown:
        raise ValueError(f"dcn_axes {unknown} not in mesh {names}")
    data_axes = tuple(a for a in batch_axes(rules) if a in names)
    dcn_data = tuple(a for a in data_axes if a in dcn_axes)
    ici_data = tuple(a for a in data_axes if a not in dcn_axes)
    if dcn_axes and not dcn_data:
        raise ValueError(
            f"dcn_axes {dcn_axes} must name batch (data-parallel) axes; "
            f"the batch shards over {data_axes}")
    if dcn_quant in ("", "none"):
        dcn_quant = None
    if dcn_quant and not dcn_data:
        raise ValueError("dcn_quant requires dcn_axes naming a batch axis")
    if dcn_quant not in (None, "bf16", "int8"):
        raise ValueError(f"unknown dcn_quant {dcn_quant!r}")
    update_axes = (ici_data + dcn_data) if zero1 else \
        (ici_data if dcn_axes else ())
    explicit_hier = bool(dcn_data) and bool(update_axes or dcn_quant)
    return data_axes, dcn_data, ici_data, update_axes, explicit_hier, \
        dcn_quant


def make_train_step(
    mesh=None,
    *,
    loss: Callable,          # loss(params, tokens, targets) -> scalar
    init_fn: Callable,       # init_fn(seed) -> params tree
    logical_axes: Any = None,
    rules: ShardingRules | None = None,
    optimizer: GradientTransformation | None = None,
    seed: int = 0,
    zero1: bool = False,
    grad_accum: int = 1,
    grad_norm_every: int | None = None,
    dcn_axes: tuple[str, ...] = (),
    dcn_quant: str | None = None,
    dcn_quant_bucket: int | None = None,
    device: torch.device | str = "cuda",
    unit_counts: dict | None = None,
) -> tuple[Callable, Callable, Callable]:
    """Model-agnostic step factory (see the module docstring). When the
    rules shard params, ``loss`` must take ``param_shard`` (a keyword) and
    compute on this rank's param blocks. ``unit_counts`` gives the
    model's head counts (``{"attn": (num_heads, num_kv_heads)}``): where
    tp does not divide them, the heads are gathered, not tp-local."""
    dev = resolve_device(device)
    rules = rules or ShardingRules()
    optimizer = optimizer or adamw(3e-4, weight_decay=0.1,
                                   mu_dtype=torch.bfloat16)
    grad_norm_every = max(1, int(1 if grad_norm_every is None
                                 else grad_norm_every))
    grad_accum = max(1, int(grad_accum))
    bucket = int(dcn_quant_bucket or DCN_QUANT_BUCKET)

    # -- the data-parallel domain: intra-slice (ici) vs cross-slice (dcn) --
    sizes = axis_sizes(mesh) if mesh is not None else {}
    data_axes, dcn_data, ici_data, update_axes, explicit_hier, dcn_quant = \
        _data_domain(sizes, rules, dcn_axes, zero1, dcn_quant)
    n_slices = math.prod(sizes[a] for a in dcn_data) if dcn_data else 1

    plan = ps = None
    leaf_sync: list[_LeafSync] = []  # in the params' leaf order
    syncs: dict[tuple, _LeafSync] = {}
    # Per param leaf path, the mesh axes the rules split it over.
    layout = check_layout(sizes, logical_axes, rules) \
        if mesh is not None and logical_axes is not None else {}
    split = {p: tuple(a for _, axes in dims for a in axes)
             for p, dims in layout.items()}
    if any(split.values()) and not _takes_param_shard(loss):
        raise NotImplementedError(
            f"the rules shard params over "
            f"{sorted({a for v in split.values() for a in v})} (FSDP/TP), "
            f"and this loss takes whole params: pass a "
            f"loss(params, tokens, targets, param_shard=...) whose "
            f"model gathers and computes on this rank's blocks (as "
            f"make_llama_train_step and make_vit_train_step do), or "
            f"rules that replicate params")
    pregather: dict = {}  # whole-leaf mode: {path: ((dim, n, group, order),)}
    if mesh is not None:
        plan = _Plan(mesh, dev, data_axes, dcn_data, ici_data, bool(zero1),
                     explicit_hier, dcn_quant, bucket)
        if any(split.values()):
            whole_dims = {}
            if explicit_hier:  # dims split outside the slice's data axes
                for path, (gathered, _) in split_dims(
                        layout, logical_axes, plan.avg_axes,
                        tp_indivisible(unit_counts, sizes["tp"])).items():
                    whole_dims[path] = tuple(
                        (d, axes) for d, axes in gathered
                        if any(a not in plan.ici_axes and sizes[a] > 1
                               for a in axes))
            ps = ParamShard(mesh, logical_axes, rules, plan.avg_axes,
                            {p: [d for d, _ in v]
                             for p, v in whole_dims.items()}, unit_counts)
            for path, dims in whole_dims.items():
                if dims:
                    pregather[path] = tuple(
                        (d, math.prod(sizes[a] for a in axes), g,
                         _order(mesh, g, axes))
                        for d, axes in dims
                        for g in (axes_group(mesh, axes),))
            if not explicit_hier:
                syncs = _leaf_syncs(mesh, dev, ps, plan.avg_axes,
                                    bool(zero1))
    sharded = plan is not None and plan.sharded
    whole_leaf = ps is not None and explicit_hier  # see the docstring
    if explicit_hier:  # this rank's slice and its place in the slice
        coords = mesh_coords(mesh)
        slice_index, ici_index = (
            int(np.ravel_multi_index([coords[a] for a in axes],
                                     [sizes[a] for a in axes]))
            if axes else 0 for axes in (dcn_data, ici_data))
    if ps is not None:
        loss = partial(loss, param_shard=ps)

    def _model_params(params):
        """The params the model computes on: in whole-leaf mode the dims
        split outside the slice's data axes gathered (no gradient into
        the stored blocks: the update reads these tensors' gradients)."""
        if not pregather:
            return params

        def one(path, t):
            if path not in pregather:
                return t
            with torch.no_grad():
                for dim, n, group, order in pregather[path]:
                    t = _all_gather(t, dim, n, group, order)
            return t.requires_grad_(True)

        return _map_paths(params, one)

    def _plan_of(i: int):
        return leaf_sync[i].plan if leaf_sync else plan

    def _pieces(params):
        """Per leaf (in tree order): the padded flat view (the leaf's own
        storage when no padding is needed), this rank's offset, length."""
        out = []
        for i, p in enumerate(tree_leaves(params)):
            npad, off, c = _plan_of(i).piece(p.numel())
            flat = p.detach().view(-1)
            if npad > flat.numel():
                flat = F.pad(flat, (0, npad - flat.numel()))
            out.append((flat, off, c))
        return out

    def _unflat(params, leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), params)

    def init_state(params: dict | None = None) -> TrainState:
        if params is None:
            params = init_fn(seed)
        blocks = [None] * len(tree_leaves(params))
        whole_pieces = None
        if ps is not None:
            specs = tree_specs(logical_axes, rules)
            if whole_leaf:
                with torch.no_grad():
                    whole_pieces = [
                        f[off:off + c].to(dev, copy=True)
                        for f, off, c in _pieces(tree_map(
                            lambda t: t.detach(), params))]
            else:
                leaf_sync[:] = [syncs[p] for p, _ in tree_paths(params)]
            blocks = [_block_of(path, t.shape, at_path(specs, path), mesh)
                      for path, t in tree_paths(params)]
            with torch.no_grad():
                params = shard_params(tree_map(lambda t: t.detach(), params),
                                      mesh, logical_axes, rules)
        params = tree_map(
            lambda t: t.detach().to(dev, copy=True).requires_grad_(True),
            params)
        layout = {}
        with torch.no_grad():
            if sharded:
                pieces = _pieces(params)
                opt_state = optimizer.init(_unflat(params, whole_pieces or [
                    f[off:off + c] for f, off, c in pieces]))
                if whole_leaf:  # the whole leaves' pieces
                    pieces = [(None, *plan.piece(math.prod(b.shape))[1:])
                              for b in blocks]
                for i, ((path, p), (_, off, c)) in enumerate(zip(
                        tree_paths(params), pieces)):
                    lp = _plan_of(i)
                    replicas = lp.dcn if lp.two_level and not lp.zero1 \
                        else None
                    n = math.prod(blocks[i].shape) if whole_leaf \
                        else p.numel()
                    group = lp.upd if blocks[i] is not None and \
                        not whole_leaf else None
                    layout[path] = _Piece(n, off, max(0, min(n, off + c) - off),
                                          True, replicas, lp.owner(),
                                          blocks[i], group)
            else:
                opt_state = optimizer.init(params)
                for (path, p), blk in zip(tree_paths(params), blocks):
                    layout[path] = _Piece(p.numel(), 0, p.numel(), False,
                                          block=blk)
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          host_step=0, layout=layout)

    def _check_batch(local_b: int) -> None:
        b = local_b * (plan.data_n if plan is not None else 1)
        if explicit_hier and b % (n_slices * grad_accum):
            raise ValueError(
                f"batch {b} not divisible by {n_slices} slices x "
                f"grad_accum={grad_accum}")
        if b % grad_accum:
            raise ValueError(
                f"batch {b} not divisible by grad_accum={grad_accum}")
        if local_b % grad_accum:
            raise ValueError(
                f"this rank's {local_b} rows not divisible by "
                f"grad_accum={grad_accum}")

    def _loss_and_grads(params, tokens, targets):
        """Forward + backward of this rank's rows; the gradients land in
        each leaf's .grad (summed over microbatches, then scaled by 1/N)."""
        if grad_accum == 1:
            loss_val = loss(params, tokens, targets)
            loss_val.backward()
            return loss_val.detach()
        mb = tokens.shape[0] // grad_accum
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(grad_accum):
            rows = slice(i * mb, (i + 1) * mb)
            lv = loss(params, tokens[rows], targets[rows])
            lv.backward()
            total += lv.detach()
        inv = 1.0 / grad_accum
        for p in tree_leaves(params):
            p.grad.mul_(inv)
        return total * inv

    def _norm_due(state: TrainState) -> bool:
        if grad_norm_every == 1:
            return True
        if state.host_step is None:
            state.host_step = int(state.step)
        return state.host_step % grad_norm_every == 0

    def _norm(sqs: list) -> torch.Tensor:
        """The whole gradient's norm from each leaf's square sum (over its
        block, or its update piece when ``sharded``): summed per group of
        leaves that share a reduction, all-reduced over the update group
        (pieces) and over the axes that split the leaves (blocks)."""
        if not leaf_sync:
            sq = torch.stack(sqs).sum()
            if sharded:
                plan.dist.all_reduce(sq, group=plan.upd)
            return sq.sqrt()
        keys: dict = {}
        for s, ls in zip(sqs, leaf_sync):
            key = (id(ls.plan), ls.shard_axes)
            keys.setdefault(key, (ls, []))[1].append(s)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for _, (ls, parts) in sorted(keys.items(), key=lambda kv: (
                kv[1][0].plan.avg_axes, kv[0][1])):
            sq = torch.stack(parts).sum()
            if sharded:
                plan.dist.all_reduce(sq, group=ls.plan.upd)
            plan.dist.all_reduce(sq, group=ls.shard_group)
            total += sq
        return total.sqrt()

    def _whole_leaf_update(state, params, mparams, leaves, due):
        """The explicit hierarchy under param sharding (see the module
        docstring): each leaf's gradient and update on its whole padded
        flat view, one whole leaf alive at a time. ``mparams`` are the
        tensors the model ran on (``_model_params``)."""
        blocks = [p.block for p in state.layout.values()]
        shards, p_pieces = [], []
        for (path, _), p, blk in zip(tree_paths(params),
                                     tree_leaves(mparams), blocks):
            g, p.grad = p.grad, None
            g = ps.local_full(path, g)
            whole = g.new_zeros(blk.shape)
            whole[_block_index(blk, g.shape)] = g
            del g
            npad, off, c = plan.piece(whole.numel())
            shards.append(plan.reduce_grad(whole, npad))
            w = ps.whole(path, p.detach()).reshape(-1)
            p_pieces.append(F.pad(w, (0, npad - w.numel()))[off:off + c]
                            .clone())
            del whole, w
        gnorm = _norm([s.float().square().sum() for s in shards]) \
            if due else None
        updates, _ = optimizer.update(_unflat(params, shards),
                                      state.opt_state,
                                      _unflat(params, p_pieces))
        del shards
        apply_updates(_unflat(params, p_pieces), updates)
        del updates
        for p, blk, piece in zip(leaves, blocks, p_pieces):
            numel = math.prod(blk.shape)
            npad, off, c = plan.piece(numel)
            flat = piece.new_empty(npad)
            flat[off:off + c] = piece
            plan.gather_params(flat, off, c)
            p.detach().copy_(flat[:numel].view(blk.shape)[
                _block_index(blk, p.shape)])
            del flat
        return gnorm

    def step_fn(state: TrainState, tokens, targets):
        params = state.params
        leaves = tree_leaves(params)
        if explicit_hier or grad_accum > 1:
            _check_batch(tokens.shape[0])
        mparams = _model_params(params)
        loss_val = _loss_and_grads(mparams, tokens, targets)
        due = _norm_due(state)
        with torch.no_grad():
            if plan is not None:
                loss_val = plan.all_reduce_mean(loss_val.clone())
            if not sharded:
                if leaf_sync:  # the rest of the data-parallel mean
                    for p, ls in zip(leaves, leaf_sync):
                        plan.dist.all_reduce(p.grad, group=ls.plan.avg)
                        p.grad.div_(plan.n_avg)
                elif plan is not None:
                    for p in leaves:
                        plan.all_reduce_mean(p.grad)
                grads = tree_map(lambda p: p.grad, params)
                if due:
                    gnorm = _norm([p.grad.float().square().sum()
                                   for p in leaves])
                updates, _ = optimizer.update(grads, state.opt_state, params)
                apply_updates(params, updates)
            elif whole_leaf:
                gnorm = _whole_leaf_update(state, params, mparams, leaves,
                                           due)
                del mparams
            else:
                pieces = _pieces(params)
                shards = []
                for i, (p, (flat, _, _)) in enumerate(zip(leaves, pieces)):
                    g, p.grad = p.grad, None
                    if leaf_sync and leaf_sync[i].divisor > 1:
                        g.div_(leaf_sync[i].divisor)
                    shards.append(_plan_of(i).reduce_grad(g, flat.numel()))
                    del g
                if due:
                    gnorm = _norm([s.float().square().sum() for s in shards])
                p_pieces = _unflat(params,
                                   [f[off:off + c] for f, off, c in pieces])
                updates, _ = optimizer.update(_unflat(params, shards),
                                              state.opt_state, p_pieces)
                del shards
                apply_updates(p_pieces, updates)
                del updates
                for i, (p, (flat, off, c)) in enumerate(zip(leaves,
                                                            pieces)):
                    _plan_of(i).gather_params(flat, off, c)
                    if flat.numel() > p.numel():
                        p.detach().view(-1).copy_(flat[:p.numel()])
            if not due:
                gnorm = torch.full((), -1.0, dtype=torch.float32,
                                   device=dev)
            state.step.add_(1)
        if state.host_step is not None:
            state.host_step += 1
        for p in leaves:
            p.grad = None
        return state, {"loss": loss_val, "grad_norm": gnorm}

    def data_sharder(arr) -> torch.Tensor:
        if plan is not None:
            b = arr.shape[0]
            if b % plan.data_n:
                raise ValueError(
                    f"batch {b} not divisible by the {plan.data_n} ranks of "
                    f"the batch axes {data_axes}")
            rows = b // plan.data_n
            if explicit_hier:  # slice s's rows, its microbatches i-major
                _check_batch(rows)
                ici_dn = plan.data_n // n_slices
                arr = arr.reshape(n_slices, grad_accum, ici_dn,
                                  rows // grad_accum, *arr.shape[1:])[
                    slice_index, :, ici_index]
                arr = arr.reshape(rows, *arr.shape[2:])
            elif grad_accum > 1:
                _check_batch(rows)  # this rank's share of each microbatch
                mb = rows // grad_accum
                arr = arr.reshape(grad_accum, plan.data_n, mb,
                                  *arr.shape[1:])[:, plan.data_index]
                arr = arr.reshape(rows, *arr.shape[2:])
            else:
                arr = arr[plan.data_index * rows:
                          (plan.data_index + 1) * rows]
        if isinstance(arr, torch.Tensor):
            return arr.to(dev)
        return torch.as_tensor(np.asarray(arr), device=dev)

    return step_fn, init_state, data_sharder


def _sp_loss(mesh, loss_of):
    """``loss_of(p, tokens, targets, positions, sp_axis, **kw)`` -> a loss
    over tokens [B, S] (keywords, such as ``param_shard``, passed on): with
    an sp axis of size > 1 in the mesh, this rank's chunk of the sequence
    at its global positions, the ring over the sp group; else the whole
    sequence."""
    sp = axis_sizes(mesh).get("sp", 1) if mesh is not None else 1
    if sp == 1:
        return lambda p, tokens, targets, **kw: loss_of(p, tokens, targets,
                                                        None, None, **kw)
    import torch.distributed as dist

    def loss(p, tokens, targets, **kw):
        group = mesh.get_group("sp")  # at the step: the factory checks first
        r = dist.get_rank(group)
        s = tokens.shape[1]
        if s % sp:
            raise ValueError(f"sequence {s} not divisible by sp={sp}")
        c = s // sp
        cols = slice(r * c, (r + 1) * c)
        pos = torch.arange(r * c, (r + 1) * c, device=tokens.device)
        return loss_of(p, tokens[:, cols], targets[:, cols], pos, group,
                       **kw)

    return loss


def make_llama_train_step(
    cfg: LlamaConfig,
    mesh=None,
    rules: ShardingRules | None = None,
    optimizer: GradientTransformation | None = None,
    attn_impl: str = "flash",
    remat: bool | str | tuple = True,
    seed: int = 0,
    device: torch.device | str = "cuda",
    **step_options,
) -> tuple[Callable, Callable, Callable]:
    """Llama specialization of :func:`make_train_step`. ``remat`` takes a
    single policy or a per-layer spec (models/llama.normalize_remat);
    ``step_options`` forwards ``zero1``, ``grad_accum``,
    ``grad_norm_every``, ``dcn_axes``, ``dcn_quant`` and
    ``dcn_quant_bucket``. A mesh with sp > 1 runs the ring over its sp
    group (context parallel), each sp rank on its chunk of the sequence.
    Rules that shard params (the default table, or any other) run the
    model on this rank's blocks (gathers of the split dims, tp-local
    heads, MLP and vocabulary where the rules allow), with sp > 1 too."""
    dev = resolve_device(device)
    loss = _sp_loss(mesh, lambda p, tokens, targets, pos, sp, **kw: loss_fn(
        cfg, p, tokens, targets, positions=pos, sp_axis=sp,
        attn_impl=attn_impl, remat=remat, **kw))
    return make_train_step(
        mesh, loss=loss,
        init_fn=partial(init_params, cfg, device=dev),
        logical_axes=param_logical_axes(cfg), rules=rules,
        optimizer=optimizer, seed=seed, device=dev,
        unit_counts={"attn": (cfg.num_heads, cfg.num_kv_heads)},
        **step_options,
    )


def make_mixtral_train_step(
    cfg,
    mesh=None,
    rules: ShardingRules | None = None,
    optimizer: GradientTransformation | None = None,
    attn_impl: str = "flash",
    remat: bool | str = True,
    seed: int = 0,
    device: torch.device | str = "cuda",
    **step_options,
) -> tuple[Callable, Callable, Callable]:
    """Mixtral (``models.mixtral``) specialization of
    :func:`make_train_step`, as JAX's: expert weights shard over ``ep``
    under the default rules (each ep rank runs its own experts on the
    same tokens, its partial combine summed over ep; with the batch over
    ep too, ``rules.override(batch=("dp", "ep"))``, each ep rank routes
    its own tokens: the all-to-all dispatch of ``models.mixtral``). Over
    a mesh the routing spans the global batch (``mixtral.RoutingGroup``
    over the batch axes: the capacity, each claim's slot and the aux's
    statistics are the global batch's, or the global microbatch's under
    ``grad_accum``). A mesh with sp > 1 runs the ring over its sp group,
    each sp rank on its chunk of the sequence, the routing in JAX's token
    order. Under the explicit hierarchy (``dcn_axes``) JAX's step maps
    the loss over the slices, so each slice routes its own tokens: the
    routing spans the slice's batch axes only."""
    dev = resolve_device(device)
    routing = None
    if mesh is not None:
        sizes = axis_sizes(mesh)
        data_axes, _, ici, _, explicit_hier, _ = _data_domain(
            sizes, rules or ShardingRules(), step_options.get("dcn_axes"),
            step_options.get("zero1"), step_options.get("dcn_quant"))
        routing = mixtral.RoutingGroup.of_mesh(
            mesh, ici if explicit_hier else data_axes,
            sp=sizes.get("sp", 1) > 1)

    loss = _sp_loss(mesh, lambda p, tokens, targets, pos, sp, **kw:
                    mixtral.loss_fn(cfg, p, tokens, targets, positions=pos,
                                    sp_axis=sp, attn_impl=attn_impl,
                                    remat=remat, routing=routing, **kw))
    return make_train_step(
        mesh, loss=loss,
        init_fn=partial(mixtral.init_params, cfg, device=dev),
        logical_axes=mixtral.param_logical_axes(cfg), rules=rules,
        optimizer=optimizer, seed=seed, device=dev,
        unit_counts={"attn": (cfg.num_heads, cfg.num_kv_heads)},
        **step_options,
    )


def make_vit_train_step(
    cfg: vit.ViTConfig,
    mesh=None,
    rules: ShardingRules | None = None,
    optimizer: GradientTransformation | None = None,
    attn_impl: str = "flash",
    remat: bool | str = False,
    seed: int = 0,
    device: torch.device | str = "cuda",
    **step_options,
) -> tuple[Callable, Callable, Callable]:
    """ViT specialization of :func:`make_train_step`: the step takes
    ``(state, images, labels)``, images [B, H, W, C] floats in [0, 1] and
    labels [B] ints; the batch shards over the batch axes."""
    dev = resolve_device(device)
    return make_train_step(
        mesh,
        loss=lambda p, images, labels, param_shard=None: vit.loss_fn(
            cfg, p, images, labels, attn_impl=attn_impl, remat=remat,
            param_shard=param_shard),
        init_fn=partial(vit.init_params, cfg, device=dev),
        logical_axes=vit.param_logical_axes(cfg), rules=rules,
        optimizer=optimizer, seed=seed, device=dev,
        unit_counts={"attn": (cfg.num_heads,)}, **step_options,
    )
