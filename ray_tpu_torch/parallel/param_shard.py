"""Param sharding inside a model's forward: the gathers of split param
dims, the tensor-parallel (Megatron) conjugates and the expert-parallel
dispatch.

XLA inserts these collectives where a JAX program's shardings imply them
(``NamedSharding(mesh, rules.spec(*logical))`` on every param, the
default rule table putting ``embed`` on fsdp and ``heads``/``kv_heads``/
``mlp``/``vocab`` on tp), so the JAX package has no module to mirror; the
port calls them itself, from the model's forward. Any rule table JAX
takes runs: every axis on every param dim.

- Local units: a model computes a unit on this rank's shard of it when
  every dim the unit names splits over its axis alone: the attention's
  heads (``heads``, ``kv_heads``), the MLP's columns (``mlp``) and the
  vocabulary (``vocab``) over tp, while tp is not a batch axis; the
  experts (``expert``) over ep. Any other split dim (``embed`` over fsdp,
  ``classes`` over tp, a unit whose dims the rules split otherwise, the
  stacked ``layers`` dim, a dim over pp) is gathered where it is used.
- ``_Gather``: a leaf's block all-gathered over the group of a dim's mesh
  axes (``all_gather_into_tensor``) in the forward. The backward depends
  on the axes: over an axis whose ranks hold different rows (a batch
  axis, or sp, whose ranks hold different chunks of the sequence) the
  gradient is reduce-scattered (a sum), as FSDP does; over an axis whose
  ranks hold the same rows (tp, ep or pp used to split a dim the model
  does not compute locally) each rank takes its block of the gradient,
  which is the same on every such rank, and sums nothing. The models
  gather each layer's leaves inside that layer's remat segment, so a
  recompute gathers again and no layer's whole weights outlive their use.
- The stacked ``layers`` dim: :meth:`ParamShard.stacked` gathers each
  stacked leaf's layers dim once per forward, before the layer loop takes
  its per-layer views (the other alternative, one layer at a time from
  the rank that holds it, issues a broadcast per layer and leaf). The
  cost is memory: a leaf whose layers dim is split is whole over that
  dim from the forward's start to the backward's end, as a replicated
  leaf would be; its storage and its optimizer state stay split.
- ``_CopyTo``: identity forward, all-reduce over a group backward
  (Megatron's f): over tp on the normed activations before a
  column-parallel product, so that their gradient, and the norm
  weight's, is whole and the same on every tp rank; over ep on the
  inputs of a rank's own experts and on the gate values;
- ``_ReduceFrom``: all-reduce over a group forward, identity backward
  (Megatron's g): over tp after a row-parallel product and after the
  vocab-parallel embedding lookup; over ep after a rank's partial
  expert combine;
- ``_ScatterSum``: reduce-scatter forward, all-gather backward: the
  experts' inputs summed over ep into each rank's own experts when the
  batch splits over ep (the all-to-all dispatch, see ``models.mixtral``);
- ``ParamShard``: per leaf, which dims are gathered and over which groups,
  which are computed locally, and the tp and ep groups.

Axes of size 1 count: a one-rank mesh runs the same collectives on
one-rank groups.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    at_path,
    axes_group,
    axis_sizes,
    entry_axes,
    group_blocks,
    is_logical,
    tree_paths,
    tree_specs,
)

# The units a model computes on locally under tp, by the logical dims
# they name (its local heads, MLP columns or vocabulary rows).
TP_UNITS = {"attn": ("heads", "kv_heads"), "mlp": ("mlp",),
            "vocab": ("vocab",)}
# The one logical dim a model computes on locally under ep (its experts).
EP_LOGICAL = "expert"


def _dist():
    import torch.distributed as dist

    return dist


def _all_gather(x, dim, n, group, order):
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _dist().all_gather_into_tensor(out, x.contiguous(), group=group)
    out = out.view(n, *x.shape)
    if order is not None:
        out = out[order[0].to(out.device)]
    return out.movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(g, dim, n, group, order):
    parts = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
    if order is not None:
        parts = parts[order[1].to(parts.device)]
    parts = parts.contiguous()
    out = parts.new_empty(parts.shape[1:])
    _dist().reduce_scatter_tensor(out, parts.flatten(0, 1), group=group)
    return out


def _order(mesh, group, axes):
    """(group rank -> block, its inverse) for a dim split over ``axes``
    gathered over ``group``; None when the two orders agree."""
    blocks = group_blocks(mesh, group, axes)
    return None if blocks is None else (torch.as_tensor(blocks).argsort(),
                                        torch.as_tensor(blocks))


class DimGather(NamedTuple):
    """How one split dim is gathered: over ``group`` (every axis of the
    dim, ``n`` blocks, ``order`` as :func:`_order`); in the backward each
    axis of ``sizes`` whose ranks hold the same rows is cut at this
    rank's coordinate (``keep``; None for a batch axis), and the rest is
    reduce-scattered over ``data_group`` (``data_n`` blocks, ``data_order``;
    None when no batch axis splits the dim)."""
    n: int
    group: Any
    order: Any
    sizes: tuple
    keep: tuple
    data_n: int
    data_group: Any
    data_order: Any


def _gather_back(g, dim, spec: DimGather):
    """The gradient of a gathered dim -> this rank's block of it: summed
    over the batch axes of the dim, cut over the others."""
    parts = g.unflatten(dim, (*spec.sizes, -1))
    for i in reversed(range(len(spec.sizes))):
        if spec.keep[i] is not None:
            parts = parts.select(dim + i, spec.keep[i])
    part = parts.flatten(dim, dim + sum(k is None for k in spec.keep))
    if spec.data_group is None:
        return part.contiguous()
    return _reduce_scatter(part, dim, spec.data_n, spec.data_group,
                           spec.data_order)


class _Gather(torch.autograd.Function):
    """All-gather on ``dim`` forward; backward: ``_gather_back``."""

    @staticmethod
    def forward(ctx, x, dim, spec):
        ctx.meta = (dim, spec)
        return _all_gather(x, dim, spec.n, spec.group, spec.order)

    @staticmethod
    def backward(ctx, g):
        return _gather_back(g, *ctx.meta), None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter (sum) on ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, n, group, order):
        ctx.meta = (dim, n, group, order)
        return _reduce_scatter(x, dim, n, group, order)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.meta), None, None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        _dist().all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def check_layout(sizes: dict, logical_axes,
                 rules: ShardingRules) -> dict:
    """Per leaf path, its split dims as (dim, mesh axes). Every layout
    trains; raises only where JAX does: ``ValueError`` for a spec naming
    an axis the mesh lacks (a dim its axes do not divide raises when the
    params are cut, as ``jax.device_put`` does). Needs no process
    group."""
    specs = tree_specs(logical_axes, rules)
    out = {}
    for path, logical in tree_paths(logical_axes):
        if not is_logical(logical):
            raise TypeError(f"not a logical-axes leaf: {logical!r}")
        dims = []
        for dim, e in enumerate(at_path(specs, path)):
            axes = entry_axes(e)
            missing = [a for a in axes if a not in sizes]
            if missing:
                raise ValueError(
                    f"{'/'.join(path)}: spec names mesh axes {missing} not "
                    f"in the mesh {tuple(sizes)}")
            if axes:
                dims.append((dim, axes))
        out[path] = dims
    return out


def tp_indivisible(unit_counts: dict | None, tp_n: int) -> frozenset:
    """The tp units whose counts (``{"attn": (num_heads, num_kv_heads)}``,
    say) tp does not divide: they cannot be computed locally, so their
    split dims are gathered, as JAX computes them."""
    return frozenset(u for u, counts in (unit_counts or {}).items()
                     if any(int(n) % tp_n for n in counts))


def local_units(layout: dict, logical_axes, data_axes: tuple[str, ...],
                indivisible: frozenset = frozenset()) -> tuple[dict, bool]:
    """({tp unit: computed locally}, experts computed locally): a unit is
    local when every dim it names splits over its axis alone (and, for
    tp, tp is not a batch axis: tp ranks must hold the same rows, and tp
    divides the unit's counts: ``indivisible`` names those it does
    not)."""
    seen: dict[str, list] = {}
    for path, logical in tree_paths(logical_axes):
        split = dict(layout[path])
        for dim, name in enumerate(logical):
            seen.setdefault(name, []).append(split.get(dim, ()))

    def local(names, axis):
        found = [a for n in names for a in seen.get(n, [])]
        return bool(found) and all(a == (axis,) for a in found)

    tp = {u: u not in indivisible and "tp" not in data_axes
          and local(names, "tp") for u, names in TP_UNITS.items()}
    return tp, local((EP_LOGICAL,), "ep")


def split_dims(layout: dict, logical_axes, data_axes: tuple[str, ...],
               indivisible: frozenset = frozenset()) -> dict:
    """Per leaf path, (the dims the model gathers, the dims it computes
    on locally), each as (dim, mesh axes), from ``check_layout``'s
    ``layout``."""
    tp_local, ep_local = local_units(layout, logical_axes, data_axes,
                                     indivisible)
    unit_of = {n: u for u, names in TP_UNITS.items() for n in names}
    out = {}
    for path, logical in tree_paths(logical_axes):
        gathered, local = [], []
        for dim, axes in layout[path]:
            name = logical[dim]
            if axes == ("tp",) and tp_local.get(unit_of.get(name)) or \
                    axes == ("ep",) and name == EP_LOGICAL and ep_local:
                local.append((dim, axes))
            else:
                gathered.append((dim, axes))
        out[path] = (gathered, local)
    return out


class ParamShard:
    """A model's view of its sharded params over a mesh: per leaf path,
    the dims its forward gathers and the dims it computes on locally (see
    the module docstring), and the tp and ep groups. ``data_axes`` are
    the axes whose ranks hold different rows (the batch axes and sp);
    ``whole_dims`` ({path: dims}) names dims the caller hands the model
    whole, which it then neither gathers nor computes on locally;
    ``unit_counts`` ({tp unit: counts}, the model's head counts) makes a
    unit whose counts tp does not divide non-local (gathered)."""

    def __init__(self, mesh, logical_axes, rules: ShardingRules,
                 data_axes: tuple[str, ...], whole_dims: dict | None = None,
                 unit_counts: dict | None = None):
        from ray_tpu_torch.parallel.mesh import mesh_coords

        sizes = axis_sizes(mesh)
        coords = mesh_coords(mesh)
        whole_dims = whole_dims or {}
        layout = {p: [(d, a) for d, a in dims
                      if d not in whole_dims.get(p, ())]
                  for p, dims in check_layout(sizes, logical_axes,
                                              rules).items()}
        indivisible = tp_indivisible(unit_counts, sizes["tp"])
        self.tp_local, self.ep_local = local_units(layout, logical_axes,
                                                   data_axes, indivisible)
        self.data_axes = tuple(data_axes)
        # Experts over ep with the batch over ep too: each ep rank routes
        # its own tokens (models.mixtral's all-to-all dispatch).
        self.ep_dispatch = self.ep_local and "ep" in data_axes
        self.tp_n, self.tp_rank = sizes["tp"], coords["tp"]
        self.tp = mesh.get_group("tp")
        self.ep_n, self.ep_rank = sizes["ep"], coords["ep"]
        self.ep = mesh.get_group("ep")
        self.ep_order = _order(mesh, self.ep, ("ep",))
        self.gathers: dict[tuple, tuple] = {}
        self.local_dims: dict[tuple, tuple] = {}
        self.shard_axes: dict[tuple, tuple[str, ...]] = {}
        specs: dict = {}
        split = split_dims(layout, logical_axes, data_axes, indivisible)
        for path, logical in tree_paths(logical_axes):
            gathered, local = split[path]
            gathers = []
            for dim, axes in gathered:
                if axes not in specs:
                    specs[axes] = self._spec(mesh, sizes, coords, axes)
                gathers.append((dim, logical[dim] == "layers", specs[axes]))
            self.gathers[path] = tuple(gathers)
            self.local_dims[path] = tuple(
                (dim, self.tp_n, self.tp, None, True) if axes == ("tp",)
                else (dim, self.ep_n, self.ep, self.ep_order,
                      not self.ep_dispatch) for dim, axes in local)
            self.shard_axes[path] = tuple(a for _, axes in layout[path]
                                          for a in axes)

    def _spec(self, mesh, sizes, coords, axes) -> DimGather:
        """The groups of a dim split over ``axes`` (collective the first
        time: every rank builds them in one order)."""
        group = axes_group(mesh, axes)
        data = tuple(a for a in axes if a in self.data_axes)
        data_group = axes_group(mesh, data) if data else None
        return DimGather(
            math.prod(sizes[a] for a in axes), group,
            _order(mesh, group, axes), tuple(sizes[a] for a in axes),
            tuple(None if a in self.data_axes else coords[a] for a in axes),
            math.prod(sizes[a] for a in data), data_group,
            _order(mesh, data_group, data) if data else None)

    # -- gathers -----------------------------------------------------------

    def full(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``path``'s block ``t`` gathered on every dim the model
        does not compute on locally."""
        for dim, _, spec in self.gathers[path]:
            t = _Gather.apply(t, dim, spec)
        return t

    def local_full(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """``t``, a gradient block of leaf ``path``, gathered (no
        gradient) over the local dims whose ranks hold the same rows (tp,
        ep without the batch over it): there each rank's block is whole,
        summed over nothing."""
        with torch.no_grad():
            for dim, n, group, order, same_rows in self.local_dims[path]:
                if same_rows:
                    t = _all_gather(t, dim, n, group, order)
        return t

    def whole(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``path``'s block ``t`` gathered over every axis, tp and ep
        too (no gradient)."""
        with torch.no_grad():
            t = self.full(path, t)
            for dim, n, group, order, _ in self.local_dims[path]:
                t = _all_gather(t, dim, n, group, order)
        return t

    def stacked(self, params: dict) -> dict:
        """``params`` with the layers dim of each stacked leaf gathered
        (the module docstring says why once per forward)."""
        layers = {}
        for name, t in params["layers"].items():
            for dim, is_layers, spec in self.gathers[("layers", name)]:
                if is_layers:
                    t = _Gather.apply(t, dim, spec)
            layers[name] = t
        return {**params, "layers": layers}

    def layer(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """One layer's slice of the stacked leaf ``layers/name`` (from
        :meth:`stacked`), gathered (its dims are the leaf's less the
        leading layers dim)."""
        for dim, is_layers, spec in self.gathers[("layers", name)]:
            if not is_layers:
                t = _Gather.apply(t, dim - 1, spec)
        return t

    # -- tensor parallel -----------------------------------------------------

    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyTo.apply(x, self.tp)

    def reduce_from_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFrom.apply(x, self.tp)

    def tp_in(self, x: torch.Tensor, unit: str) -> torch.Tensor:
        """``x`` entering ``unit``'s column-parallel products: the
        conjugate whose backward sums over tp, where the unit is local."""
        return self.copy_to_tp(x) if self.tp_local[unit] else x

    def tp_out(self, y: torch.Tensor, unit: str) -> torch.Tensor:
        """``unit``'s row-parallel partial sums, summed over tp where the
        unit is local."""
        return self.reduce_from_tp(y) if self.tp_local[unit] else y

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits [..., V / tp] of a vocabulary-parallel head -> [..., V]:
        all-gathered over tp forward, this rank's columns of the
        gradient backward (the tp ranks hold the same rows)."""
        if not self.tp_local["vocab"]:
            return logits
        spec = DimGather(self.tp_n, self.tp, None, (self.tp_n,),
                         (self.tp_rank,), 1, None, None)
        return _Gather.apply(logits, logits.dim() - 1, spec)

    # -- expert parallel -----------------------------------------------------

    def copy_to_ep(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyTo.apply(x, self.ep)

    def reduce_from_ep(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFrom.apply(x, self.ep)

    def scatter_experts(self, x: torch.Tensor) -> torch.Tensor:
        """[E, ...] summed over ep into this rank's experts [E / ep, ...]
        (all-gather backward)."""
        return _ScatterSum.apply(x, 0, self.ep_n, self.ep, self.ep_order)

    def gather_experts(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's experts [E / ep, ...] -> every expert [E, ...]
        (reduce-scatter, a sum, backward)."""
        spec = DimGather(self.ep_n, self.ep, self.ep_order, (self.ep_n,),
                         (None,), self.ep_n, self.ep, self.ep_order)
        return _Gather.apply(x, 0, spec)

    def local(self, n: int, what: str, unit: str) -> int:
        """This rank's share of ``n`` (heads, say) in ``unit``: n / tp
        where the unit is local, else n (a unit whose counts tp does not
        divide is never local when its counts were given)."""
        if not self.tp_local[unit]:
            return n
        if n % self.tp_n:
            raise ValueError(
                f"{n} {what} do not split over tp={self.tp_n} ranks: give "
                f"ParamShard unit_counts={{{unit!r}: ...}} so the unit is "
                f"gathered")
        return n // self.tp_n

    def embed(self, tokens: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
        """The rows of ``tokens`` from the embedding table, this rank's
        block ``table`` gathered on its non-local dims: vocabulary-
        parallel where the vocab unit is local (this rank's rows looked
        up where a token falls in them, zeros elsewhere, summed over tp),
        else a plain lookup."""
        table = self.full(("embed_tokens",), table)
        if not self.tp_local["vocab"]:
            return torch.nn.functional.embedding(tokens, table)
        v = table.shape[0]
        local = tokens.long() - self.tp_rank * v
        inside = (local >= 0) & (local < v)
        rows = torch.nn.functional.embedding(local.clamp(0, v - 1), table)
        rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
        return self.reduce_from_tp(rows)

    def vocab_parallel(self, head: torch.Tensor) -> dict:
        """The fused loss's vocabulary-parallel keywords for ``head``
        [H, V / tp] where the vocab unit is local, else none."""
        if not self.tp_local["vocab"]:
            return {}
        return {"tp_group": self.tp,
                "vocab_start": self.tp_rank * head.shape[1]}


def layer_weights(ps: ParamShard | None, lp: dict, *names: str) -> list:
    """One layer's leaves ``names`` from its slices ``lp``, gathered where
    the rules shard them (as stored when ``ps`` is None)."""
    if ps is None:
        return [lp[n] for n in names]
    return [ps.layer(n, lp[n]) for n in names]


def stacked_layers(ps: ParamShard | None, params: dict) -> dict:
    """``params`` as the layer loop takes them: the stacked leaves'
    layers dim gathered where the rules split it."""
    return params if ps is None else ps.stacked(params)
