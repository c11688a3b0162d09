"""Param sharding inside a model's forward: the FSDP gathers and the
tensor-parallel (Megatron) conjugates.

XLA inserts these collectives where a JAX program's shardings imply them
(``NamedSharding(mesh, rules.spec(*logical))`` on every param, the
default rule table putting ``embed`` on fsdp and ``heads``/``kv_heads``/
``mlp``/``vocab`` on tp), so the JAX package has no module to mirror; the
port calls them itself, from the model's forward:

- ``_Gather``: a leaf's block all-gathered over the group of a dim's mesh
  axes (``all_gather_into_tensor``) in the forward; the gradient
  reduce-scattered back (``reduce_scatter_tensor``, a sum) in the
  backward. The models gather each layer's leaves inside that layer's
  remat segment, so a recompute gathers again and no layer's whole
  weights outlive their use;
- ``_CopyTo``: identity forward, all-reduce over a group backward
  (Megatron's f): over tp on the normed activations before a
  column-parallel product, so that their gradient, and the norm
  weight's, is whole and the same on every tp rank; over ep on the
  inputs of a rank's own experts and on the gate values;
- ``_ReduceFrom``: all-reduce over a group forward, identity backward
  (Megatron's g): over tp after a row-parallel product and after the
  vocab-parallel embedding lookup; over ep after a rank's partial
  expert combine;
- ``ParamShard``: per leaf, which dims are gathered and over which groups
  (every sharded mesh axis but tp and ep), and the tp and ep groups the
  models compute their local heads, MLP columns, vocabulary rows and
  experts over.

Axes of size 1 count: a one-rank mesh runs the same collectives on
one-rank groups.
"""

from __future__ import annotations

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

# Logical dims a model computes on locally under tp (its local heads, MLP
# columns or vocabulary rows); any other dim on tp is refused.
TP_LOGICAL = ("heads", "kv_heads", "mlp", "vocab")
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


class _Gather(torch.autograd.Function):
    """All-gather on ``dim`` forward, reduce-scatter (sum) backward."""

    @staticmethod
    def forward(ctx, x, dim, n, group, order):
        ctx.meta = (dim, n, group, order)
        return _all_gather(x, dim, n, group, order)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.meta), None, None, None, None


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


def check_layout(sizes: dict, logical_axes, rules: ShardingRules,
                 gather_axes: tuple[str, ...]) -> dict:
    """Per leaf path, its split dims as (dim, mesh axes); raises
    ``NotImplementedError`` for a layout the models cannot compute on (see
    :class:`ParamShard`). Needs no process group."""
    specs = tree_specs(logical_axes, rules)
    out = {}
    for path, logical in tree_paths(logical_axes):
        if not is_logical(logical):
            raise TypeError(f"not a logical-axes leaf: {logical!r}")
        name = "/".join(path)
        spec = at_path(specs, path)
        dims = []
        for dim, e in enumerate(spec):
            axes = entry_axes(e)
            if not axes:
                continue
            if logical[dim] == "layers":
                raise NotImplementedError(
                    f"{name}: the rules shard the stacked layers dim over "
                    f"{axes}; pipeline stages are "
                    f"parallel.pipeline.make_pp_train_step's own "
                    f"placement, not a rule of this step")
            if "tp" in axes and (len(axes) > 1
                                 or logical[dim] not in TP_LOGICAL):
                raise NotImplementedError(
                    f"{name}: tp on dim {dim} ({logical[dim]!r}, axes "
                    f"{axes}) is not ported: the models compute locally "
                    f"only on {TP_LOGICAL}, each over tp alone")
            if "ep" in axes and (axes != ("ep",)
                                 or logical[dim] != EP_LOGICAL):
                raise NotImplementedError(
                    f"{name}: ep on dim {dim} ({logical[dim]!r}, axes "
                    f"{axes}) is not ported: a model computes locally "
                    f"only on {EP_LOGICAL!r}, over ep alone")
            if axes == ("ep",) and "ep" in gather_axes \
                    and sizes["ep"] > 1:
                raise NotImplementedError(
                    f"{name}: experts over ep while the batch splits over "
                    f"ep too (an all-to-all dispatch) is not ported: ep "
                    f"ranks must hold the same tokens")
            bad = [a for a in axes if a not in ("tp", "ep")
                   and a not in gather_axes and sizes[a] > 1]
            if bad:
                raise NotImplementedError(
                    f"{name}: dim {dim} split over {bad}, not a "
                    f"data-parallel axis ({gather_axes}), is not ported: "
                    f"its gradient would sum over ranks that hold the same "
                    f"rows")
            dims.append((dim, axes))
        out[path] = dims
    return out


class ParamShard:
    """A model's view of its sharded params over a mesh: per leaf path,
    the dims its forward gathers (every axis but tp and ep, each in the
    data axes ``gather_axes`` or of size 1), and the tp and ep groups it
    computes its local shards over. Raises ``NotImplementedError`` for a
    layout the models cannot compute on: tp on a dim other than
    :data:`TP_LOGICAL`'s, ep on another than :data:`EP_LOGICAL`, either
    together with another axis on one dim, the stacked ``layers`` dim
    sharded, a param dim split over a non-data axis of size > 1."""

    def __init__(self, mesh, logical_axes, rules: ShardingRules,
                 gather_axes: tuple[str, ...]):
        from ray_tpu_torch.parallel.mesh import mesh_coords

        sizes = axis_sizes(mesh)
        coords = mesh_coords(mesh)
        layout = check_layout(sizes, logical_axes, rules, gather_axes)
        self.tp_n, self.tp_rank = sizes["tp"], coords["tp"]
        self.tp = mesh.get_group("tp")
        self.ep_n, self.ep_rank = sizes["ep"], coords["ep"]
        self.ep = mesh.get_group("ep")
        self.gathers: dict[tuple, tuple] = {}
        self.local_dims: dict[tuple, tuple] = {}
        self.shard_axes: dict[tuple, tuple[str, ...]] = {}
        for path, dims in layout.items():
            gathers, used, local = [], [], []
            for dim, axes in dims:
                used.extend(axes)
                if axes == ("tp",):
                    local.append((dim, self.tp_n, self.tp))
                    continue
                if axes == ("ep",):
                    local.append((dim, self.ep_n, self.ep))
                    continue
                n = 1
                for a in axes:
                    n *= sizes[a]
                group = axes_group(mesh, axes)
                blocks = group_blocks(mesh, group, axes)
                order = None if blocks is None else (
                    torch.as_tensor(blocks).argsort(),
                    torch.as_tensor(blocks))
                gathers.append((dim, n, group, order))
            self.gathers[path] = tuple(gathers)
            self.local_dims[path] = tuple(local)
            self.shard_axes[path] = tuple(used)

    # -- gathers -----------------------------------------------------------

    def full(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``path``'s block ``t`` gathered over every axis but tp."""
        for dim, n, group, order in self.gathers[path]:
            t = _Gather.apply(t, dim, n, group, order)
        return t

    def local_full(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """``t``, a block of leaf ``path`` or its gradient, gathered over
        tp and ep on the leaf's local dims (no gradient)."""
        with torch.no_grad():
            for dim, n, group in self.local_dims[path]:
                t = _all_gather(t, dim, n, group, None)
        return t

    def whole(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``path``'s block ``t`` gathered over every axis, tp and ep
        too (no gradient)."""
        with torch.no_grad():
            return self.local_full(path, self.full(path, t))

    def layer(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """One layer's slice of the stacked leaf ``layers/name``,
        gathered (its dims are the leaf's less the leading layers dim)."""
        for dim, n, group, order in self.gathers[("layers", name)]:
            t = _Gather.apply(t, dim - 1, n, group, order)
        return t

    # -- tensor parallel -----------------------------------------------------

    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyTo.apply(x, self.tp)

    def reduce_from_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFrom.apply(x, self.tp)

    # -- expert parallel -----------------------------------------------------

    def copy_to_ep(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyTo.apply(x, self.ep)

    def reduce_from_ep(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFrom.apply(x, self.ep)

    def local(self, n: int, what: str) -> int:
        """This tp rank's share of ``n`` (heads, say); raises where tp
        does not divide it."""
        if n % self.tp_n:
            raise NotImplementedError(
                f"{n} {what} do not split over tp={self.tp_n} ranks")
        return n // self.tp_n

    def vocab_embed(self, tokens: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
        """The rows of ``tokens`` from a vocabulary-parallel table: this
        rank's rows ``table`` [V / tp, H] (already gathered over fsdp)
        looked up where a token falls in them, zeros elsewhere, summed
        over tp."""
        v = table.shape[0]
        local = tokens.long() - self.tp_rank * v
        inside = (local >= 0) & (local < v)
        rows = torch.nn.functional.embedding(local.clamp(0, v - 1), table)
        rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
        return self.reduce_from_tp(rows)



def layer_weights(ps: ParamShard | None, lp: dict, *names: str) -> list:
    """One layer's leaves ``names`` from its slices ``lp``, gathered where
    the rules shard them (as stored when ``ps`` is None)."""
    if ps is None:
        return [lp[n] for n in names]
    return [ps.layer(n, lp[n]) for n in names]
