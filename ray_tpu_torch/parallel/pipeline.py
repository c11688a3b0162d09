"""Pipeline parallelism: GPipe over the mesh's ``pp`` axis.

Port of ray_tpu/parallel/pipeline.py. The JAX package runs the whole
pipeline as one SPMD program: a ``lax.scan`` over M + P - 1 ticks, stage
0 injecting microbatch ``min(t, M - 1)``, the last stage taking the loss
of microbatch ``t - (P - 1)``, activations handed on by ``lax.ppermute``,
and autodiff through the scan giving the reverse schedule. Here each
stage is a rank of the ``pp`` group, and the step runs that schedule
itself: the forward of the M microbatches in order, each stage receiving
its input from stage k - 1 and sending its output to stage k + 1, then
the backward in reverse order, each stage receiving dy from k + 1 and
sending dx to k - 1. Every send meets its receive in the same order on
both ranks, so no two stages wait on each other. The bubble ticks of the
JAX schedule compute masked garbage (``0 * finite``: x0 is zeros); the
port skips them, which changes no number.

Semantics kept from the reference:

- the layer leaves split over pp on their stacked dim (stage k holds
  layers ``[k L/P, (k+1) L/P)``, the rows JAX's addressable shard on the
  device of pp index k holds); ``embed_tokens``, ``final_norm`` and
  ``lm_head`` are whole on every rank;
- the batch splits over ``dp`` alone and is whole over pp (stage 0 reads
  the tokens, the last stage the targets);
- the last stage's head is not fused with its loss: f32 logits (the
  head product accumulated in f32) and a full ``log_softmax``;
- each microbatch's loss is ``nll_sum / (tokens.size * dp)``, the global
  token count, so a layer gradient is summed over dp and a shared
  param's over (dp, pp): ``embed_tokens`` gets stage 0's lookup gradient
  plus, tied, the last stage's head gradient;
- ``grad_norm`` is the whole reduced tree's (``optax.global_norm``): the
  layer leaves' squares summed over pp, each shared param once;
- the default optimizer is JAX's, ``adamw(3e-4, weight_decay=0.1)``,
  moments in the params' dtype; layers run with no remat.

The mesh names ``pp`` (which may be 1) and optionally ``dp`` and any
other axis. JAX's ``shard_map`` names only pp and dp and so replicates
the work over any other (fsdp, tp, sp, ep): its params are ``P("pp")`` or
replicated and its batch ``P("dp")``, so the ranks along another axis
run the same stage on the same rows. The port does the same: each
coordinate of the other axes is a replica pipeline whose sends, receives
and sums (the pp, dp and shared-param groups) stay within it.

``make_pp_train_step`` returns ``(step_fn, init_state, data_sharder)``
as ``train.spmd.make_train_step`` does; ``state.checkpoint_tree()``
saves each stage's rows as blocks of the whole leaves, so a pipeline
state restores at another mesh, or with none.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device, tree_map
from ray_tpu_torch.models._common import layer_params
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    _layer,
    init_params,
    param_logical_axes,
)
from ray_tpu_torch.ops.loss import logits_f32
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rope_cos_sin, rope_frequencies
from ray_tpu_torch.parallel.mesh import mesh_coords
from ray_tpu_torch.parallel.sharding import (
    at_path,
    axes_group,
    axis_sizes,
    tree_paths,
)
from ray_tpu_torch.train.optim import (
    GradientTransformation,
    adamw,
    apply_updates,
)
from ray_tpu_torch.train.spmd import TrainState, _block_of, _Piece

PIPELINE_AXES = ("pp", "dp")


def pp_param_shardings(cfg: LlamaConfig, mesh) -> dict:
    """Per param leaf, its spec over ``mesh``: the layer leaves split over
    ``pp`` on the stacked-layer dim, the embedding, final norm and head
    replicated. A placement of the pipeline's own: the rules step takes
    ``layers`` on pp too, but gathers the layers there (every rank runs
    every layer)."""
    pp = axis_sizes(mesh).get("pp")
    if pp is None:
        raise ValueError("the mesh has no pp axis")
    if cfg.num_layers % pp:
        raise ValueError(f"{cfg.num_layers} layers do not split over "
                         f"pp={pp} stages")
    return {k: ({n: ("pp",) for n in v} if k == "layers" else ())
            for k, v in param_logical_axes(cfg).items()}


def _stage_nll(cfg: LlamaConfig, params: dict, x: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """The last stage's summed NLL of one microbatch: final norm, f32
    logits, a full log_softmax (JAX's unfused head)."""
    xn = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed_tokens"].t() if cfg.tie_embeddings \
        else params["lm_head"]
    logp = torch.log_softmax(logits_f32(xn, head), dim=-1)
    return -logp.gather(-1, targets[..., None]).sum()


def make_pp_train_step(
    cfg: LlamaConfig,
    mesh,
    num_microbatches: int,
    optimizer: GradientTransformation | None = None,
    attn_impl: str = "blockwise",
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> tuple[Callable, Callable, Callable]:
    """The GPipe train-step factory (see the module docstring). ``mesh``
    is a ``parallel.mesh`` DeviceMesh with process groups; every rank of
    it calls ``init_state`` and ``step_fn``, in the same order."""
    import torch.distributed as dist

    dev = resolve_device(device)
    sizes = axis_sizes(mesh)
    specs = pp_param_shardings(cfg, mesh)
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh of {mesh.device_type} ranks, step on {dev}")
    try:
        pp_group, dp_group = mesh.get_group("pp"), mesh.get_group("dp")
    except RuntimeError as e:
        raise ValueError(
            "the mesh has no process groups (single_device_mesh()); build "
            "it after train.backend.init_distributed") from e
    coords = mesh_coords(mesh)
    if coords is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    n_pp, n_dp = sizes["pp"], sizes.get("dp", 1)
    m_count = int(num_microbatches)
    stage, rows_of = coords["pp"], cfg.num_layers // n_pp
    first, last = stage == 0, stage == n_pp - 1
    optimizer = optimizer or adamw(3e-4, weight_decay=0.1)
    shared_group = axes_group(mesh, PIPELINE_AXES)
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.cpu().numpy()

    def rank_of(k: int) -> int:
        """The global rank of stage ``k`` with this rank's coordinates on
        every other axis (its replica pipeline)."""
        idx = [coords[a] for a in names]
        idx[names.index("pp")] = k
        return int(ranks[tuple(idx)])

    prev_rank = None if first else rank_of(stage - 1)
    next_rank = None if last else rank_of(stage + 1)

    def init_state(params: dict | None = None) -> TrainState:
        """This stage's rows of ``params`` (default: ``init_params`` of
        ``seed``; every rank must pass the same whole tree)."""
        if params is None:
            params = init_params(cfg, seed, device=dev)

        def cut(path, t):
            t = t.detach()
            if path[0] == "layers":
                t = t[stage * rows_of:(stage + 1) * rows_of]
            return t.to(dev, copy=True).contiguous().requires_grad_(True)

        whole = {path: tuple(t.shape) for path, t in tree_paths(params)}
        local = {k: ({n: cut((k, n), x) for n, x in v.items()}
                     if isinstance(v, dict) else cut((k,), v))
                 for k, v in params.items()}
        layout = {path: _Piece(p.numel(), 0, p.numel(), False,
                               block=_block_of(path, whole[path],
                                               at_path(specs, path), mesh))
                  for path, p in tree_paths(local)}
        with torch.no_grad():
            opt_state = optimizer.init(local)
        return TrainState(params=local, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          host_step=0, layout=layout)

    def step_fn(state: TrainState, tokens: torch.Tensor,
                targets: torch.Tensor):
        params = state.params
        b, s = tokens.shape
        if b % m_count:
            raise ValueError(f"this rank's {b} rows do not split into "
                             f"{m_count} microbatches")
        mb = b // m_count
        total = b * s * n_dp  # the global token count
        tok = tokens.long().view(m_count, mb, s)
        tgt = targets.long().view(m_count, mb, s)
        inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                    cfg.rope_scaling, device=dev)
        cos, sin = rope_cos_sin(torch.arange(s, device=dev), inv_freq)
        act = (mb, s, cfg.hidden_size)
        dt = params["embed_tokens"].dtype
        ins, outs = [], []
        for m in range(m_count):  # forward, microbatches in order
            if first:
                x = x_in = F.embedding(tok[m], params["embed_tokens"])
            else:
                x_in = torch.empty(act, dtype=dt, device=dev)
                dist.recv(x_in, prev_rank, group=pp_group)
                x = x_in.requires_grad_(True)
            for lp in layer_params(params):
                x = _layer(cfg, x, lp, cos, sin, attn_impl, None)
            if last:
                x = _stage_nll(cfg, params, x, tgt[m]) / total
            else:
                dist.send(x.detach(), next_rank, group=pp_group)
            ins.append(x_in)
            outs.append(x)
        loss = torch.stack([o.detach() for o in outs]).sum() if last \
            else torch.zeros((), dtype=torch.float32, device=dev)
        for m in reversed(range(m_count)):  # backward, in reverse
            dy = None
            if not last:
                dy = torch.empty(act, dtype=dt, device=dev)
                dist.recv(dy, next_rank, group=pp_group)
            torch.autograd.backward(outs[m], dy)
            if not first:
                dist.send(ins[m].grad, prev_rank, group=pp_group)
            ins[m] = outs[m] = None
        with torch.no_grad():
            dist.all_reduce(loss, group=shared_group)
            sq_layers, sq_shared = [], []
            for path, p in tree_paths(params):
                if p.grad is None:  # a shared param this stage never used
                    p.grad = torch.zeros_like(p)
                is_layer = path[0] == "layers"
                dist.all_reduce(p.grad, group=dp_group if is_layer
                                else shared_group)
                (sq_layers if is_layer else sq_shared).append(
                    p.grad.float().square().sum())
            sq = torch.stack(sq_layers).sum()
            dist.all_reduce(sq, group=pp_group)
            gnorm = (sq + torch.stack(sq_shared).sum()).sqrt()
            grads = tree_map(lambda p: p.grad, params)
            updates, _ = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
            state.step.add_(1)
        if state.host_step is not None:
            state.host_step += 1
        for _, p in tree_paths(params):
            p.grad = None
        return state, {"loss": loss, "grad_norm": gnorm}

    def data_sharder(arr) -> torch.Tensor:
        b = arr.shape[0]
        if b % n_dp:
            raise ValueError(f"batch {b} not divisible by dp={n_dp}")
        rows = b // n_dp
        arr = arr[coords["dp"] * rows:(coords["dp"] + 1) * rows]
        if isinstance(arr, torch.Tensor):
            return arr.to(dev)
        return torch.as_tensor(np.asarray(arr), device=dev)

    return step_fn, init_state, data_sharder
