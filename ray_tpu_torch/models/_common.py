"""Helpers that the model families share: remat segments and per-layer
views of stacked layer params."""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# The matrix products a "dots" segment keeps (JAX's ``checkpoint_dots``
# saves every dot_general's output). ``@``, ``einsum`` and ``matmul``
# reach the dispatcher as these.
_PRODUCTS = frozenset((torch.ops.aten.mm, torch.ops.aten.bmm,
                       torch.ops.aten.addmm, torch.ops.aten.baddbmm))


def ckpt(fn, *args):
    """``fn(*args)`` as a remat segment: its activations are recomputed in
    the backward instead of saved."""
    return checkpoint(fn, *args, use_reentrant=False)


def _keep_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def ckpt_dots(fn, *args):
    """``fn(*args)`` as a remat segment that keeps every matrix product's
    output and recomputes the rest (norms, rope, activations, adds). A
    CUDA kernel launched from an ``autograd.Function`` is no dispatcher
    op, so the policy cannot keep its outputs: inside a segment it re-runs
    in the backward (the models keep the flash kernels outside every
    segment)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=partial(create_selective_checkpoint_contexts,
                                         _keep_products))


def layer_params(params: dict) -> list[dict]:
    """Per-layer views of the stacked ``[L, ...]`` leaves. One ``unbind``
    per leaf, so the backward stacks the layer gradients once."""
    names = list(params["layers"])
    per_leaf = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]
