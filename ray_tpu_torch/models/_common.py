"""Helpers that the model families share: remat segments and per-layer
views of stacked layer params."""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def ckpt(fn, *args):
    """``fn(*args)`` as a remat segment: its activations are recomputed in
    the backward instead of saved."""
    return checkpoint(fn, *args, use_reentrant=False)


def layer_params(params: dict) -> list[dict]:
    """Per-layer views of the stacked ``[L, ...]`` leaves. One ``unbind``
    per leaf, so the backward stacks the layer gradients once."""
    names = list(params["layers"])
    per_leaf = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]
