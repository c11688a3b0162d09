"""Train-step factory: loss + init + optimizer -> one training step.

Port of the single-device subset of ray_tpu/train/spmd.py. The JAX factory
jits one step over a mesh and donates the state; here the step runs
eagerly on one device and updates the state in place (params, moments and
the step counter are overwritten, as donated JAX buffers are). The
multi-device options (``zero1``, ``grad_accum > 1``, ``dcn_axes``,
``dcn_quant``) raise ``NotImplementedError``: they need torch.distributed.

Returns (step_fn, init_state, data_sharder), as the JAX factory does:

- ``init_state(params=None)`` -> TrainState: params from ``init_fn(seed)``,
  or a copy of the given tree (e.g. ``params_from_jax`` of a JAX tree) on
  the step's device;
- ``step_fn(state, tokens, targets)`` -> (state, {"loss", "grad_norm"}),
  metrics as device scalars (no host sync); grad_norm is the global L2
  norm of the gradients (``optax.global_norm``), summed in f32;
- ``data_sharder(host_array)`` -> a tensor on the step's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device, tree_leaves, tree_map
from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
from ray_tpu_torch.train.optim import (
    GradientTransformation,
    adamw,
    apply_updates,
)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 scalar on the device


def _not_ported(**opts) -> None:
    on = [k for k, v in opts.items() if v]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: multi-device training is not ported yet "
            f"(it needs torch.distributed); the port trains on one device")


def make_train_step(
    *,
    loss: Callable,          # loss(params, tokens, targets) -> scalar
    init_fn: Callable,       # init_fn(seed) -> params tree
    optimizer: GradientTransformation | None = None,
    seed: int = 0,
    device: torch.device | str = "cuda",
    zero1: bool = False,
    grad_accum: int = 1,
    dcn_axes: tuple[str, ...] = (),
    dcn_quant: str | None = None,
) -> tuple[Callable, Callable, Callable]:
    """Model-agnostic single-device step factory (see the module
    docstring)."""
    _not_ported(zero1=zero1, grad_accum=int(grad_accum) > 1,
                dcn_axes=tuple(dcn_axes),
                dcn_quant=dcn_quant not in (None, "", "none"))
    dev = resolve_device(device)
    optimizer = optimizer or adamw(3e-4, weight_decay=0.1,
                                   mu_dtype=torch.bfloat16)

    def init_state(params: dict | None = None) -> TrainState:
        if params is None:
            params = init_fn(seed)
        params = tree_map(
            lambda t: t.detach().to(dev, copy=True).requires_grad_(True),
            params)
        with torch.no_grad():
            opt_state = optimizer.init(params)
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    def step_fn(state: TrainState, tokens, targets):
        params = state.params
        leaves = tree_leaves(params)
        loss_val = loss(params, tokens, targets)
        loss_val.backward()
        with torch.no_grad():
            grads = tree_map(lambda p: p.grad, params)
            gnorm = torch.stack([p.grad.float().square().sum()
                                 for p in leaves]).sum().sqrt()
            updates, _ = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
            state.step.add_(1)
        for p in leaves:
            p.grad = None
        return state, {"loss": loss_val.detach(), "grad_norm": gnorm}

    def data_sharder(arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(dev)
        return torch.as_tensor(np.asarray(arr), device=dev)

    return step_fn, init_state, data_sharder


def make_llama_train_step(
    cfg: LlamaConfig,
    optimizer: GradientTransformation | None = None,
    attn_impl: str = "flash",
    remat: bool | str | tuple = True,
    seed: int = 0,
    device: torch.device | str = "cuda",
    **step_options,
) -> tuple[Callable, Callable, Callable]:
    """Llama specialization of :func:`make_train_step`. ``remat`` takes a
    single policy or a per-layer spec (models/llama.normalize_remat);
    ``step_options`` forwards the multi-device options (which raise)."""
    dev = resolve_device(device)
    return make_train_step(
        loss=lambda p, tokens, targets: loss_fn(
            cfg, p, tokens, targets, attn_impl=attn_impl, remat=remat),
        init_fn=partial(init_params, cfg, device=dev),
        optimizer=optimizer, seed=seed, device=dev, **step_options,
    )
