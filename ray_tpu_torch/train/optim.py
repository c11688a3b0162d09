"""Optimizers of the training step, in optax's shape.

Port of ray_tpu/train/optim.py and of the default ``optax.adamw`` that
ray_tpu/train/spmd.py builds. A ``GradientTransformation`` is an
``(init, update)`` pair over param trees (nested dicts of tensors), and
``chain`` composes them in order, as optax does:

- ``adamw(lr, ..., mu_dtype)``: optax's ``scale_by_adam`` (mu stored in
  ``mu_dtype``, nu in the param dtype, arithmetic in the dtypes JAX's
  promotion gives) -> ``add_decayed_weights`` -> ``scale_by_learning_rate``;
- ``adamw_lowmem(lr, ...)``: ``scale_by_adam_compact`` (both moments
  stored in ``moment_dtype``, default bf16, all update math in f32) ->
  decoupled weight decay -> ``-lr`` scale;
- ``adam(lr, b1, b2, eps)``: optax.adam, ``scale_by_adam`` ->
  ``scale_by_learning_rate`` (the RL learners' optimizer);
- ``sgd(lr)``: optax.sgd without momentum, ``scale_by_learning_rate`` in
  a chain;
- ``clip_by_global_norm(max_norm)``: optax's, for a chain before adam
  (Dreamer's optimizer).

State is updated in place: ``update`` writes the new moments and count
into the tensors of the state it was given and returns that same state,
as the JAX step donates its state buffers. ``apply_updates`` writes the
new params into the param tensors. bf16 elementwise arithmetic rounds at
other points than XLA's fused bf16 arithmetic; the f32 paths agree to
rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ray_tpu_torch._device import tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (updates, state, params) -> (updates, state)


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: dict
    nu: dict


class ScaleByAdamCompactState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict


def _count_like(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16}


def _weak(c: float, t: torch.Tensor) -> float:
    """A Python scalar as JAX applies it to ``t``: rounded to t's dtype
    first (a weakly typed scalar takes the array's dtype). Rounds on the
    host without making a tensor where numpy has the dtype."""
    if t.dtype in _NP_FLOAT:
        return float(_NP_FLOAT[t.dtype](c))
    return float(torch.tensor(c, dtype=t.dtype))


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in f32 (optax computes it in f32 before any cast).
    The base is filled on count's device: a tensor copied from the host
    there would wait for the device."""
    return 1.0 - torch.pow(torch.full((), decay, dtype=torch.float32,
                                      device=count.device), count.float())


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  mu_dtype: torch.dtype | None = None
                  ) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0, no nesterov)."""

    def init_fn(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or
                                                   p.dtype), params)
        nu = tree_map(torch.zeros_like, params)
        return ScaleByAdamState(count=_count_like(params), mu=mu, nu=nu)

    def update_fn(updates, state, params=None):
        state.count.add_(1)
        bc1 = _bias_correction(b1, state.count)
        bc2 = _bias_correction(b2, state.count)

        def leaf(g, m, v):
            m_new = _weak(1 - b1, g) * g + _weak(b1, m) * m
            v_new = _weak(1 - b2, g) * (g * g) + _weak(b2, v) * v
            m_hat = m_new / bc1.to(m_new.dtype)
            v_hat = v_new / bc2.to(v_new.dtype)
            m.copy_(m_new)  # cast to mu_dtype for storage
            v.copy_(v_new)
            v_root = torch.sqrt(v_hat)
            return m_hat / (v_root + _weak(eps, v_root))

        return tree_map(leaf, updates, state.mu, state.nu), state

    return GradientTransformation(init_fn, update_fn)


def scale_by_adam_compact(b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8,
                          moment_dtype: torch.dtype = torch.bfloat16
                          ) -> GradientTransformation:
    """Adam scaling with BOTH moments stored in ``moment_dtype``; all
    arithmetic in f32, only the storage is compact."""

    def init_fn(params):
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return ScaleByAdamCompactState(count=_count_like(params),
                                       mu=tree_map(zeros, params),
                                       nu=tree_map(zeros, params))

    def update_fn(updates, state, params=None):
        state.count.add_(1)
        bc1 = _bias_correction(b1, state.count)
        bc2 = _bias_correction(b2, state.count)

        def leaf(g, m, v):
            g32 = g.float()
            m32 = b1 * m.float() + (1.0 - b1) * g32
            v32 = b2 * v.float() + (1.0 - b2) * g32 * g32
            m.copy_(m32)
            v.copy_(v32)
            return (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)

        return tree_map(leaf, updates, state.mu, state.nu), state

    return GradientTransformation(init_fn, update_fn)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update_fn(updates, state, params):
        return tree_map(lambda u, p: u + _weak(weight_decay, p) * p,
                          updates, params), state

    return GradientTransformation(lambda params: EmptyState(), update_fn)


def scale_by_learning_rate(learning_rate: float) -> GradientTransformation:
    def update_fn(updates, state, params=None):
        return tree_map(lambda u: u * _weak(-learning_rate, u),
                          updates), state

    return GradientTransformation(lambda params: EmptyState(), update_fn)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: every update scaled by max_norm / norm
    (``(t / norm) * max_norm``) when the norm over all leaves reaches
    ``max_norm``, else passed through. Chosen on the device, without a
    host read."""

    def update_fn(updates, state, params=None):
        leaves = tree_leaves(updates)
        norm = torch.sqrt(sum(torch.sum(t * t) for t in leaves))
        keep = norm < max_norm
        return tree_map(lambda t: torch.where(
            keep, t, (t / norm.to(t.dtype)) * _weak(max_norm, t)),
            updates), state

    return GradientTransformation(lambda params: EmptyState(), update_fn)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init_fn(params):
        return tuple(tx.init(params) for tx in txs)

    def update_fn(updates, state, params=None):
        for tx, s in zip(txs, state):
            updates, _ = tx.update(updates, s, params)
        return updates, state

    return GradientTransformation(init_fn, update_fn)


def apply_updates(params: dict, updates: dict) -> dict:
    """params <- (params + updates) cast to each param's dtype, in place."""
    def leaf(p, u):
        p.copy_(p + u)
        return p

    return tree_map(leaf, params, updates)


def adamw(learning_rate: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mu_dtype: torch.dtype | None = None) -> GradientTransformation:
    """optax.adamw: scale_by_adam -> add_decayed_weights -> -lr."""
    return chain(scale_by_adam(b1, b2, eps, mu_dtype),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: scale_by_adam -> -lr."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: float) -> GradientTransformation:
    """optax.sgd(learning_rate) with no momentum: a chain of one
    ``scale_by_learning_rate``, as optax builds it (its state a tuple of
    one empty state)."""
    return chain(scale_by_learning_rate(learning_rate))


def adamw_lowmem(learning_rate: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.bfloat16
                 ) -> GradientTransformation:
    """AdamW with compact moment storage: ~2x less optimizer memory than
    ``adamw(mu_dtype=bf16)`` on f32 params."""
    tx = [scale_by_adam_compact(b1, b2, eps, moment_dtype)]
    if weight_decay:
        tx.append(add_decayed_weights(weight_decay))
    tx.append(scale_by_learning_rate(learning_rate))
    return chain(*tx)


def optimizer_state_bytes(optimizer: GradientTransformation, params: dict,
                          shardings=None) -> int:
    """Bytes of optimizer state for ``params`` on one rank, from an init on
    the meta device, so no state is allocated. Without ``shardings``, the
    replicated footprint. With ``shardings``, the footprint ZeRO-1 leaves
    on each rank: an int n (every state leaf of one dim or more split n
    ways, ceil(numel / n) elements a rank, as the step's padded 1-D
    pieces; scalars whole), or a tree of the state's structure whose
    leaves are shard counts (None: replicated)."""
    meta = tree_map(lambda p: torch.empty_like(p, device="meta"), params)
    leaves = [t for t in tree_leaves(optimizer.init(meta))
              if isinstance(t, torch.Tensor)]
    if shardings is None:
        counts = [1] * len(leaves)
    elif isinstance(shardings, int):
        counts = [shardings if t.dim() else 1 for t in leaves]
    else:
        counts = tree_leaves(shardings)
        if len(counts) != len(leaves):
            raise ValueError(
                f"shardings tree has {len(counts)} leaves, optimizer state "
                f"has {len(leaves)}")
    return sum(-(-t.numel() // max(n or 1, 1)) * t.element_size()
               for t, n in zip(leaves, counts))
