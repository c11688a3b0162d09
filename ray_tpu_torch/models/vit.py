"""ViT: the vision-transformer classifier family for the PyTorch port.

Port of ray_tpu/models/vit.py: ``ViTConfig`` (same fields and presets),
``param_logical_axes``, ``init_params``, ``params_from_jax`` (the same
stacked layout, so a JAX tree converts leaf by leaf with no transposes),
``patchify`` and
``forward``/``loss_fn``. Patchify is a reshape plus a permute, then one
matmul (what a stride-p convolution is, minus the convolution). Each layer
is pre-norm: rms_norm (K1 on the card), q/k/v projections, non-causal
``flash_attention`` (K2 forward; K3, or K4 + K5 when the attention
module's ``FUSED_BWD`` is false, backward), the output projection, then
rms_norm, ``w_up``, gelu in its tanh form (``jax.nn.gelu``'s default;
PyTorch's default is the exact erf form) and ``w_down``. The class token's
final-norm row gives the f32 logits.

Remat: every policy of the JAX package, through Llama's ``_remat_wrap``
(JAX's ViT wraps its layer in Llama's). False/"none" saves everything;
True/"full" recomputes each layer in the backward (a
``torch.utils.checkpoint`` segment, K2 re-run included). The ViT layer
names no tensor but flash's residuals, so under JAX "attn" and "attn+"
keep only those, and "dots" and "dots+" are one policy: every matrix
product's output plus flash's residuals. The port runs the same: the
layer is two segments, (attn norm, q/k/v) and (wo, residual add, mlp
norm, MLP, residual add), with flash attention between them and outside
both. Under "attn"/"attn+" both segments are recomputed whole; under
"dots"/"dots+" selective-checkpoint segments (attn norm, q/k/v) and
(mlp norm, MLP) keep their products' outputs and recompute the norms
(K1) and gelu, and the output projection and the adds run outside them
(nothing to recompute there). One difference
from JAX: since flash runs outside every segment, its inputs q/k/v are
kept too, three [B, S, H] tensors a layer more than JAX keeps under
"attn"; in exchange K2 never re-runs.

Param sharding (``param_shard``, as in ``models.llama``): each layer
gathers its leaves on their split dims inside itself (inside its remat
segment under "full"); where the rules split a unit over tp alone, q/k/v
and ``w_up`` are column-parallel (the local heads and MLP columns),
``wo`` and ``w_down`` row-parallel followed by the tp all-reduce, each
norm's output entering the unit through the conjugate whose backward
sums over tp. ``patch_embed``, ``pos_embed``, ``cls_token``, the final
norm and ``head`` are gathered whole (``classes`` over tp, say, is
gathered, and each tp rank takes its columns of the gradient).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models._common import ckpt, ckpt_dots, layer_params
from ray_tpu_torch.models.llama import _remat_wrap, params_from_jax
from ray_tpu_torch.ops.attention import blockwise_attention, flash_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.parallel.param_shard import layer_weights, stacked_layers

__all__ = ["ViTConfig", "param_logical_axes", "init_params",
           "params_from_jax", "patchify", "forward", "loss_fn"]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_classes: int = 1000
    norm_eps: float = 1e-6
    dtype: str = "float32"

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=16, patch_size=4, hidden_size=32,
                         intermediate_size=64, num_layers=2, num_heads=2,
                         num_classes=10)

    @staticmethod
    def base16() -> "ViTConfig":
        return ViTConfig()  # ViT-B/16

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, i, L = self.hidden_size, self.intermediate_size, self.num_layers
        patch_in = self.patch_size**2 * self.num_channels
        per_layer = 4 * h * h + 2 * h * i + 2 * h
        return (patch_in * h + (self.num_patches + 1) * h + h
                + L * per_layer + h + h * self.num_classes)


def param_logical_axes(cfg: ViTConfig) -> dict:
    """Logical-axis names per param leaf (see
    ``ray_tpu_torch.parallel.sharding``); a copy of the JAX package's
    table."""
    return {
        "patch_embed": ("patch_in", "embed"),
        "pos_embed": (None, "embed"),
        "cls_token": ("embed",),
        "final_norm": ("embed",),
        "head": ("embed", "classes"),
        "layers": {
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "heads"),
            "wv": ("layers", "embed", "heads"),
            "wo": ("layers", "heads", "embed"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
            "attn_norm": ("layers", "embed"),
            "mlp_norm": ("layers", "embed"),
        },
    }


def init_params(cfg: ViTConfig,
                generator: torch.Generator | int | None = None,
                device: torch.device | str = "cuda") -> dict:
    """Scaled-normal init with the layout and scales of the JAX
    ``init_params``; layer params stacked on the leading axis.
    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed
    (None = 0); parity tests convert a JAX tree instead."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        seed = 0 if generator is None else int(generator)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    h, L = cfg.hidden_size, cfg.num_layers
    i = cfg.intermediate_size
    patch_in = cfg.patch_size**2 * cfg.num_channels
    dt = cfg.torch_dtype

    def normal(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return t.mul_(scale).to(dt)

    return {
        "patch_embed": normal(patch_in, h),
        "pos_embed": normal(cfg.num_patches + 1, h, scale=0.02),
        "cls_token": torch.zeros((h,), dtype=dt, device=dev),
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
        "head": normal(h, cfg.num_classes, scale=1.0 / math.sqrt(h)),
        "layers": {
            "wq": normal(L, h, h),
            "wk": normal(L, h, h),
            "wv": normal(L, h, h),
            "wo": normal(L, h, h, scale=1.0 / math.sqrt(h * 2 * L)),
            "w_up": normal(L, h, i),
            "w_down": normal(L, i, h, scale=1.0 / math.sqrt(i * 2 * L)),
            "attn_norm": torch.ones((L, h), dtype=dt, device=dev),
            "mlp_norm": torch.ones((L, h), dtype=dt, device=dev),
        },
    }


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, p*p*C] patch rows (reshape and permute)."""
    b, hh, ww, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, hh // p, p, ww // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // p) * (ww // p), p * p * c)


def _tp(ps, unit: str):
    """``unit``'s tp conjugates (identities where it is not tp-local)."""
    if ps is None:
        return (lambda t: t), (lambda t: t)
    return partial(ps.tp_in, unit=unit), partial(ps.tp_out, unit=unit)


def _qkv(cfg: ViTConfig, x, lp, ps=None):
    b, s, _ = x.shape
    norm, wq, wk, wv = layer_weights(ps, lp, "attn_norm", "wq", "wk", "wv")
    xn = _tp(ps, "attn")[0](rms_norm(x, norm, cfg.norm_eps))
    return tuple((xn @ w).view(b, s, -1, cfg.head_dim).transpose(1, 2)
                 for w in (wq, wk, wv))


def _attention(q, k, v, attn_impl: str):
    if attn_impl == "flash":
        return flash_attention(q, k, v, False)  # bidirectional
    return blockwise_attention(q, k, v, causal=False)


def _out(cfg: ViTConfig, x, attn, lp, ps=None):
    b, s, _ = x.shape
    (wo,) = layer_weights(ps, lp, "wo")
    return x + _tp(ps, "attn")[1](attn.transpose(1, 2).reshape(b, s, -1)
                                  @ wo)


def _mlp(cfg: ViTConfig, x, lp, ps=None):
    """mlp norm, w_up, gelu, w_down: what the MLP adds to the residual."""
    norm, w_up, w_down = layer_weights(ps, lp, "mlp_norm", "w_up", "w_down")
    tp_in, tp_out = _tp(ps, "mlp")
    xn = tp_in(rms_norm(x, norm, cfg.norm_eps))
    return tp_out(F.gelu(xn @ w_up, approximate="tanh") @ w_down)


def _out_mlp(cfg: ViTConfig, x, attn, lp, ps=None):
    x = _out(cfg, x, attn, lp, ps)
    return x + _mlp(cfg, x, lp, ps)


def _layer(cfg: ViTConfig, x, lp, attn_impl: str, ps=None,
           policy: str = "none"):
    """One pre-norm block; ``policy`` as in the module docstring."""
    qkv, out_mlp = partial(_qkv, cfg, ps=ps), partial(_out_mlp, cfg, ps=ps)
    if policy == "none":
        return out_mlp(x, _attention(*qkv(x, lp), attn_impl), lp)
    if policy in ("attn", "attn+"):
        attn = _attention(*ckpt(qkv, x, lp), attn_impl)
        return ckpt(out_mlp, x, attn, lp)
    # dots/dots+: the output projection and the adds need no recompute,
    # so they stay outside the selective segments
    attn = _attention(*ckpt_dots(qkv, x, lp), attn_impl)
    x = _out(cfg, x, attn, lp, ps)
    return x + ckpt_dots(partial(_mlp, cfg, ps=ps), x, lp)


def forward(cfg: ViTConfig, params: dict, images: torch.Tensor,
            attn_impl: str = "flash", remat: bool | str = False,
            param_shard=None) -> torch.Tensor:
    """[B, H, W, C] images (float in [0, 1]) -> [B, num_classes] f32
    logits. ``attn_impl`` "flash" runs ``flash_attention``, anything else
    ``blockwise_attention`` (JAX's ``use_pallas=False``). With
    ``param_shard``, ``params`` are this rank's blocks (see the module
    docstring)."""
    ps = param_shard
    if ps is None:
        top = params
    else:
        ps.local(cfg.num_heads, "heads", "attn")
        top = {k: ps.full((k,), v) for k, v in params.items()
               if k != "layers"}
    x = patchify(cfg, images.to(cfg.torch_dtype)) @ top["patch_embed"]
    cls = top["cls_token"].expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + top["pos_embed"][None]
    layer_fn = _remat_wrap(partial(_layer, cfg, attn_impl=attn_impl, ps=ps),
                           remat)
    for lp in layer_params(stacked_layers(ps, params)):
        x = layer_fn(x, lp)
    x = rms_norm(x, top["final_norm"], cfg.norm_eps)
    return (x[:, 0, :] @ top["head"]).float()  # the class token


def loss_fn(cfg: ViTConfig, params: dict, images: torch.Tensor,
            labels: torch.Tensor, attn_impl: str = "flash",
            remat: bool | str = False, param_shard=None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` [B] (f32 log_softmax)."""
    logits = forward(cfg, params, images, attn_impl=attn_impl, remat=remat,
                     param_shard=param_shard)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
