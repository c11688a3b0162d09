"""Llama-3 family for the PyTorch port: geometry, parameters, and the
training forward with rematerialisation.

Port of ray_tpu/models/llama.py: ``LlamaConfig`` (same fields and presets),
``init_params``, ``params_from_jax``, and ``forward_hidden``/``forward``/
``loss_fn`` with the remat policies ``none``, ``full``, ``attn`` and
``attn+``. The param tree keeps the JAX layout exactly: a dict with layer
weights stacked on a leading ``[L, ...]`` axis and matmuls written
``x @ W[in, out]``, so a tree made by the JAX package's ``init_params``
converts leaf by leaf with no transposes.

Remat is ``torch.utils.checkpoint`` (non-reentrant) around segments of the
layer, in place of JAX's name-based save policies (``_remat_wrap``):

- ``attn``: the attention inputs (attn norm, q/k/v projections, rope) are
  one checkpointed segment whose outputs, the rope'd q/k and v, are kept;
  flash attention runs outside any segment, so its residuals (out, lse)
  are kept and K2 never re-runs; the output projection + residual add and
  the whole SwiGLU half are checkpointed and recomputed in the backward.
  Unlike XLA, which prunes the q/k/v projections out of the recompute, the
  port re-runs them with the attention-input segment.
- ``attn+``: as ``attn``, and the post-silu gate is kept. The MLP is two
  segments, (mlp norm, gate) and (up, down); the first one's outputs are
  kept, the norm's output too (one [B, S, H] tensor a layer more than JAX
  keeps). The backward recomputes the up product from them, and the norm
  and gate product only for the gate segment's own gradient.
- ``full``/True: the whole layer is one segment (K2 re-runs).
- ``none``/False: nothing is recomputed.
- ``dots``/``dots+`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device, tree_map
from ray_tpu_torch.ops.attention import blockwise_attention, flash_attention
from ray_tpu_torch.ops.loss import fused_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope_cs, rope_cos_sin, rope_frequencies


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: dict | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        # Llama-3.2-1B geometry
        return LlamaConfig(hidden_size=2048, intermediate_size=8192,
                           num_layers=16, num_heads=32, num_kv_heads=8,
                           head_dim=64, tie_embeddings=True)

    @staticmethod
    def tiny() -> "LlamaConfig":
        """Test-size config: runs in milliseconds, exercises every path."""
        return LlamaConfig(vocab_size=256, hidden_size=64,
                           intermediate_size=128, num_layers=2, num_heads=4,
                           num_kv_heads=2, head_dim=16, max_seq_len=256,
                           dtype="float32")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def num_params(self) -> int:
        h, v, i, L = (self.hidden_size, self.vocab_size,
                      self.intermediate_size, self.num_layers)
        qkv = (h * self.num_heads * self.head_dim
               + 2 * h * self.num_kv_heads * self.head_dim)
        o = self.num_heads * self.head_dim * h
        mlp = 3 * h * i
        embed = v * h * (1 if self.tie_embeddings else 2)
        return embed + L * (qkv + o + mlp + 2 * h) + h


def init_params(cfg: LlamaConfig,
                generator: torch.Generator | int | None = None,
                device: torch.device | str = "cuda") -> dict:
    """Scaled-normal init with the layout of the JAX ``init_params``;
    layer params stacked on the leading axis. ``generator`` is a
    ``torch.Generator`` on ``device`` or an int seed (None = 0). The same
    seed gives other numbers than JAX's PRNGKey: parity tests convert a
    JAX tree with ``params_from_jax`` instead."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        seed = 0 if generator is None else int(generator)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    h, L = cfg.hidden_size, cfg.num_layers
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    i = cfg.intermediate_size
    dt = cfg.torch_dtype

    def normal(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return t.mul_(scale).to(dt)

    params = {
        "embed_tokens": normal(cfg.vocab_size, h, scale=0.02),
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
        "layers": {
            "wq": normal(L, h, qd),
            "wk": normal(L, h, kvd),
            "wv": normal(L, h, kvd),
            "wo": normal(L, qd, h, scale=1.0 / math.sqrt(qd * 2 * L)),
            "w_gate": normal(L, h, i),
            "w_up": normal(L, h, i),
            "w_down": normal(L, i, h, scale=1.0 / math.sqrt(i * 2 * L)),
            "attn_norm": torch.ones((L, h), dtype=dt, device=dev),
            "mlp_norm": torch.ones((L, h), dtype=dt, device=dev),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(h, cfg.vocab_size,
                                   scale=1.0 / math.sqrt(h))
    return params


def params_from_jax(tree: dict,
                    device: torch.device | str = "cuda") -> dict:
    """Convert a JAX param tree (jax or numpy arrays) to torch tensors on
    ``device``, leaf by leaf, same layout. bfloat16 goes through float32
    (``torch.from_numpy`` rejects ml_dtypes' bfloat16); both steps are
    exact. Needs no JAX import: ``np.asarray`` reads a jax array."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)  # writable copy

    return tree_map(conv, tree)


def params_to(params: dict, device: torch.device | str) -> dict:
    """The same tree with every leaf on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


# --------------------------------------------------------------------------
# Training forward
# --------------------------------------------------------------------------

def _attention(cfg: LlamaConfig, q, k, v, attn_impl: str,
               sp_axis: str | None):
    """q: [B, H, S, D], k/v: [B, Hkv, S, D] (already rope'd)."""
    if sp_axis is not None:
        raise NotImplementedError(
            "ring attention over a sequence axis (sp_axis) is not ported "
            "yet: it needs torch.distributed")
    if attn_impl == "flash":
        return flash_attention(q, k, v, True, None)
    return blockwise_attention(q, k, v, causal=True)


def _attn_inputs(cfg: LlamaConfig, x, lp, cos, sin):
    b, s, _ = x.shape
    xn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (xn @ lp["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
    k = (xn @ lp["wk"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (xn @ lp["wv"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope_cs(q.transpose(1, 2), cos, sin)
    k = apply_rope_cs(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def _attn_out(cfg: LlamaConfig, x, o, wo):
    b, s, _ = x.shape
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return x + (o @ wo).to(x.dtype)


def _mlp_norm_gate(cfg: LlamaConfig, x, lp):
    xn = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return xn, F.silu((xn @ lp["w_gate"]).float()).to(x.dtype)


def _mlp_rest(x, xn, gate, lp):
    up = xn @ lp["w_up"]
    return x + ((gate * up) @ lp["w_down"]).to(x.dtype)


def _mlp(cfg: LlamaConfig, x, lp):
    xn, gate = _mlp_norm_gate(cfg, x, lp)
    return _mlp_rest(x, xn, gate, lp)


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _layer(cfg: LlamaConfig, x, layer_params, cos, sin, attn_impl: str,
           sp_axis: str | None, policy: str = "none"):
    """One transformer block, x: [B, S, H]. ``policy`` is "none" (plain
    autograd), "attn" or "attn+" (checkpointed segments, see the module
    docstring)."""
    lp = layer_params
    if policy == "none":
        q, k, v = _attn_inputs(cfg, x, lp, cos, sin)
        o = _attention(cfg, q, k, v, attn_impl, sp_axis)
        x = _attn_out(cfg, x, o, lp["wo"])
        return _mlp(cfg, x, lp)
    q, k, v = _ckpt(partial(_attn_inputs, cfg), x, lp, cos, sin)
    o = _attention(cfg, q, k, v, attn_impl, sp_axis)
    x = _ckpt(partial(_attn_out, cfg), x, o, lp["wo"])
    if policy == "attn":
        return _ckpt(partial(_mlp, cfg), x, lp)
    xn, gate = _ckpt(partial(_mlp_norm_gate, cfg), x, lp)
    return _ckpt(_mlp_rest, x, xn, gate, lp)


def normalize_remat(remat, num_layers: int):
    """Canonicalize a remat spec: a scalar policy stays scalar; a per-layer
    sequence (one policy per layer) is length-checked and collapsed back
    to a scalar when uniform. Strings with commas ("attn:8,full:8" or
    "attn,attn,full,...") expand to per-layer form; "policy:N" runs N
    consecutive layers under that policy. (Copy of the JAX package's.)"""
    if isinstance(remat, str) and ("," in remat or ":" in remat):
        out = []
        for part in remat.split(","):
            part = part.strip()
            if ":" in part:
                pol, n = part.rsplit(":", 1)
                out.extend([pol] * int(n))
            elif part:
                out.append(part)
        remat = tuple(out)
    if isinstance(remat, (list, tuple)):
        if len(remat) != num_layers:
            raise ValueError(
                f"per-layer remat has {len(remat)} entries for "
                f"{num_layers} layers")
        if len(set(remat)) == 1:
            return remat[0]
        return tuple(remat)
    return remat


def _remat_runs(remat: tuple) -> list[tuple]:
    """Consecutive equal-policy runs of a per-layer remat spec:
    ('attn','attn','full') -> [('attn', 0, 2), ('full', 2, 3)]."""
    runs = []
    start = 0
    for i in range(1, len(remat) + 1):
        if i == len(remat) or remat[i] != remat[start]:
            runs.append((remat[start], start, i))
            start = i
    return runs


def _remat_wrap(layer_fn, remat):
    """``layer_fn(x, lp, policy=...)`` under one remat policy ->
    ``fn(x, lp)``. True/'full' recomputes the whole layer; 'attn' and
    'attn+' checkpoint segments around the kept attention residuals;
    False/'none' saves everything; any other value is a full remat, as in
    the JAX package. 'dots'/'dots+' are not ported."""
    if remat in (False, "none"):
        return partial(layer_fn, policy="none")
    if remat in ("attn", "attn+"):
        return partial(layer_fn, policy=remat)
    if remat in ("dots", "dots+"):
        raise NotImplementedError(
            f"remat policy {remat!r} (save every matmul output) is not "
            f"ported yet; use 'attn', 'attn+', 'full' or 'none'")
    plain = partial(layer_fn, policy="none")
    return lambda x, lp: _ckpt(plain, x, lp)


def _layer_params(params: dict) -> list[dict]:
    """Per-layer views of the stacked ``[L, ...]`` leaves. One ``unbind``
    per leaf, so the backward stacks the layer gradients once."""
    names = list(params["layers"])
    per_leaf = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]


def forward_hidden(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                   positions: torch.Tensor | None = None,
                   attn_impl: str = "flash", sp_axis: str | None = None,
                   remat: bool | str | tuple = True) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, H]. ``remat`` is a
    single policy or a per-layer spec (see :func:`normalize_remat`)."""
    s = tokens.shape[1]
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, device=dev)
    x = F.embedding(tokens, params["embed_tokens"])
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling, device=dev)
    cos, sin = rope_cos_sin(positions, inv_freq)
    base_fn = partial(_layer, cfg, cos=cos, sin=sin, attn_impl=attn_impl,
                      sp_axis=sp_axis)
    remat = normalize_remat(remat, cfg.num_layers)
    runs = (_remat_runs(remat) if isinstance(remat, tuple)
            else [(remat, 0, cfg.num_layers)])
    layers = _layer_params(params)
    for policy, start, end in runs:
        layer_fn = _remat_wrap(base_fn, policy)
        for lp in layers[start:end]:
            x = layer_fn(x, lp)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def unembed_weights(cfg: LlamaConfig, params: dict) -> torch.Tensor:
    """[H, V] head matrix (a transposed view of tied embeddings)."""
    return params["embed_tokens"].t() if cfg.tie_embeddings \
        else params["lm_head"]


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor | None = None, attn_impl: str = "flash",
            sp_axis: str | None = None,
            remat: bool | str = True) -> torch.Tensor:
    """tokens [B, S] -> f32 logits [B, S, V]: the head product of the
    widened inputs in f32 (JAX: bf16 inputs, f32 accumulation)."""
    x = forward_hidden(cfg, params, tokens, positions, attn_impl, sp_axis,
                       remat)
    return x.float() @ unembed_weights(cfg, params).float()


def loss_fn(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None,
            fused_ce: bool = True, **fwd_kwargs) -> torch.Tensor:
    """Mean next-token cross-entropy over unmasked positions. The fused
    loss runs 512-token chunks (the JAX package's default; its
    RTPU_CE_CHUNK override is not ported)."""
    if fused_ce:
        x = forward_hidden(cfg, params, tokens, **fwd_kwargs)
        return fused_cross_entropy(x, unembed_weights(cfg, params), targets,
                                   mask)
    logits = forward(cfg, params, tokens, **fwd_kwargs)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
