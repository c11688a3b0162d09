"""Llama-3 family for the PyTorch port: geometry, parameters, and the
training forward with rematerialisation.

Port of ray_tpu/models/llama.py: ``LlamaConfig`` (same fields and presets),
``param_logical_axes``, ``init_params``, ``params_from_jax``, and
``forward_hidden``/``forward``/``loss_fn`` with every remat policy of
the JAX package: ``none``, ``full``, ``attn``, ``attn+``, ``dots`` and
``dots+``, and per-layer mixes of them. The param tree keeps the JAX
layout exactly: a dict with layer weights stacked on a leading ``[L, ...]``
axis and matmuls written
``x @ W[in, out]``, so a tree made by the JAX package's ``init_params``
converts leaf by leaf with no transposes.

Remat is ``torch.utils.checkpoint`` (non-reentrant) around segments of the
layer, in place of JAX's name-based save policies (``_remat_wrap``).
Under every policy but ``full`` flash attention runs outside any segment,
so its inputs and residuals (out, lse) are kept and K2 never re-runs:

- ``attn``: the attention inputs (attn norm, q/k/v projections, rope) are
  one checkpointed segment whose outputs, the rope'd q/k and v, are kept;
  the output projection + residual add and
  the whole SwiGLU half are checkpointed and recomputed in the backward.
  Unlike XLA, which prunes the q/k/v projections out of the recompute, the
  port re-runs them with the attention-input segment.
- ``attn+``: as ``attn``, and the post-silu gate is kept. The MLP is two
  segments, (mlp norm, gate) and (up, down); the first one's outputs are
  kept, the norm's output too (one [B, S, H] tensor a layer more than JAX
  keeps). The backward recomputes the up product from them, and the norm
  and gate product only for the gate segment's own gradient.
- ``dots``: every matrix product's output is kept (q/k/v, wo, gate, up,
  w_down: JAX's ``checkpoint_dots``) and the backward recomputes the
  rms_norms (K1), silu and gate * up. Two selective-checkpoint segments
  keep their products' outputs and recompute the rest: (attn norm, q/k/v
  products) and (mlp norm, SwiGLU). Rope, the output projection and the
  residual adds run outside them, since their backward needs nothing
  they would recompute, and each op inside a selective segment costs
  host time. The rope'd q/k that flash keeps are two tensors a layer
  more than JAX keeps.
- ``dots+``: as ``dots``, and the norm and rope outputs are kept too: only
  the SwiGLU (silu, gate * up) is a segment (K1 never re-runs).
- ``full``/True: the whole layer is one segment (K2 re-runs).
- ``none``/False: nothing is recomputed.

Under ``attn``/``attn+`` ring attention (``sp_axis`` set) sits outside
every segment too, so neither K6 nor the ring's shifts re-run in the
backward; ``full`` recomputes the ring, shifts included.

Param sharding (``param_shard``, a ``parallel.param_shard.ParamShard``):
``params`` holds this rank's blocks of each leaf. Each segment gathers the
layer leaves it uses on their split dims inside itself (over fsdp, say),
so a recompute gathers again and a layer's whole weights live only while
it runs; a split stacked ``layers`` dim is gathered once per forward.
Under tp each unit the rules split over tp alone is computed locally:
the attention's q/k/v column-parallel (the local H / tp and Hkv / tp
heads go through the flash kernels as they are) and wo row-parallel, the
MLP's gate/up column- and w_down row-parallel, each row-parallel product
followed by the tp all-reduce and each norm's output entering a local
unit through the identity-forward, all-reduce-backward conjugate; the
embedding and the head vocabulary-parallel (``fused_cross_entropy`` over
the tp group; the unfused loss and ``forward`` gather the logits over
tp). A unit the rules split otherwise (``embed`` over (fsdp, tp) takes tp
from ``heads`` in wq) is gathered whole and computed on every tp rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device, tree_map
from ray_tpu_torch.models._common import ckpt, ckpt_dots, layer_params
from ray_tpu_torch.ops.attention import blockwise_attention, flash_attention
from ray_tpu_torch.ops.loss import default_ce_chunk, fused_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.ring_attention import ring_attention_local
from ray_tpu_torch.ops.rope import apply_rope_cs, rope_cos_sin, rope_frequencies
from ray_tpu_torch.parallel.param_shard import layer_weights, stacked_layers


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


def param_logical_axes(cfg: LlamaConfig) -> dict:
    """Logical-axis names per param leaf (the rule table in
    ``ray_tpu_torch.parallel.sharding`` maps them onto mesh axes). A copy
    of the JAX package's table."""
    axes = {
        "embed_tokens": ("vocab", "embed"),
        "final_norm": ("embed",),
        "layers": {
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
            "attn_norm": ("layers", "embed"),
            "mlp_norm": ("layers", "embed"),
        },
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


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

def _attention(cfg: LlamaConfig, q, k, v, attn_impl: str, sp_axis):
    """q: [B, H, S, D], k/v: [B, Hkv, S, D] (already rope'd)."""
    if sp_axis is not None:
        # Context parallel: the sequence is sharded over the ranks of the
        # process group sp_axis; the ring handles cross-shard causality.
        return ring_attention_local(q, k, v, sp_axis, causal=True)
    if attn_impl == "flash":
        return flash_attention(q, k, v, True, None)
    return blockwise_attention(q, k, v, causal=True)


def _tp_in(ps, xn, unit: str):
    """A norm's output entering ``unit``'s column-parallel products (the
    conjugate whose backward sums its gradient over tp)."""
    return xn if ps is None else ps.tp_in(xn, unit)


def _tp_out(ps, y, unit: str):
    """``unit``'s row-parallel product's partial sums, summed over tp."""
    return y if ps is None else ps.tp_out(y, unit)


def _attn_proj(cfg: LlamaConfig, x, lp, ps=None):
    """attn norm, then the q/k/v products as [B, S, heads, D] views."""
    b, s, _ = x.shape
    norm, wq, wk, wv = layer_weights(ps, lp, "attn_norm", "wq", "wk", "wv")
    xn = _tp_in(ps, rms_norm(x, norm, cfg.norm_eps), "attn")
    return tuple((xn @ w).view(b, s, -1, cfg.head_dim) for w in (wq, wk, wv))


def _rope_qkv(q, k, v, cos, sin):
    """[B, S, heads, D] -> rope'd q/k and v as [B, heads, S, D]."""
    q = apply_rope_cs(q.transpose(1, 2), cos, sin)
    k = apply_rope_cs(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def _attn_inputs(cfg: LlamaConfig, x, lp, cos, sin, ps=None):
    return _rope_qkv(*_attn_proj(cfg, x, lp, ps), cos, sin)


def _attn_out(cfg: LlamaConfig, x, o, wo, ps=None):
    b, s, _ = x.shape
    if ps is not None:
        wo = ps.layer("wo", wo)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + _tp_out(ps, o @ wo, "attn").to(x.dtype)


def _mlp_norm(cfg: LlamaConfig, x, lp, ps=None):
    (norm,) = layer_weights(ps, lp, "mlp_norm")
    return _tp_in(ps, rms_norm(x, norm, cfg.norm_eps), "mlp")


def _mlp_gate(x, xn, lp, ps=None):
    (w_gate,) = layer_weights(ps, lp, "w_gate")
    return F.silu((xn @ w_gate).float()).to(x.dtype)


def _mlp_norm_gate(cfg: LlamaConfig, x, lp, ps=None):
    xn = _mlp_norm(cfg, x, lp, ps)
    return xn, _mlp_gate(x, xn, lp, ps)


def _mlp_out(x, xn, gate, lp, ps=None):
    """(gate * up) @ w_down: what the MLP adds to the residual."""
    w_up, w_down = layer_weights(ps, lp, "w_up", "w_down")
    up = xn @ w_up
    return _tp_out(ps, (gate * up) @ w_down, "mlp").to(x.dtype)


def _mlp_rest(x, xn, gate, lp, ps=None):
    return x + _mlp_out(x, xn, gate, lp, ps)


def _swiglu(x, xn, lp, ps=None):
    """The MLP's addend from its norm's output ``xn``."""
    return _mlp_out(x, xn, _mlp_gate(x, xn, lp, ps), lp, ps)


def _norm_swiglu(cfg: LlamaConfig, x, lp, ps=None):
    return _swiglu(x, _mlp_norm(cfg, x, lp, ps), lp, ps)


def _mlp(cfg: LlamaConfig, x, lp, ps=None):
    return x + _norm_swiglu(cfg, x, lp, ps)


def _layer(cfg: LlamaConfig, x, layer_params, cos, sin, attn_impl: str,
           sp_axis, policy: str = "none", ps=None):
    """One transformer block, x: [B, S, H]. ``policy`` is "none" (plain
    autograd), "attn", "attn+", "dots" or "dots+" (checkpointed segments,
    see the module docstring); ``ps`` the param sharding (None: whole
    params)."""
    lp = layer_params
    if policy in ("attn", "attn+"):
        q, k, v = ckpt(partial(_attn_inputs, cfg, ps=ps), x, lp, cos, sin)
        o = _attention(cfg, q, k, v, attn_impl, sp_axis)
        x = ckpt(partial(_attn_out, cfg, ps=ps), x, o, lp["wo"])
        if policy == "attn":
            return ckpt(partial(_mlp, cfg, ps=ps), x, lp)
        xn, gate = ckpt(partial(_mlp_norm_gate, cfg, ps=ps), x, lp)
        return ckpt(partial(_mlp_rest, ps=ps), x, xn, gate, lp)
    # none, dots, dots+: the segments hold only what a policy recomputes
    # (a selective-checkpoint segment costs host time on each op in it)
    if policy == "dots":
        q, k, v = _rope_qkv(*ckpt_dots(partial(_attn_proj, cfg, ps=ps), x,
                                       lp), cos, sin)
    else:
        q, k, v = _attn_inputs(cfg, x, lp, cos, sin, ps)
    o = _attention(cfg, q, k, v, attn_impl, sp_axis)
    x = _attn_out(cfg, x, o, lp["wo"], ps)
    if policy == "none":
        return _mlp(cfg, x, lp, ps)
    if policy == "dots":
        return x + ckpt_dots(partial(_norm_swiglu, cfg, ps=ps), x, lp)
    xn = _mlp_norm(cfg, x, lp, ps)  # dots+: the norm's output is kept
    return x + ckpt_dots(partial(_swiglu, ps=ps), x, xn, lp)


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
    ``fn(x, lp)``. 'attn', 'attn+', 'dots' and 'dots+' are the layer's
    own segments; False/'none' saves everything; True/'full' and any
    other value recompute the whole layer, as in the JAX package. ViT and
    Mixtral wrap their layers in this too."""
    if remat in (False, "none"):
        return partial(layer_fn, policy="none")
    if remat in ("attn", "attn+", "dots", "dots+"):
        return partial(layer_fn, policy=remat)
    plain = partial(layer_fn, policy="none")
    return lambda x, lp: ckpt(plain, x, lp)


def forward_hidden(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                   positions: torch.Tensor | None = None,
                   attn_impl: str = "flash", sp_axis=None,
                   remat: bool | str | tuple = True,
                   param_shard=None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, H]. ``remat`` is a
    single policy or a per-layer spec (see :func:`normalize_remat`).
    ``param_shard``: ``params`` are this rank's blocks (see the module
    docstring); the result is then the conjugate's input to a
    tp-sharded head.

    Context parallel: with ``sp_axis`` a ``torch.distributed`` process
    group, ``tokens`` is this rank's shard of the sequence (the ranks hold
    consecutive shards in rank order) and the caller passes the shard's
    global ``positions``; attention runs the ring over the group
    (``ring_attention_local``) and ``attn_impl`` is not read."""
    s = tokens.shape[1]
    dev = tokens.device
    ps = param_shard
    if positions is None:
        positions = torch.arange(s, device=dev)
    if ps is None:
        x = F.embedding(tokens, params["embed_tokens"])
    else:
        ps.local(cfg.num_heads, "q heads", "attn")
        ps.local(cfg.num_kv_heads, "kv heads", "attn")
        x = ps.embed(tokens, params["embed_tokens"])
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling, device=dev)
    cos, sin = rope_cos_sin(positions, inv_freq)
    base_fn = partial(_layer, cfg, cos=cos, sin=sin, attn_impl=attn_impl,
                      sp_axis=sp_axis, ps=ps)
    remat = normalize_remat(remat, cfg.num_layers)
    runs = (_remat_runs(remat) if isinstance(remat, tuple)
            else [(remat, 0, cfg.num_layers)])
    layers = layer_params(stacked_layers(ps, params))
    for policy, start, end in runs:
        layer_fn = _remat_wrap(base_fn, policy)
        for lp in layers[start:end]:
            x = layer_fn(x, lp)
    if ps is None:
        return rms_norm(x, params["final_norm"], cfg.norm_eps)
    norm = ps.full(("final_norm",), params["final_norm"])
    return _tp_in(ps, rms_norm(x, norm, cfg.norm_eps), "vocab")


def unembed_weights(cfg: LlamaConfig, params: dict,
                    param_shard=None) -> torch.Tensor:
    """[H, V] head matrix (a transposed view of tied embeddings); with
    ``param_shard``, gathered on its non-local dims (this tp rank's
    [H, V / tp] columns where the vocabulary is tp-local)."""
    ps = param_shard
    if cfg.tie_embeddings:
        w = params["embed_tokens"]
        return (w if ps is None else ps.full(("embed_tokens",), w)).t()
    w = params["lm_head"]
    return w if ps is None else ps.full(("lm_head",), w)


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor | None = None, attn_impl: str = "flash",
            sp_axis=None, remat: bool | str = True,
            param_shard=None) -> torch.Tensor:
    """tokens [B, S] -> f32 logits [B, S, V]: the head product of the
    widened inputs in f32 (JAX: bf16 inputs, f32 accumulation). Under a
    vocabulary-parallel head (``param_shard``) each rank's columns are
    all-gathered over tp (its columns of the gradient in the backward)."""
    ps = param_shard
    x = forward_hidden(cfg, params, tokens, positions, attn_impl, sp_axis,
                       remat, ps)
    logits = x.float() @ unembed_weights(cfg, params, ps).float()
    return logits if ps is None else ps.gather_vocab(logits)


def loss_fn(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None,
            fused_ce: bool = True, **fwd_kwargs) -> torch.Tensor:
    """Mean next-token cross-entropy over unmasked positions. The fused
    loss runs chunks of ``ops.loss.default_ce_chunk()`` tokens
    (``RTPU_CE_CHUNK``, read at each call); under ``param_shard`` it is
    vocabulary-parallel over the tp group, and the unfused one takes the
    logits gathered over tp."""
    ps = fwd_kwargs.get("param_shard")
    if fused_ce:
        x = forward_hidden(cfg, params, tokens, **fwd_kwargs)
        head = unembed_weights(cfg, params, ps)
        chunk = default_ce_chunk()
        if ps is None:
            return fused_cross_entropy(x, head, targets, mask, chunk)
        return fused_cross_entropy(x, head, targets, mask, chunk,
                                   **ps.vocab_parallel(head))
    logits = forward(cfg, params, tokens, **fwd_kwargs)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
