"""Mixtral: the sparse mixture-of-experts family for the PyTorch port.

Port of ray_tpu/models/mixtral.py: ``MixtralConfig`` (same fields and
presets), ``param_logical_axes``, ``init_params``, ``params_from_jax``
(the same stacked layout, no transposes), ``compute_routing``,
``moe_block`` and ``forward_hidden``/``forward``/``loss_fn``. Attention,
rope and the norms are the Llama port's (K1, K2 and K3 on the card); the
MLP is the capacity-routed expert layer:

- routing (GShard/Switch): softmax of the f32 router logits, top-k
  gates renormalised to sum to 1, each claim's slot the count of earlier
  claims on its expert in token-major, k-minor order, claims at or past
  the capacity C dropped; ``lax.top_k`` and ``torch.topk`` may order
  ties differently (random f32 logits have none);
- dispatch and combine as JAX builds them ([T, E, C] f32, one-hot),
  then the one-hot products: ``tec,th->ech`` gathers each expert's
  slots, the SwiGLU runs as batched products per expert, ``tec,ech->th``
  adds each token's gated expert outputs (``combine`` cast to the
  activations' dtype first). The products stay one-hot matmuls, as in
  JAX; a gather/scatter dispatch is a ROADMAP item;
- the Switch load-balancing loss ``E * sum_e token_frac * prob_frac``,
  averaged over layers, added to the LM loss times ``router_aux_coef``.

Routing over data-parallel ranks (``routing``, a :class:`RoutingGroup`):
JAX routes the global batch inside one program, so T, the capacity
``cfg.capacity(T)``, each claim's slot and the aux's statistics are the
global batch's. Each rank holds consecutive rows of it (the step's
``data_sharder``); the ranks' per-expert claim counts are all-gathered in
batch order each layer, a rank's slots start after the earlier ranks'
claims, and C is the global batch's. ``token_frac`` is global (each
expert keeps min(claims, C)); the aux a rank returns takes its own
tokens' mean router probability, so that the mean over the data ranks,
which the step takes of losses and gradients, is JAX's aux and its
gradient. Under context parallelism (the group spans sp too) a rank holds
one chunk of the sequence of each of its rows, and JAX's token order is
the flatten of [B, S]: row b's chunk j comes after row b's earlier chunks
and every earlier row's. The ranks exchange claim counts per (row,
expert), and a claim's slot starts after the claims of every (row,
chunk) before its own in that order.

Param sharding (``param_shard``, as in ``models.llama``): each layer
gathers its leaves over fsdp; under tp the attention is Llama's and each
expert's ``mlp`` columns are local (the expert branch's input passes the
tp conjugate, its down product is summed over tp); the embedding and the
fused loss are vocabulary-parallel (``forward`` gathers the logits over
tp). Expert parallelism: with the ``expert`` dim of
``we_gate``/``we_up``/``we_down`` over ``ep``, an ep rank holds E / ep
experts. Where the batch does not split over ep, it holds the same tokens
as the other ep ranks, dispatches to and runs its own experts only, and
its partial combine is summed over ep (all-reduce forward, identity
backward). The router, its softmax and the aux run whole on every ep
rank; the gate values pass the identity-forward, all-reduce-backward
conjugate (each rank's combine reaches the gates of its own experts
only), and so does the expert branch's input, so the router's gradient
is summed once over ep. Where the batch splits over ep (``batch=("dp",
"ep")``: GShard's all-to-all dispatch), each ep rank routes its own
tokens within the global routing, builds the expert inputs of every
expert from them ([E, C, H]; each (expert, slot) holds at most one claim
in the whole batch), and a reduce-scatter over ep on the expert dim sums
them into its own experts' inputs: the sum adds zeros, so the bits are
JAX's one-hot einsums'. After its experts, their outputs are all-gathered
over ep and each rank combines its own tokens; the backward is the
conjugate (an all-gather of the inputs' gradient, a reduce-scatter of the
outputs'). A true ``all_to_all`` of the claimed slots alone would move
less (ROADMAP: speed, not a port).

Remat: every policy of the JAX package, through Llama's ``_remat_wrap``.
True/"full" recomputes each layer in the backward (the routing's
collectives again too); False/"none" keeps everything. Mixtral's layer
names no tensor but flash's residuals, so, as for ViT, "attn" and
"attn+" are one policy here, and "dots" and "dots+" another. Flash runs
outside every segment (its inputs q/k/v kept: K2 never re-runs). "attn"
makes the layer two segments, Llama's attention inputs and (wo, residual
add, mlp norm, router, routing, experts, combine, residual add), and
recomputes both whole, the routing's collectives included;
"dots" keeps every matrix product's output (q/k/v, wo, the router's
logits, the one-hot dispatch product, the experts' products and the
combine product) in two selective-checkpoint segments, (attn norm, q/k/v
products) and (mlp norm, router, routing, experts, combine), and
recomputes the norms, softmax, top-k, routing and silu; rope, the output
projection and the adds run outside them. A segment that is recomputed
appends its claims to ``route_stats`` once more.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama as _llama
from ray_tpu_torch.models._common import ckpt, ckpt_dots, layer_params
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.ops.loss import fused_cross_entropy, logits_f32
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rope_cos_sin, rope_frequencies
from ray_tpu_torch.parallel.mesh import mesh_coords
from ray_tpu_torch.parallel.param_shard import layer_weights, stacked_layers
from ray_tpu_torch.parallel.sharding import (
    axes_group,
    axis_sizes,
    group_blocks,
)

__all__ = ["MixtralConfig", "RoutingGroup", "param_logical_axes",
           "init_params", "params_from_jax", "compute_routing", "moe_block",
           "forward_hidden", "forward", "loss_fn"]


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.02
    dtype: str = "bfloat16"

    @staticmethod
    def mixtral_8x7b() -> "MixtralConfig":
        return MixtralConfig()

    @staticmethod
    def tiny() -> "MixtralConfig":
        """Test size: routing and every code path in milliseconds."""
        return MixtralConfig(vocab_size=256, hidden_size=64,
                             intermediate_size=128, num_layers=2, num_heads=4,
                             num_kv_heads=2, head_dim=16, max_seq_len=256,
                             num_experts=4, top_k=2, dtype="float32")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def capacity(self, num_tokens: int) -> int:
        """Per-expert token slots for a batch of ``num_tokens``."""
        return max(1, int(math.ceil(
            self.capacity_factor * self.top_k * num_tokens
            / self.num_experts)))

    def num_params(self, active: bool = False) -> int:
        """Every param (``active``: with the experts a token's top-k
        reach, top_k / num_experts of the expert weights)."""
        h, L = self.hidden_size, self.num_layers
        attn = h * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim \
            + self.num_heads * self.head_dim * h
        experts = self.num_experts * 3 * h * self.intermediate_size
        if active:
            experts = experts * self.top_k // self.num_experts
        per_layer = attn + h * self.num_experts + experts + 2 * h
        return 2 * self.vocab_size * h + L * per_layer + h


def param_logical_axes(cfg: MixtralConfig) -> dict:
    """Logical-axis names per param leaf; a copy of the JAX package's
    table (``expert`` maps to the mesh's ``ep``)."""
    return {
        "embed_tokens": ("vocab", "embed"),
        "lm_head": ("embed", "vocab"),
        "final_norm": ("embed",),
        "layers": {
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "router": ("layers", "embed", None),
            "we_gate": ("layers", "expert", "embed", "mlp"),
            "we_up": ("layers", "expert", "embed", "mlp"),
            "we_down": ("layers", "expert", "mlp", "embed"),
            "attn_norm": ("layers", "embed"),
            "mlp_norm": ("layers", "embed"),
        },
    }


def init_params(cfg: MixtralConfig,
                generator: torch.Generator | int | None = None,
                device: torch.device | str = "cuda") -> dict:
    """Scaled-normal init with the JAX ``init_params``'s layout and
    scales. ``generator`` is a ``torch.Generator`` on ``device`` or an int
    seed (None = 0); parity tests convert a JAX tree instead."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        seed = 0 if generator is None else int(generator)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    h, L, E = cfg.hidden_size, cfg.num_layers, cfg.num_experts
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    i = cfg.intermediate_size
    dt = cfg.torch_dtype

    def normal(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return t.mul_(scale).to(dt)

    return {
        "embed_tokens": normal(cfg.vocab_size, h, scale=0.02),
        "lm_head": normal(h, cfg.vocab_size, scale=1.0 / math.sqrt(h)),
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
        "layers": {
            "wq": normal(L, h, qd),
            "wk": normal(L, h, kvd),
            "wv": normal(L, h, kvd),
            "wo": normal(L, qd, h, scale=1.0 / math.sqrt(qd * 2 * L)),
            "router": normal(L, h, E, scale=0.02),
            "we_gate": normal(L, E, h, i),
            "we_up": normal(L, E, h, i),
            "we_down": normal(L, E, i, h, scale=1.0 / math.sqrt(i * 2 * L)),
            "attn_norm": torch.ones((L, h), dtype=dt, device=dev),
            "mlp_norm": torch.ones((L, h), dtype=dt, device=dev),
        },
    }


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------

class RoutingGroup:
    """The ranks one batch's routing spans: ``group`` over the batch axes
    (and sp, whose ``sp_n`` ranks each hold a chunk of the sequence),
    this rank's ``index`` in batch order among ``n`` (data-major, the sp
    chunk minor), and ``order`` (group rank -> index; None when they
    agree)."""

    def __init__(self, group, index: int, n: int, order=None,
                 sp_n: int = 1):
        self.group, self.index, self.n, self.order = group, index, n, order
        self.sp_n = sp_n

    @classmethod
    def of_mesh(cls, mesh, data_axes: tuple[str, ...],
                sp: bool = False) -> "RoutingGroup":
        """The group of ``data_axes`` of ``mesh``, with ``sp`` its sp axis
        too (collective the first time: every rank calls it, in one
        order)."""
        sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
        axes = tuple(data_axes) + (("sp",) if sp else ())
        dims = [sizes[a] for a in axes]
        index = int(np.ravel_multi_index([coords[a] for a in axes],
                                         dims)) if axes else 0
        group = axes_group(mesh, axes) if axes else None
        blocks = group_blocks(mesh, group, axes) if axes else None
        order = None if blocks is None else torch.as_tensor(blocks).argsort()
        return cls(group, index, math.prod(dims), order,
                   sizes["sp"] if sp else 1)

    def _gather(self, counts: torch.Tensor) -> torch.Tensor:
        """Every rank's ``counts`` [n, ...], in index order."""
        import torch.distributed as dist

        parts = counts.new_empty(self.n * counts.numel())
        dist.all_gather_into_tensor(parts, counts.contiguous().view(-1),
                                    group=self.group)
        parts = parts.view(self.n, *counts.shape)
        if self.order is not None:
            parts = parts[self.order.to(parts.device)]
        return parts

    def claims(self, counts: torch.Tensor):
        """This rank's per-expert claim ``counts`` [E] -> (the claims of
        the ranks before it in batch order, every rank's), both [E]."""
        if self.group is None:
            return torch.zeros_like(counts), counts
        parts = self._gather(counts)
        return parts[:self.index].sum(0), parts.sum(0)

    def row_claims(self, counts: torch.Tensor):
        """Under sp: this rank's claims per (row, expert) ``counts``
        [rows, E] -> (for each of its rows, the claims of every (row,
        chunk) before its chunk of that row in JAX's token order, [rows,
        E]; every rank's claims [E])."""
        rows, e = counts.shape
        parts = self._gather(counts).view(self.n // self.sp_n, self.sp_n,
                                          rows, e)
        flat = parts.transpose(1, 2).reshape(-1, e)  # (row, chunk) order
        before = flat.cumsum(0) - flat
        d, j = divmod(self.index, self.sp_n)
        mine = (d * rows + torch.arange(rows, device=counts.device)) \
            * self.sp_n + j
        return before[mine], flat.sum(0)


def _route(cfg: MixtralConfig, logits: torch.Tensor, capacity: int,
           routing: RoutingGroup | None = None, e0: int = 0,
           n: int | None = None, gate_conj=None, rows: int = 1):
    """Router logits [T, E] -> (dispatch, combine) [T, n, C] f32 for the
    ``n`` experts from ``e0`` (default: all), the aux (see the module
    docstring for its form under ``routing``) and every rank's claims
    per expert [E]. ``gate_conj`` wraps the renormalised gate values
    (the ep conjugate); ``rows`` is the number of rows the T tokens
    fill (read under sp)."""
    t = logits.shape[0]
    e, k, c = cfg.num_experts, cfg.top_k, capacity
    n = n or e
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [T, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    if gate_conj is not None:
        gate_vals = gate_conj(gate_vals)
    flat = F.one_hot(gate_idx, e).view(t * k, e)  # token-major, k-minor
    if routing is not None and routing.sp_n > 1:  # per row: see above
        per = flat.view(rows, -1, e)
        position = ((per.cumsum(1) - per) * per).sum(-1).view(t, k)
        before, counts = routing.row_claims(per.sum(1))
        position = position + before.repeat_interleave(
            t // rows, 0).gather(1, gate_idx)
    else:
        position = ((flat.cumsum(0) - flat) * flat).sum(-1).view(t, k)
        counts = flat.sum(0)
        if routing is not None:
            before, counts = routing.claims(counts)
            position = position + before[gate_idx]
    keep = (position < c) & (gate_idx >= e0) & (gate_idx < e0 + n)
    # Each (token, expert) holds at most one claim, so the sums below add
    # one value to zeros: JAX's one-hot einsums, bit for bit.
    idx = (gate_idx - e0).clamp(0, n - 1) * c + position.clamp(max=c - 1)
    dispatch = probs.new_zeros((t, n * c)).scatter_add_(1, idx, keep.float())
    combine = probs.new_zeros((t, n * c)).scatter_add(1, idx,
                                                      gate_vals * keep)
    kept = counts.clamp(max=c).float()  # every rank's kept claims
    token_frac = kept / kept.sum().clamp(min=1.0)
    aux = e * (token_frac * probs.mean(0)).sum()
    return dispatch.view(t, n, c), combine.view(t, n, c), aux, counts


def compute_routing(cfg: MixtralConfig, logits: torch.Tensor,
                    capacity: int):
    """Router logits [T, E] -> (dispatch [T, E, C], combine [T, E, C],
    aux), as the JAX function (one batch, every expert)."""
    return _route(cfg, logits, capacity)[:3]


def moe_block(cfg: MixtralConfig, x: torch.Tensor, lp: dict, ps=None,
              routing: RoutingGroup | None = None, stats: list | None = None):
    """Capacity-routed expert MLP. x: [B, S, H] -> ([B, S, H], aux). With
    ``routing``, x is this rank's rows of the global batch; with ``ps``
    (param sharding), ``lp`` holds this rank's blocks (module docstring).
    ``stats`` (a list) gets the batch's claims per expert [E] (every
    rank's: each expert keeps at most ``cfg.capacity(T)``)."""
    b, s, h = x.shape
    t = b * s
    dt = x.dtype
    c = cfg.capacity(t * (routing.n if routing is not None else 1))
    xt = x.reshape(t, h)
    router, w_gate, w_up, w_down = layer_weights(
        ps, lp, "router", "we_gate", "we_up", "we_down")
    logits = (xt @ router).float()
    # ep ranks on the same tokens, each on its own experts
    ep = ps is not None and ps.ep_local and not ps.ep_dispatch
    dispatch_ep = ps is not None and ps.ep_dispatch
    n = w_gate.shape[0] if ep else cfg.num_experts
    e0 = ps.ep_rank * n if ep else 0
    dispatch, combine, aux, claims = _route(
        cfg, logits, c, routing, e0, n, ps.copy_to_ep if ep else None, b)
    if stats is not None:
        stats.append(claims)
    x_e = xt
    if ps is not None:
        x_e = ps.tp_in(ps.copy_to_ep(x_e) if ep else x_e, "mlp")
    expert_in = torch.einsum("tec,th->ech", dispatch.to(dt), x_e)
    if dispatch_ep:  # every expert's slots -> this rank's experts'
        expert_in = ps.scatter_experts(expert_in)
    gate = F.silu(torch.einsum("ech,ehi->eci", expert_in, w_gate)
                  .float()).to(dt)
    up = torch.einsum("ech,ehi->eci", expert_in, w_up)
    expert_out = torch.einsum("eci,eih->ech", gate * up, w_down)
    if ps is not None:
        expert_out = ps.tp_out(expert_out, "mlp")
    if dispatch_ep:
        expert_out = ps.gather_experts(expert_out)
    y = torch.einsum("tec,ech->th", combine.to(dt), expert_out)
    if ep:
        y = ps.reduce_from_ep(y)
    return y.view(b, s, h), aux


def _moe(cfg: MixtralConfig, x, lp, ps=None, routing=None, stats=None):
    """mlp norm and the expert layer: (what it adds to the residual,
    aux)."""
    (norm,) = layer_weights(ps, lp, "mlp_norm")
    y, aux = moe_block(cfg, rms_norm(x, norm, cfg.norm_eps), lp, ps,
                       routing, stats)
    return y.to(x.dtype), aux


def _moe_half(cfg: MixtralConfig, x, o, lp, ps=None, routing=None,
              stats=None):
    x = _llama._attn_out(cfg, x, o, lp["wo"], ps)
    y, aux = _moe(cfg, x, lp, ps, routing, stats)
    return x + y, aux


def _layer(cfg: MixtralConfig, x, lp, cos, sin, attn_impl: str, ps=None,
           routing=None, stats=None, policy: str = "none", sp_axis=None):
    """One block -> (x, aux); ``policy`` as in the module docstring;
    ``sp_axis`` runs Llama's ring over its group (outside every
    segment, as flash)."""
    attn_in = partial(_llama._attn_inputs, cfg, ps=ps)
    moe_half = partial(_moe_half, cfg, ps=ps, routing=routing, stats=stats)
    if policy == "none":
        q, k, v = attn_in(x, lp, cos, sin)
        return moe_half(x, _llama._attention(cfg, q, k, v, attn_impl,
                                             sp_axis), lp)
    if policy not in ("dots", "dots+"):  # attn, attn+: recompute whole
        q, k, v = ckpt(attn_in, x, lp, cos, sin)
        o = _llama._attention(cfg, q, k, v, attn_impl, sp_axis)
        return ckpt(moe_half, x, o, lp)
    proj = ckpt_dots(partial(_llama._attn_proj, cfg, ps=ps), x, lp)
    o = _llama._attention(cfg, *_llama._rope_qkv(*proj, cos, sin),
                          attn_impl, sp_axis)
    x = _llama._attn_out(cfg, x, o, lp["wo"], ps)
    y, aux = ckpt_dots(partial(_moe, cfg, ps=ps, routing=routing,
                               stats=stats), x, lp)
    return x + y, aux


def forward_hidden(cfg: MixtralConfig, params: dict, tokens: torch.Tensor,
                   positions: torch.Tensor | None = None,
                   attn_impl: str = "flash", remat: bool | str = True,
                   param_shard=None, routing: RoutingGroup | None = None,
                   route_stats: list | None = None, sp_axis=None):
    """tokens [B, S] -> (final-norm hidden states [B, S, H], the aux
    averaged over layers). ``route_stats`` (a list) gets each layer's
    claims per expert (see :func:`moe_block`). ``sp_axis``: context
    parallel as in Llama's ``forward_hidden`` (``tokens`` this rank's
    chunk at ``positions``; ``routing`` then spans sp)."""
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
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, None,
                                device=dev)
    cos, sin = rope_cos_sin(positions, inv_freq)
    fn = _llama._remat_wrap(
        partial(_layer, cfg, cos=cos, sin=sin, attn_impl=attn_impl, ps=ps,
                routing=routing, stats=route_stats, sp_axis=sp_axis), remat)
    auxes = []
    for lp in layer_params(stacked_layers(ps, params)):
        x, aux = fn(x, lp)
        auxes.append(aux)
    if ps is None:
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    else:
        norm = ps.full(("final_norm",), params["final_norm"])
        x = ps.tp_in(rms_norm(x, norm, cfg.norm_eps), "vocab")
    return x, torch.stack(auxes).mean()


def _head(params: dict, ps) -> torch.Tensor:
    w = params["lm_head"]
    return w if ps is None else ps.full(("lm_head",), w)


def forward(cfg: MixtralConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor | None = None, attn_impl: str = "flash",
            remat: bool | str = True, param_shard=None,
            routing: RoutingGroup | None = None):
    """tokens [B, S] -> (f32 logits [B, S, V], the aux averaged over
    layers). A vocabulary-parallel head's logits are all-gathered over tp
    (each rank's columns of the gradient in the backward)."""
    ps = param_shard
    x, aux = forward_hidden(cfg, params, tokens, positions, attn_impl,
                            remat, ps, routing)
    logits = logits_f32(x, _head(params, ps))
    return (logits if ps is None else ps.gather_vocab(logits)), aux


def loss_fn(cfg: MixtralConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None,
            param_shard=None, routing: RoutingGroup | None = None,
            **fwd_kwargs) -> torch.Tensor:
    """LM cross-entropy (mean over unmasked positions) +
    ``router_aux_coef`` x the router's load-balancing loss. The LM part is
    ``ops.loss.fused_cross_entropy`` (vocabulary-parallel under tp): JAX's
    log_softmax of the f32 logits, in 512-token chunks."""
    ps = param_shard
    x, aux = forward_hidden(cfg, params, tokens, param_shard=ps,
                            routing=routing, **fwd_kwargs)
    head = _head(params, ps)
    lm = fused_cross_entropy(x, head, targets, mask,
                             **({} if ps is None else ps.vocab_parallel(head)))
    return lm + cfg.router_aux_coef * aux
