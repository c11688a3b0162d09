"""Analytic peak-memory model for Llama train-step candidates.

Port of ray_tpu/autotune/model.py, the free tier of the autotuner's
estimate: closed-form accounting from the model config alone — params,
gradients, optimizer state (``train.optim.optimizer_state_bytes`` over
meta tensors, so nothing is allocated), per-layer saved activations per
remat policy, and the fused-CE and update transients. Candidates whose
prediction exceeds the device budget are pruned before any step is built.

``predict_hbm`` is the JAX package's arithmetic, unchanged, byte for byte.
Its constants describe XLA's buffers (fusion, the layer scan's gradient
accumulators), not PyTorch's caching allocator; the measurement the port
records beside each prediction is ``torch.cuda.max_memory_allocated``
after a reset of the peak statistics. The model's error on the card is a
finding of its own (PERF.md), not tuned away here.

Accounting notes (from the JAX package):

- The layer input is always saved (it is the checkpointed function's
  argument), on top of whatever the policy keeps.
- The backward has three peaks that are MAXed, not summed: (1) the
  fused-CE backward, when every saved activation is still live but the
  layer-grad accumulators are not yet allocated; (2) the layer backward's
  start, when the stacked gradient accumulators coexist with the saved
  activations plus one layer's recompute workspace; (3) the optimizer
  update, when activations are dead and grads + the updates tree coexist.

The pruning margin lies above budget so that a few-percent overestimate
cannot drop a config that fits: a kept candidate that runs out of memory
costs one failed measurement.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import torch

from ray_tpu_torch.autotune.space import Candidate


def device_hbm_budget_bytes(device: torch.device | str | None = None
                            ) -> int | None:
    """Usable memory of the card the step will run on. RTPU_HBM_BUDGET_GB
    always wins (float GB); otherwise a CUDA device's ``total_memory``
    (default: the current card; raises without one) and None for a CPU
    device, which callers take as "do not prune"."""
    env = os.environ.get("RTPU_HBM_BUDGET_GB")
    if env:
        try:
            return int(float(env) * (1 << 30))
        except ValueError:
            pass
    from ray_tpu_torch._device import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


@dataclass
class HbmPrediction:
    total_bytes: int
    components: dict = field(default_factory=dict)

    @property
    def total_gb(self) -> float:
        return round(self.total_bytes / (1 << 30), 3)


def _policy_layer_bytes(policy: str, mb: int, seq: int, cfg,
                        flash: bool) -> int:
    """Saved-activation bytes for ONE layer under one remat policy, at
    microbatch mb (JAX's save-lists, models/llama._remat_wrap there)."""
    ab = cfg.torch_dtype.itemsize        # activation dtype (bf16 = 2)
    h = cfg.hidden_size
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    tok = mb * seq

    x_in = tok * h * ab                  # checkpointed layer input
    q = tok * qd * ab                    # rope_out q
    k = tok * kvd * ab                   # rope_out k
    v = tok * kvd * ab                   # v_out
    attn_o = tok * qd * ab               # flash out (blockwise: same shape)
    lse = mb * cfg.num_heads * seq * 4 if flash else 0
    proj = tok * h * ab                  # attn_proj
    gate = tok * inter * ab              # mlp_gate (post-silu)
    up = tok * inter * ab
    down = tok * h * ab
    norm2 = 2 * tok * h * ab

    if policy in (False, "none"):
        # save-all: dots+ plus every elementwise intermediate; ~25% on top
        # of the named tensors
        return int((x_in + 2 * q + 2 * k + v + attn_o + lse + proj + gate
                    + up + down + norm2) * 1.25)
    if policy in (True, "full"):
        return x_in
    if policy == "attn":
        return x_in + q + k + v + attn_o + lse + proj
    if policy == "attn+":
        return x_in + q + k + v + attn_o + lse + proj + gate
    if policy == "dots":
        # every matmul output + the flash residuals
        return (x_in + q + k + v + attn_o + lse + proj + gate + up + down)
    if policy == "dots+":
        # dots + norm/rope outputs (rope_out ~ q+k again)
        return (x_in + 2 * q + 2 * k + v + attn_o + lse + proj + gate + up
                + down + norm2)
    raise ValueError(f"unknown remat policy {policy!r}")


def _expand_remat(spec, num_layers: int) -> list:
    from ray_tpu_torch.models.llama import normalize_remat

    norm = normalize_remat(spec, num_layers)
    if isinstance(norm, tuple):
        return list(norm)
    return [norm] * num_layers


# Recompute-FLOPs multiplier per policy (vs no remat), used by the search
# ranking: 'attn' re-runs norms + SwiGLU, 'attn+' halves the MLP
# recompute, 'dots' only re-runs elementwise, 'full' re-runs the whole
# forward (~1/3 extra). The JAX package's ratios, kept as a prior.
POLICY_FLOPS_FACTOR = {
    "none": 1.0, False: 1.0, "dots+": 1.02, "dots": 1.05,
    "attn+": 1.11, "attn": 1.18, "full": 1.33, True: 1.33,
}


def remat_flops_factor(spec, num_layers: int) -> float:
    layers = _expand_remat(spec, num_layers)
    return sum(POLICY_FLOPS_FACTOR[p] for p in layers) / len(layers)


def _meta_params(cfg) -> dict:
    """The Llama param tree of ``cfg`` as meta tensors (the shapes and
    dtype of ``models.llama.init_params``; nothing allocated)."""
    h, v, i, L = (cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size,
                  cfg.num_layers)
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    shapes = {
        "embed_tokens": (v, h), "final_norm": (h,),
        "layers": {"wq": (L, h, qd), "wk": (L, h, kvd), "wv": (L, h, kvd),
                   "wo": (L, qd, h), "w_gate": (L, h, i), "w_up": (L, h, i),
                   "w_down": (L, i, h), "attn_norm": (L, h),
                   "mlp_norm": (L, h)},
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (h, v)

    def meta(s):
        if isinstance(s, dict):
            return {k: meta(x) for k, x in s.items()}
        return torch.empty(s, dtype=cfg.torch_dtype, device="meta")

    return meta(shapes)


@functools.lru_cache(maxsize=16)
def _optimizer_state_bytes(cfg, opt_name: str) -> int:
    """Replicated optimizer-state bytes over meta params (nothing
    allocated), for the JAX package's two optimizers: ``lowmem`` is
    ``adamw_lowmem(3e-4, weight_decay=0.1)``, anything else
    ``adamw(3e-4, weight_decay=0.1, mu_dtype=bfloat16)``."""
    from ray_tpu_torch.train.optim import (
        adamw,
        adamw_lowmem,
        optimizer_state_bytes,
    )

    if opt_name == "lowmem":
        opt = adamw_lowmem(3e-4, weight_decay=0.1)
    else:
        opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    return optimizer_state_bytes(opt, _meta_params(cfg))


def predict_hbm(cfg, seq: int, cand: Candidate,
                data_shards: int = 1) -> HbmPrediction:
    """Peak-memory prediction for one candidate on one device.

    ``data_shards``: devices the batch (and, under zero1, the optimizer
    state and weight update) shard over — 1 for one card."""
    pb = cfg.torch_dtype.itemsize
    n_params = cfg.num_params()
    mb = max(1, cand.batch // max(1, cand.grad_accum)) // max(1, data_shards)
    mb = max(1, mb)

    params = n_params * pb
    grads = n_params * pb                       # stacked accumulators
    opt_state = _optimizer_state_bytes(cfg, cand.opt)
    if cand.zero1 and data_shards > 1:
        opt_state //= data_shards

    flash = cand.attn == "flash"
    layers = _expand_remat(cand.remat, cfg.num_layers)
    acts = sum(_policy_layer_bytes(p, mb, seq, cfg, flash) for p in layers)
    # embedding output + final norm hidden (full batch lives outside the
    # per-layer checkpoint; under grad_accum only the microbatch slice is
    # in flight)
    embed = 2 * mb * seq * cfg.hidden_size * pb

    from ray_tpu_torch.ops.loss import default_ce_chunk

    # The step's own resolution order: the candidate's knob, else the
    # process's RTPU_CE_CHUNK, else 512.
    chunk = cand.ce_chunk or default_ce_chunk()
    chunk = min(chunk, seq)
    if seq % chunk:
        chunk = seq                              # ops/loss.py fallback
    v = cfg.vocab_size
    # CE backward chunk workspace: recomputed logits + softmax p + dlogits
    # at f32 (~2.5 chunks at f32), plus the f32 dhead accumulator and the
    # stacked dx output.
    ce = int(2.5 * mb * chunk * v * 4) + cfg.hidden_size * v * 4 \
        + mb * seq * cfg.hidden_size * 4
    # One layer's remat recompute workspace during the backward: re-running
    # the SwiGLU block keeps ~two f32 [mb, seq, inter] buffers in flight
    # for the recompute-heavy policies; the save-everything policies
    # recompute (almost) nothing.
    inter_f32 = mb * seq * cfg.intermediate_size * 4
    layer_tr = {
        "full": 2 * inter_f32, True: 2 * inter_f32, "attn": 2 * inter_f32,
        "attn+": inter_f32, "dots": inter_f32 // 4,
        "dots+": inter_f32 // 4, "none": 0, False: 0,
    }
    layer_transient = max(layer_tr.get(p, inter_f32) for p in layers)

    if cand.grad_accum > 1:
        # accumulation: old + new grad trees live across the add
        grads += n_params * pb
    # optimizer update: grads + the updates tree
    upd = n_params * pb

    # The three backward phases (module docstring) — max, not sum:
    backward_peak = max(
        acts + ce,                       # CE backward, grads not yet alloc'd
        acts + grads + layer_transient,  # layer backward start
        grads + upd,                     # optimizer update, acts dead
    )
    total = params + opt_state + embed + backward_peak
    return HbmPrediction(
        total_bytes=int(total),
        components={
            "params": params, "grads": grads, "opt_state": opt_state,
            "activations": acts, "embed": embed, "ce_transient": ce,
            "layer_transient": layer_transient, "update_transient": upd,
            "backward_peak": backward_peak,
        },
    )
