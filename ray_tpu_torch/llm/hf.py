"""HuggingFace Llama checkpoint import (port of ray_tpu/llm/hf.py).

Converts an HF Llama checkpoint (a directory, or an in-memory model) into
this package's stacked-layer torch params and ``LlamaConfig``, ready for
``LLMEngine(params=...)``, ``make_llama_train_step`` or ``save_pytree``.

Layout:
- torch ``Linear.weight`` is [out, in] and applied as x @ W.T; these params
  are [in, out] applied as x @ W, so every projection transposes;
- both sides use the half-split RoPE convention (HF rotate_half ==
  ops/rope.py), so q/k need no column permutation;
- per-layer tensors stack on a leading [L, ...] axis.

A directory loads through ``transformers``, imported only then: where it
is missing a directory raises ImportError, while an in-memory model (any
object with ``.config.to_dict()`` and ``.state_dict()``) converts without
it.
"""

from __future__ import annotations

import os

import torch

from ray_tpu_torch.models.llama import LlamaConfig

# HF tensor name -> (this package's layer-param name, transpose?)
_LAYER_MAP = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
}


def config_from_hf(hf_cfg: dict, dtype: str | None = None) -> LlamaConfig:
    """LlamaConfig from an HF ``config.json`` dict."""
    head_dim = hf_cfg.get("head_dim") or (
        hf_cfg["hidden_size"] // hf_cfg["num_attention_heads"])
    scaling = None
    rs = hf_cfg.get("rope_scaling")
    if rs:
        kind = rs.get("rope_type", rs.get("type"))
        if kind == "llama3":
            scaling = {
                "factor": rs["factor"],
                "low_freq_factor": rs.get("low_freq_factor", 1.0),
                "high_freq_factor": rs.get("high_freq_factor", 4.0),
                "original_max_position": rs.get(
                    "original_max_position_embeddings", 8192),
            }
        elif kind not in (None, "default"):
            # linear/dynamic/yarn etc.: dropping the scaling would give
            # wrong positions past the original context length.
            raise ValueError(
                f"unsupported rope_scaling type {kind!r} (only 'llama3' "
                f"frequency scaling is implemented)")
    return LlamaConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        num_kv_heads=hf_cfg.get("num_key_value_heads",
                                hf_cfg["num_attention_heads"]),
        head_dim=head_dim,
        max_seq_len=hf_cfg.get("max_position_embeddings", 8192),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),  # HF default
        rope_scaling=scaling,
        norm_eps=hf_cfg.get("rms_norm_eps", 1e-6),  # HF default
        tie_embeddings=bool(hf_cfg.get("tie_word_embeddings", False)),
        dtype=dtype or "bfloat16",
    )


class _LazyStateDict:
    """Tensor-at-a-time view of a state dict: each take() hands out ONE
    tensor in f32 on the CPU and drops the reference, so conversion peaks
    near one model copy rather than three."""

    def __init__(self, model):
        self._sd = dict(model.state_dict())

    def take(self, name: str) -> torch.Tensor:
        return self._sd.pop(name).detach().to("cpu", torch.float32)


def convert_hf_llama(source, dtype: str | None = None
                     ) -> tuple[LlamaConfig, dict]:
    """Convert an HF Llama checkpoint to (LlamaConfig, params).

    ``source``: a checkpoint directory (config.json + safetensors/bin,
    loaded through transformers) or an in-memory model. ``dtype``: the
    params' dtype (default bfloat16). The params are CPU tensors.
    """
    if isinstance(source, (str, os.PathLike)):
        try:
            from transformers import AutoModelForCausalLM
        except ImportError as e:
            raise ImportError(
                "loading an HF checkpoint directory needs the "
                "'transformers' package; convert an in-memory model "
                "instead") from e
        model = AutoModelForCausalLM.from_pretrained(source)
        # transformers' filled config, not the raw config.json: older
        # checkpoints omit keys (rope_theta) whose HF defaults differ.
        hf_cfg = model.config.to_dict()
    else:
        model = source
        hf_cfg = source.config.to_dict()
    sd = _LazyStateDict(model)
    cfg = config_from_hf(hf_cfg, dtype)
    dt = cfg.torch_dtype

    def take(name: str, transpose: bool) -> torch.Tensor:
        w = sd.take(name)
        return w.t().contiguous() if transpose else w

    layers = {}
    for hf_name, (ours, tr) in _LAYER_MAP.items():
        # Stack then cast one parameter at a time: its f32 staging is
        # freed before the next converts.
        layers[ours] = torch.stack(
            [take(f"model.layers.{i}.{hf_name}", tr)
             for i in range(cfg.num_layers)]).to(dt)
    params = {
        "embed_tokens": sd.take("model.embed_tokens.weight").to(dt),
        "final_norm": sd.take("model.norm.weight").to(dt),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sd.take("lm_head.weight").t().contiguous().to(dt)
    return cfg, params
