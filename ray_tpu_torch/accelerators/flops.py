"""Peak rates and FLOP counts for the MFU the port reports.

The JAX package's table (ray_tpu/accelerators/flops.py) lists TPU
generations only. This one lists the NVIDIA card the port runs on, from
its data sheet (H100 SXM, dense, at the full 700 W power limit), and
counts a Llama, a Mixtral and a ViT training step's FLOPs from their
shapes.
"""

from __future__ import annotations

# Per-card peak dense FLOP/s (NVIDIA H100 SXM data sheet).
PEAK_FLOPS: dict[str, dict[str, float]] = {
    "h100": {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12,
             "tf32": 495e12, "fp32": 67e12},
}


def peak_flops(generation: str, dtype: str = "bf16") -> float:
    """Table lookup; 0.0 for an unknown card or dtype, so callers can gate
    an MFU on truthiness rather than publish a made-up ratio."""
    return PEAK_FLOPS.get(generation.lower().strip(), {}).get(dtype) or 0.0


def generation_of(device_name: str) -> str | None:
    """Table key for a ``torch.cuda.get_device_name`` string."""
    return "h100" if "H100" in device_name.upper() else None


def attention_flops(batch: int, heads: int, seq: int, head_dim: int,
                    causal: bool = True) -> float:
    """One attention forward: the two products q.k^T and p.v, halved when
    causal (the masked half is skipped)."""
    full = 4.0 * batch * heads * seq * seq * head_dim
    return full / 2 if causal else full


def llama_train_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step: 6 * params * tokens for the matrix
    products (forward and backward; the tied head counted once, as
    ``num_params`` counts it), plus 3x each layer's causal attention
    forward. Remat's recomputation is not counted (MFU convention)."""
    dense = 6.0 * cfg.num_params() * batch * seq
    attn = 3.0 * cfg.num_layers * attention_flops(
        batch, cfg.num_heads, seq, cfg.head_dim, causal=True)
    return dense + attn


def mixtral_train_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one Mixtral training step: 6 * the active params (each
    token's top-k experts, ``num_params(active=True)``) * tokens, plus 3x
    each layer's causal attention forward. The one-hot dispatch and
    combine products, the capacity's padded slots and remat's
    recomputation are not counted (MFU convention: the model's work,
    not this design's)."""
    dense = 6.0 * cfg.num_params(active=True) * batch * seq
    attn = 3.0 * cfg.num_layers * attention_flops(
        batch, cfg.num_heads, seq, cfg.head_dim, causal=True)
    return dense + attn


def vit_train_flops(cfg, batch: int) -> float:
    """FLOPs of one ViT training step over ``batch`` images: 6 * the
    matrix-product parameters * the tokens each one sees (forward and
    backward): the patch embedding over the patches, the layers' q/k/v/o
    and MLP weights over the patches and the class token, the head over the
    class token alone; plus 3x each layer's non-causal attention forward.
    Norm weights, the position table and the class token are not products
    and not counted, nor is remat's recomputation (MFU convention)."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    n = cfg.num_patches
    patch_in = cfg.patch_size**2 * cfg.num_channels
    dense = 6.0 * batch * (patch_in * h * n
                           + L * (4 * h * h + 2 * h * i) * (n + 1)
                           + h * cfg.num_classes)
    attn = 3.0 * L * attention_flops(batch, cfg.num_heads, n + 1,
                                     cfg.head_dim, causal=False)
    return dense + attn


def resolve_peak_flops(dtype: str = "bf16") -> float:
    """The per-card peak the train MFU gauge divides by: ``RTPU_PEAK_FLOPS``
    when set, else the table's entry for the card this process has
    initialized CUDA on; 0.0 when neither is known (no MFU is published)."""
    import os
    import sys

    env = os.environ.get("RTPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0.0
    gen = generation_of(torch.cuda.get_device_name())
    return peak_flops(gen, dtype) if gen else 0.0
