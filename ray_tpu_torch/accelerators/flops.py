"""Peak rates and FLOP counts for the MFU the port reports.

The JAX package's table (ray_tpu/accelerators/flops.py) lists TPU
generations only. This one lists the NVIDIA card the port runs on, from
its data sheet (H100 SXM, dense, at the full 700 W power limit), and
counts a Llama training step's FLOPs from its shapes.
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
