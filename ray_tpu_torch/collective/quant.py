"""Bucketed int8 quantization: the wire format of the training step's
quantized cross-slice (dcn) gradient stage (EQuARX-style, arxiv
2506.17615).

Port of ray_tpu/collective/xla_backend.py's ``quantize_int8_bucketed``,
``quantize_int8_buckets`` and ``dequantize_int8_buckets``: one f32 scale
per bucket of contiguous elements (its largest magnitude over 127, 1
where the bucket is all zeros), values rounded half to even.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quantize_int8_bucketed(grouped: torch.Tensor):
    """``grouped`` carries buckets on its last dim; returns ``(int8 values,
    f32 scales)`` with the scale dim kept (size 1)."""
    grouped = grouped.float()
    scale = grouped.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.round(grouped / scale).to(torch.int8), scale


def quantize_int8_buckets(x: torch.Tensor, bucket: int = 256):
    """Flatten ``x`` and quantize with one f32 scale per ``bucket``
    contiguous elements: ``(q [n_buckets, bucket] int8, scales
    [n_buckets, 1] f32)``. The flat length pads with zeros to a bucket
    multiple; callers slice back after dequantizing."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % bucket
    if pad:
        flat = F.pad(flat, (0, pad))
    return quantize_int8_bucketed(flat.view(-1, bucket))


def dequantize_int8_buckets(q: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_buckets` (still bucket-shaped)."""
    return q.float() * scales
