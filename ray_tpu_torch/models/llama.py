"""Llama-3 family geometry and parameters for the PyTorch port.

Port of the serving half of ray_tpu/models/llama.py: ``LlamaConfig`` (same
fields and presets), ``init_params`` and ``params_from_jax``. The param
tree keeps the JAX layout exactly: a dict with layer weights stacked on a
leading ``[L, ...]`` axis and matmuls written ``x @ W[in, out]``, so a tree
made by the JAX package's ``init_params`` converts leaf by leaf with no
transposes. The training forward, loss and remat come with the training
slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device, tree_map


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
