"""LLM configs for the PyTorch engine.

Port of ray_tpu/llm/config.py. Not served yet, each raising
``NotImplementedError`` when the engine is built (and at once in
``build_llm_deployment``): a ``placement_group_config`` (gang placement
groups, ROADMAP Queue A item 7(b)) and a non-empty ``engine_kwargs`` (the
engine takes its options as the fields below; the JAX package's engine
reads none either). ``tensor_parallel_size > 1`` serves: llm/tp.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

from ray_tpu_torch.models.llama import LlamaConfig


@dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 → disabled
    stop_token_ids: tuple[int, ...] = ()


@dataclass
class LLMConfig:
    model: LlamaConfig | str = "tiny"  # a config or a named geometry
    tokenizer: str = "byte"            # "byte" or a HF tokenizer path
    max_num_seqs: int = 8              # continuous-batching slots
    max_seq_len: int | None = None     # default: model.max_seq_len
    dtype: str | None = None           # default: model.dtype
    # Ranks the model is split over (heads, MLP, vocabulary): rank r a
    # process on cuda:r (llm/tp.py); > the visible cards raises ValueError.
    tensor_parallel_size: int = 1
    # An HF Llama directory (config.json + weights, through llm/hf.py; its
    # geometry replaces ``model``) or a save_pytree (DCP) directory;
    # None → seeded random init.
    checkpoint_path: str | None = None
    seed: int = 0
    prefill_bucket_min: int = 16
    # Chunked prefill: long prompts prefill in chunks of this many tokens so
    # active decodes run between chunks.
    prefill_chunk: int = 512
    engine_kwargs: dict[str, Any] = field(default_factory=dict)
    # Per-replica gang placement: {"bundles": [{...}, ...], "strategy": ...}.
    placement_group_config: dict | None = None
    # Speculative decoding: a draft model proposes speculative_tokens
    # greedily and the target verifies them in one forward. Greedy
    # (temperature 0) requests only; their output equals plain greedy.
    speculative_model: LlamaConfig | str | None = None
    speculative_tokens: int = 4
    speculative_checkpoint_path: str | None = None  # DCP or HF directory
    # Burst decoding: up to this many decode+sample steps per dispatch, the
    # sampled token fed forward on the device; adapts down in powers of two
    # near token budgets. A top-k request falls back to single steps.
    decode_burst: int = 8
    # Pipeline bursts: in steady decode, dispatch the NEXT burst before the
    # current one's tokens are fetched (output is identical).
    decode_pipeline: bool = True
    # Prefill chunks dispatched per scheduler tick (first-token fetches are
    # deferred past the tick's decode dispatch).
    prefill_chunks_per_tick: int = 4
    # Block-pooled KV cache (vLLM PagedAttention's capability): K/V live in
    # a pool of fixed-size blocks addressed through per-slot block tables,
    # so the same memory serves ~2x the slots; on pool exhaustion the
    # newest request is preempted and later re-prefilled. 0 = dense lines.
    kv_block_size: int = 0
    # Blocks in the pool; 0 = auto (max_num_seqs x max_seq_len / 2 tokens).
    kv_num_blocks: int = 0
    # Prefix-cache publication granularity (serve/prefix.py chain hashes);
    # 0 disables publication.
    prefix_block_tokens: int = 32
    # Prefill/decode KV hand-off transport (llm/pd.py): "inline" ships the
    # KV tensors in the payload; "store" (the JAX package's default, over
    # its object plane) is not ported and raises NotImplementedError.
    pd_transfer_mode: str = "store"

    def model_config(self) -> LlamaConfig:
        return _resolve_model(self.model, self.dtype)

    def draft_model_config(self) -> LlamaConfig | None:
        if self.speculative_model is None:
            return None
        return _resolve_model(self.speculative_model, self.dtype)


def _resolve_model(model: "LlamaConfig | str",
                   dtype: str | None) -> LlamaConfig:
    if isinstance(model, LlamaConfig):
        cfg = model
    elif model == "tiny":
        # vocab 512 so the byte tokenizer (256 bytes + specials) fits
        cfg = replace(LlamaConfig.tiny(), vocab_size=512)
    elif model in ("llama3-8b", "llama3_8b"):
        cfg = LlamaConfig.llama3_8b()
    elif model in ("llama3-1b", "llama3_1b"):
        cfg = LlamaConfig.llama3_1b()
    else:
        raise ValueError(f"unknown model {model!r}")
    if dtype is not None and cfg.dtype != dtype:
        cfg = replace(cfg, dtype=dtype)
    return cfg
