"""ray_tpu_torch.llm: the LLM serving engine on PyTorch (port of
ray_tpu.llm): continuous batching over a dense slot KV cache or a block
pool with preemption, chunked prefill, burst decode with pipelined
chaining, on-device sampling, prefix-cache reuse, speculative decoding,
the prefill/decode KV hand-off (llm/pd.py) and checkpoint loading
(llm/hf.py for HF Llama directories)."""

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import GenerationResult, LLMEngine
from ray_tpu_torch.llm.serving import LLMServer
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = [
    "LLMConfig", "SamplingParams", "LLMEngine", "GenerationResult",
    "LLMServer", "ByteTokenizer", "get_tokenizer",
]
