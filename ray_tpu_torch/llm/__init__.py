"""ray_tpu_torch.llm: the LLM serving engine on PyTorch (port of
ray_tpu.llm): continuous batching over a dense slot KV cache or a block
pool with preemption, chunked prefill, burst decode with pipelined
chaining, on-device sampling, prefix-cache reuse, speculative decoding,
tensor parallelism over processes (llm/tp.py),
the prefill/decode KV hand-off (llm/pd.py) and checkpoint loading
(llm/hf.py for HF Llama directories), and the OpenAI-compatible serve app
(``build_openai_app``, ``build_llm_deployment``)."""

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import GenerationResult, LLMEngine
from ray_tpu_torch.llm.serving import (
    LLMServer,
    build_llm_deployment,
    build_openai_app,
)
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = [
    "LLMConfig", "SamplingParams", "LLMEngine", "GenerationResult",
    "LLMServer", "build_llm_deployment", "build_openai_app",
    "ByteTokenizer", "get_tokenizer",
]
