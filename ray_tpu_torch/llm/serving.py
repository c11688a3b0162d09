"""LLM serving surface over the PyTorch engine (port of the handle API of
ray_tpu/llm/serving.py). One ``LLMServer`` = one engine instance, which
batches across the server's concurrent requests and takes every engine
option of ``LLMConfig`` (blocked KV, speculative decoding, checkpoints;
tensor parallelism raises). The prefill/decode servers are in llm/pd.py.
``build_llm_deployment``, ``build_openai_app`` and the HTTP ingress sit on
the JAX package's serve stack and are not ported yet.
"""

from __future__ import annotations

import json

import torch

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import LLMEngine


class LLMServer:
    def __init__(self, llm_config: LLMConfig, params=None,
                 device: torch.device | str = "cuda"):
        self.config = llm_config
        self.engine = LLMEngine(llm_config, params=params, device=device)
        self._model_id = (llm_config.model if isinstance(llm_config.model, str)
                          else "llama")

    def completions(self, prompt: str, **kw) -> dict:
        sampling = _sampling_from(kw)
        res = self.engine.generate(prompt, sampling)
        return {
            "id": f"cmpl-{res.request_id}",
            "object": "text_completion",
            "model": self._model_id,
            "choices": [{"index": 0, "text": res.text,
                         "finish_reason": res.finish_reason}],
            "usage": _usage(res),
        }

    def chat(self, messages: list[dict], **kw) -> dict:
        sampling = _sampling_from(kw)
        prompt = self.engine.tokenizer.apply_chat_template(messages)
        res = self.engine.generate(prompt, sampling)
        return {
            "id": f"chatcmpl-{res.request_id}",
            "object": "chat.completion",
            "model": self._model_id,
            "choices": [{"index": 0,
                         "message": {"role": "assistant", "content": res.text},
                         "finish_reason": res.finish_reason}],
            "usage": _usage(res),
        }

    def chat_stream(self, messages: list[dict], **kw):
        """SSE frames of OpenAI chat.completion.chunk objects."""
        sampling = _sampling_from(kw)
        prompt = self.engine.tokenizer.apply_chat_template(messages)
        req = self.engine.submit(prompt, sampling, stream=True)
        rid = f"chatcmpl-{req.request_id}"
        while True:
            item = req.stream_queue.get()
            if item is None:
                break
            frame = {"id": rid, "object": "chat.completion.chunk",
                     "model": self._model_id,
                     "choices": [{"index": 0,
                                  "delta": {"content":
                                            self.engine.tokenizer.decode([item])},
                                  "finish_reason": None}]}
            yield f"data: {json.dumps(frame)}\n\n"
        done = {"id": rid, "object": "chat.completion.chunk",
                "model": self._model_id,
                "choices": [{"index": 0, "delta": {},
                             "finish_reason": req.finish_reason or "stop"}]}
        yield f"data: {json.dumps(done)}\n\n"
        yield "data: [DONE]\n\n"

    def stats(self) -> dict:
        return self.engine.stats()

    def router_prefix_blocks(self) -> dict | None:
        """KV-block-aware routing publication (what a serve replica's
        router_meta reads): {"blocks": [...], "block": n} or None."""
        return self.engine.router_prefix_blocks()

    def router_meta(self) -> dict | None:
        """What a serve replica publishes for this server (the JAX
        package's ServeReplica.router_meta contract): the prefix blocks,
        or None when publication is off."""
        return self.router_prefix_blocks() or None

    def check_health(self) -> None:
        if not self.engine._thread.is_alive():
            raise RuntimeError("engine scheduler thread died")

    def shutdown(self) -> None:
        self.engine.shutdown()


def _usage(res) -> dict:
    return {"prompt_tokens": len(res.prompt_ids),
            "completion_tokens": len(res.token_ids),
            "total_tokens": len(res.prompt_ids) + len(res.token_ids)}


def _sampling_from(kw: dict) -> SamplingParams:
    return SamplingParams(
        max_tokens=int(kw.get("max_tokens", 64)),
        temperature=float(kw.get("temperature", 0.0)),
        top_p=float(kw.get("top_p", 1.0)),
        top_k=int(kw.get("top_k", 0)),
    )
