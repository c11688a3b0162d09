"""LLM serving: an OpenAI-compatible app over serve deployments.

Port of ray_tpu/llm/serving.py. One ``LLMServer`` = one engine instance,
which batches across the server's concurrent requests and takes every
engine option of ``LLMConfig`` (blocked KV, speculative decoding,
checkpoints). ``build_openai_app(cfg)`` is the server as a serve
application: ``serve.run(build_openai_app(cfg), route_prefix="/",
http=True)`` answers ``POST /v1/completions``, ``POST
/v1/chat/completions`` (``"stream": true`` too, as SSE) and ``GET
/v1/models`` through the HTTP proxy, handle, router and replica.
``build_llm_deployment`` and ``build_openai_app`` take ``device``
(default ``"cuda"``) and bind it to the server.

A stream's reader that goes away (a client closing its connection)
cancels the engine request, which then finishes at its next token; a
stream whose engine stopped raises instead of waiting forever. A server
that is collected without ``shutdown()`` (its replica killed) stops its
engine then.

Out, for a later PR: ``PDServer``, ``build_pd_openai_app`` and the
``"store"`` transfer (ROADMAP Queue A item 6); the prefill/decode servers
of llm/pd.py run without serve. Raising at once, with the engine's own
check: a ``placement_group_config`` (item 7(b)) and a non-empty
``engine_kwargs``. A ``tensor_parallel_size > 1`` replica starts its
engine's followers on cards 1..n-1 (rank 0 on cuda:0) and ends them in
``shutdown()``.
"""

from __future__ import annotations

import json
import time
import weakref
from typing import Any

import torch

from ray_tpu_torch import serve
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import LLMEngine, _unported

# How long a stream waits for its next token before it checks that the
# engine still runs.
_STREAM_POLL_S = 1.0


class LLMServer:
    def __init__(self, llm_config: LLMConfig, params=None,
                 device: torch.device | str = "cuda"):
        self.config = llm_config
        self.engine = LLMEngine(llm_config, params=params, device=device)
        # The engine's scheduler thread holds the engine, not the server: a
        # server dropped without shutdown() (its replica killed) stops the
        # engine when it is collected, so the card memory still comes back.
        weakref.finalize(self, self.engine.shutdown).atexit = False
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

    def _tokens(self, req):
        """The request's tokens as the engine emits them. A reader that
        stops early (the generator is closed) cancels the request; an
        engine that stopped mid-request raises."""
        try:
            while True:
                try:
                    item = req.stream_queue.get(timeout=_STREAM_POLL_S)
                except Exception:  # noqa: BLE001 - queue.Empty: poll again
                    if not self.engine._thread.is_alive():
                        raise RuntimeError(
                            "the engine stopped mid-request") from None
                    continue
                if item is None:
                    break
                yield item
        finally:
            if req.finish_reason is None:
                self.engine.cancel(req)

    def chat_stream(self, messages: list[dict], **kw):
        """SSE frames of OpenAI chat.completion.chunk objects."""
        sampling = _sampling_from(kw)
        prompt = self.engine.tokenizer.apply_chat_template(messages)
        req = self.engine.submit(prompt, sampling, stream=True)
        rid = f"chatcmpl-{req.request_id}"
        for item in self._tokens(req):
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

    def completions_stream(self, prompt: str, **kw):
        sampling = _sampling_from(kw)
        req = self.engine.submit(prompt, sampling, stream=True)
        rid = f"cmpl-{req.request_id}"
        for item in self._tokens(req):
            frame = {"id": rid, "object": "text_completion",
                     "model": self._model_id,
                     "choices": [{"index": 0,
                                  "text": self.engine.tokenizer.decode([item]),
                                  "finish_reason": None}]}
            yield f"data: {json.dumps(frame)}\n\n"
        done = {"id": rid, "object": "text_completion",
                "model": self._model_id,
                "choices": [{"index": 0, "text": "",
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
        """What a serve replica publishes for this server (the
        ServeReplica.router_meta contract): the prefix blocks, or None
        when publication is off."""
        return self.router_prefix_blocks() or None

    def check_health(self) -> None:
        if not self.engine._thread.is_alive():
            raise RuntimeError("engine scheduler thread died")
        if self.engine.error is not None:  # a tp rank failed
            raise RuntimeError(self.engine.error)

    def shutdown(self) -> None:
        """Stop the engine's scheduler thread and its tp followers (a serve
        replica calls this when the controller stops it, so the card
        memory comes back)."""
        self.engine.shutdown()

    # -- HTTP ingress (OpenAI surface) --

    def __call__(self, request: "serve.Request") -> Any:
        path = request.path
        if path.endswith("/v1/models") or path == "/models":
            return {"object": "list",
                    "data": [{"id": self._model_id, "object": "model",
                              "created": int(time.time()),
                              "owned_by": "ray_tpu"}]}
        body = request.json() or {}
        stream = bool(body.pop("stream", False))
        if path.endswith("/v1/completions") or path == "/completions":
            prompt = body.pop("prompt", "")
            if stream:
                return self.completions_stream(prompt, **body)
            return self.completions(prompt, **body)
        if path.endswith("/v1/chat/completions") or path == "/chat/completions":
            messages = body.pop("messages", [])
            if stream:
                return self.chat_stream(messages, **body)
            return self.chat(messages, **body)
        return {"error": {"message": f"no route {path}", "code": 404}}


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


def build_llm_deployment(llm_config: LLMConfig, *,
                         name: str = "LLMServer",
                         num_replicas: int = 1,
                         max_ongoing_requests: int | None = None,
                         autoscaling_config: Any = None,
                         ray_actor_options: dict | None = None):
    """The LLMServer as a serve deployment; ``ray_actor_options={"num_gpus":
    1}`` gives each replica the runtime's ``"GPU"`` resource (start it with
    ``init(resources={"GPU": n})``)."""
    _unported(llm_config)
    return serve.deployment(
        name=name,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests or llm_config.max_num_seqs,
        autoscaling_config=autoscaling_config,
        ray_actor_options=ray_actor_options,
        health_check_period_s=2.0,
    )(LLMServer)


def build_openai_app(llm_config: LLMConfig, *,
                     device: torch.device | str = "cuda",
                     **deploy_kw) -> "serve.Application":
    """OpenAI-compatible application: ``serve.run(build_openai_app(cfg),
    route_prefix="/", http=True)``. Each replica builds its engine on
    ``device``."""
    dep = build_llm_deployment(llm_config, **deploy_kw)
    return dep.bind(llm_config, device=device)
