"""Batch LLM inference over Datasets.

Capability parity with the reference's ray.data.llm (reference:
python/ray/data/llm.py:28 ProcessorConfig → ray.llm._internal.batch
processor.base:293 Processor — a map_batches pipeline of chat-template →
tokenize → engine → detokenize stages over an actor pool): here one stage
holds the port's continuous-batching engine; tokenize/detokenize ride
inside it (the engine's tokenizer), and the actor pool gives each worker a
long-lived engine on the card.

Port of ray_tpu/data/llm.py. The engine's device is explicit (``"cuda"``
unless the caller asks for the CPU), and ``params`` (a tree of tensors or
arrays) may be handed to every pool actor's engine; without them each
engine makes the seeded init of ``llm_config``. ``num_gpus`` is what each
pool actor demands of the runtime's ``"GPU"`` resource. An actor that
ends (the pool's shutdown) drops its stage, whose engine then stops.

Usage:
    processor = build_llm_processor(LLMConfig(model=...), concurrency=1)
    ds = ray_tpu_torch.data.from_items([{"prompt": "..."}, ...])
    out = processor(ds)            # adds "generated_text" (+ token counts)
    out.take_all()
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class ProcessorConfig:
    """Batch-inference knobs (reference: ProcessorConfig, data/llm.py:28)."""

    batch_size: int = 16
    concurrency: int = 1
    prompt_column: str = "prompt"
    output_column: str = "generated_text"
    sampling: dict = field(default_factory=dict)  # max_tokens/temperature/…
    apply_chat_template: bool = False
    # The port's addition: a "generated_token_ids" column (object array of
    # int lists) beside the text, for callers that compare token streams.
    include_token_ids: bool = False


class _EngineStage:
    """map_batches callable class: one LLMEngine per actor, reused across
    batches (reference: vllm_engine_stage.py — the engine outlives blocks).
    The engine's scheduler thread stops when the stage is collected."""

    def __init__(self, llm_config, proc: ProcessorConfig, params=None,
                 device: str = "cuda"):
        from ray_tpu_torch.llm import LLMEngine, SamplingParams

        self.engine = LLMEngine(llm_config, params=params, device=device)
        self.proc = proc
        self.sampling = SamplingParams(**proc.sampling)
        weakref.finalize(self, self.engine.shutdown)

    def __call__(self, batch: dict) -> dict:
        prompts = [str(p) for p in batch[self.proc.prompt_column]]
        if self.proc.apply_chat_template:
            prompts = [self.engine.tokenizer.apply_chat_template(
                [{"role": "user", "content": p}]) for p in prompts]
        # Submit the whole batch; the engine's continuous batching fills its
        # slots and interleaves decodes.
        reqs = [self.engine.submit(p, self.sampling) for p in prompts]
        texts, ntok, ids = [], [], []
        for req in reqs:
            if not req.done.wait(timeout=600):
                raise TimeoutError(
                    f"generation {req.request_id} did not finish in 600s")
            if req.error:
                raise RuntimeError(req.error)
            res = self.engine._result(req)
            texts.append(res.text)
            ntok.append(len(res.token_ids))
            ids.append(list(res.token_ids))
        out = dict(batch)
        out[self.proc.output_column] = np.asarray(texts, dtype=object)
        out["num_generated_tokens"] = np.asarray(ntok)
        if self.proc.include_token_ids:
            col = np.empty(len(ids), dtype=object)
            for i, v in enumerate(ids):
                col[i] = v
            out["generated_token_ids"] = col
        return out


def build_llm_processor(llm_config, *, config: ProcessorConfig | None = None,
                        params=None, device: str = "cuda",
                        num_gpus: float = 0.0,
                        **overrides) -> Any:
    """Returns processor(dataset) -> dataset with generations appended.
    ``num_gpus`` is each pool actor's demand of the runtime's "GPU"
    resource (0, as ray_tpu's pool asks for no TPU)."""
    from ray_tpu_torch.data.executor import ActorPoolStrategy

    proc = config or ProcessorConfig(**overrides)

    def processor(ds):
        return ds.map_batches(
            _EngineStage,
            fn_constructor_args=(llm_config, proc, params, device),
            batch_size=proc.batch_size,
            compute=ActorPoolStrategy(size=proc.concurrency,
                                      num_gpus=num_gpus),
        )

    return processor
