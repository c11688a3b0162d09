"""Prefill/decode disaggregation (port of ray_tpu/llm/pd.py).

A prefill server computes the prompt's KV and first token
(``LLMEngine.prefill_only``), the payload carries them, and a decode server
continues generation from it (``LLMEngine.submit_prefilled``). Prefill
engines never decode and decode engines never prefill: the latency
isolation that motivates the pattern.

Transport (``LLMConfig.pd_transfer_mode``): ``"inline"`` ships the KV
tensors in the payload itself. ``"store"`` (the JAX package's object-plane
ndarrays) and the ``PDServer`` ingress with ``build_pd_openai_app`` need the
object plane and serve handles, which are not ported: "store" raises
NotImplementedError.
"""

from __future__ import annotations

import threading

import torch

from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.llm.serving import _sampling_from
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter

_MODES = ("store", "inline")


class _Counter(Counter):
    """A ``util.metrics`` counter that also reads one series back."""

    def value(self, tags: dict | None = None) -> float:
        return self._points().get(self._series_key(tags), 0.0)


_kv_metrics = None
_kv_bound: dict = {}
_kv_lock = threading.Lock()


def kv_metrics() -> dict:
    """KV hand-off accounting: ``llm_kv_handoff_bytes{path}`` counts the
    payload's KV bytes by transport, ``llm_kv_serialized_bytes`` the bytes
    that cross a serialize/deserialize copy (every inline byte), and
    ``llm_kv_handoffs_total{path}`` the hand-offs."""
    global _kv_metrics
    with _kv_lock:
        if _kv_metrics is None:
            _kv_metrics = {
                "bytes": _Counter(
                    "llm_kv_handoff_bytes",
                    "prompt-KV bytes handed from prefill to decode engines",
                    tag_keys=("path",)),
                "serialized": _Counter(
                    "llm_kv_serialized_bytes",
                    "prompt-KV bytes that crossed a serialize/deserialize "
                    "copy during hand-off"),
                "handoffs": _Counter(
                    "llm_kv_handoffs_total",
                    "disaggregated prefill->decode hand-offs",
                    tag_keys=("path",)),
            }
        return _kv_metrics


def kv_bound(mode: str) -> dict:
    """The hand-off counters with ``path=mode`` bound once per process."""
    bound = _kv_bound.get(mode)
    if bound is None:
        mtr = kv_metrics()
        bound = _kv_bound[mode] = {
            "bytes": mtr["bytes"].bound({"path": mode}),
            "handoffs": mtr["handoffs"].bound({"path": mode}),
            "serialized": mtr["serialized"].bound(),
        }
    return bound


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown pd_transfer_mode {mode!r}: expected "
                         f"'store' or 'inline'")
    if mode == "store":
        raise NotImplementedError(
            "pd_transfer_mode='store' needs the object plane (ray_tpu.put "
            "and get), which is not ported to ray_tpu_torch; use 'inline'")


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else a.nbytes


def export_kv_payload(payload: dict, mode: str) -> dict:
    """Count a payload's KV bytes for ``mode`` and hand it on: inline
    payloads travel as they are. "store" raises NotImplementedError."""
    _check_mode(mode)
    mtr = kv_bound(mode)
    nbytes = _nbytes(payload["kv_k"]) + _nbytes(payload["kv_v"])
    # KV hand-off phase span: nests under the prefill replica's worker
    # span (same thread), so the trace shows the export side of the P/D
    # hop and its transport.
    with tracing.span("llm.kv_export",
                      attributes={"path": mode, "bytes": nbytes}):
        mtr["bytes"].inc(nbytes)
        mtr["serialized"].inc(nbytes)  # rides the call inside the payload
        mtr["handoffs"].inc()
        return payload


def resolve_kv_payload(payload: dict) -> dict:
    """The payload's KV as tensors: inline payloads pass through; a
    store-mode payload (object refs) raises NotImplementedError."""
    if "kv_ref_k" in payload:
        _check_mode("store")
    return payload


class PrefillServer:
    """Computes the prompt's KV and first token; runs no decode loop."""

    def __init__(self, llm_config: LLMConfig, params=None,
                 device: torch.device | str = "cuda"):
        self._mode = llm_config.pd_transfer_mode
        _check_mode(self._mode)
        self.engine = LLMEngine(llm_config, params=params, device=device)

    def prefill(self, prompt_ids: list[int], sampling_kw: dict) -> dict:
        payload = self.engine.prefill_only(prompt_ids,
                                           _sampling_from(sampling_kw))
        return export_kv_payload(payload, self._mode)

    def router_prefix_blocks(self) -> dict | None:
        """The engine's cached-prefix block hashes, for prefix routing."""
        return self.engine.router_prefix_blocks()

    def check_health(self) -> None:
        if not self.engine._thread.is_alive():
            raise RuntimeError("prefill engine died")

    def shutdown(self) -> None:
        self.engine.shutdown()


class DecodeServer:
    """Continues generation from shipped KV; never prefills."""

    def __init__(self, llm_config: LLMConfig, params=None,
                 device: torch.device | str = "cuda"):
        self.engine = LLMEngine(llm_config, params=params, device=device)

    def decode(self, payload: dict, sampling_kw: dict) -> dict:
        req = self.engine.submit_prefilled(
            resolve_kv_payload(payload), _sampling_from(sampling_kw))
        if not req.done.wait(300):
            raise TimeoutError("decode timed out")
        if req.error:
            raise RuntimeError(req.error)
        res = self.engine._result(req)
        return {"token_ids": res.token_ids, "text": res.text,
                "finish_reason": res.finish_reason}

    def decode_stream(self, payload: dict, sampling_kw: dict):
        req = self.engine.submit_prefilled(
            resolve_kv_payload(payload), _sampling_from(sampling_kw),
            stream=True)
        while True:
            item = req.stream_queue.get()
            if item is None:
                break
            yield self.engine.tokenizer.decode([item])
        yield ("__finish__", req.finish_reason or "stop")

    def check_health(self) -> None:
        if not self.engine._thread.is_alive():
            raise RuntimeError("decode engine died")

    def shutdown(self) -> None:
        self.engine.shutdown()
