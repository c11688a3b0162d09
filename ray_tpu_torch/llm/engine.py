"""PyTorch LLM inference engine: continuous batching over a slot KV cache.

Port of ray_tpu/llm/engine.py (dense KV layout) to PyTorch on a CUDA card.
The design is the JAX engine's:

- The KV cache is a dense [layers, slots, kv_heads, max_seq, head_dim]
  pool; a sequence owns one slot for its lifetime.
- Continuous batching: every scheduler tick admits waiting requests into
  free slots (chunked, bucketed prefill), then decodes ALL active slots in
  one batched pass; new requests join mid-flight.
- Roundtrip-lean scheduling: decode runs up to ``decode_burst`` steps per
  dispatch with each sampled token fed forward on the device, a second
  burst is chained before the first one's tokens are read, and a tick's
  prefill first-token fetches wait until its decode work is queued. Every
  fetch is a non-blocking copy into pinned memory plus a CUDA event, so no
  ``.item()``-style sync sits inside those paths.
- Sampling on the device: temperature / top-k / top-p in f32 logits;
  greedy when temperature == 0; Gumbel-max with a ``torch.Generator``.

Where JAX jits with cache donation, these functions update the cache in
place and return the same dict. JAX's ``dynamic_update_slice`` clamps an
out-of-range start; torch slicing does not, so the device functions raise
on a window past ``max_seq`` (the scheduler never asks for one:
``_chunk_bucket`` and ``_burst_len`` bound every window exactly as in JAX).
Rounding points follow the JAX code: bf16 score product then f32 scale and
mask, f32 softmax cast back before the PV product, f32 SiLU, and an
f32 x f32 lm head (TF32 must stay off, PyTorch's default).

Not ported yet (they raise NotImplementedError): blocked KV, speculative
decoding, prefill/decode hand-off, tensor parallelism, checkpoint loading.
Tracing spans are not recorded (``GenerationRequest.trace_ctx`` is None).
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models.llama import LlamaConfig, init_params, params_to
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope_cs, rope_cos_sin, rope_frequencies
from ray_tpu_torch.serve.prefix import block_hashes

logger = logging.getLogger(__name__)

NEG_INF = -1e30


def _lcp(a, b, cap: int) -> int:
    n = min(len(a), len(b), cap)
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


# ---------------------------------------------------------------------------
# Host <-> device transfers that never wait for the device.


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``: pinned staging and a
    non-blocking copy on the current stream for CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class _HostFetch:
    """Device -> host copy of a small tensor, started now (pinned memory,
    non-blocking, an event behind it) and waited for in ``numpy()``."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


# ---------------------------------------------------------------------------
# Device functions (ray_tpu/llm/engine.py:67-304, :353-368, :556-585).


def init_kv_cache(cfg: LlamaConfig, max_slots: int, max_seq: int,
                  device: torch.device | str = "cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.num_layers, max_slots, cfg.num_kv_heads, max_seq,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


@dataclass
class PreparedParams:
    """A param tree laid out for the layer loops: per-layer views of the
    stacked weights, the lm head in f32 (one copy, made once: casting the
    tied [2048, 128256] head per call would move 1 GB per step) and the
    rope frequencies. The device functions take a raw tree or this; the
    engine prepares once."""
    embed: torch.Tensor
    final_norm: torch.Tensor
    layers: list
    head_f32: torch.Tensor
    inv_freq: torch.Tensor


def prepare_params(cfg: LlamaConfig, params) -> PreparedParams:
    if isinstance(params, PreparedParams):
        return params
    stacked = params["layers"]
    layers = [{name: w[l] for name, w in stacked.items()}
              for l in range(cfg.num_layers)]
    head = (params["embed_tokens"].t() if cfg.tie_embeddings
            else params["lm_head"])
    return PreparedParams(
        embed=params["embed_tokens"], final_norm=params["final_norm"],
        layers=layers, head_f32=head.float(),
        inv_freq=rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                  cfg.rope_scaling,
                                  device=params["embed_tokens"].device))


def _project_qkv(cfg: LlamaConfig, lp, xn, b, s):
    q = (xn @ lp["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
    k = (xn @ lp["wk"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (xn @ lp["wv"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attention(cfg: LlamaConfig, q, k, v, blocked):
    """q [B, H, Q, D]; k/v [B, Hkv, S, D]; ``blocked`` (True = may not
    attend) broadcasts to [B, H, Q, S]. GQA without repeating K/V: query
    heads kvh*rep .. kvh*rep+rep-1 share kv head kvh, so each kv head's
    queries form one [rep*Q, D] operand of a batched matmul."""
    b, h, nq, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    qg = q.reshape(b, hkv, rep * nq, d)
    scores = torch.matmul(qg, k.transpose(-1, -2)).view(b, h, nq, -1)
    scores = scores.float()  # bf16 product, then f32 (engine.py:134)
    scores = scores / math.sqrt(cfg.head_dim)
    scores = scores.masked_fill(blocked, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.matmul(probs.view(b, hkv, rep * nq, -1), v)
    return o.view(b, h, nq, d)


def _attn_out(lp, o, x):
    b, _, s, _ = o.shape
    return x + (o.transpose(1, 2).reshape(b, s, -1) @ lp["wo"]).to(x.dtype)


def _mlp(cfg: LlamaConfig, lp, x):
    dt = x.dtype
    xn = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu((xn @ lp["w_gate"]).float()).to(dt)
    up = xn @ lp["w_up"]
    return x + ((gate * up) @ lp["w_down"]).to(dt)


def _lm_head(cfg: LlamaConfig, w: PreparedParams, x):
    x = rms_norm(x, w.final_norm, cfg.norm_eps)
    return x.float() @ w.head_f32


def _as_tokens(tokens, device: torch.device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device).long()
    return _h2d(np.asarray(tokens, np.int64), device)


def _check_window(cache, start: int, n: int) -> None:
    max_seq = cache["k"].shape[3]
    if start < 0 or start + n > max_seq:
        raise ValueError(f"KV window [{start}, {start + n}) exceeds the "
                         f"cache line of {max_seq} positions")


@torch.no_grad()
def prefill(cfg: LlamaConfig, params, cache, tokens, length: int,
            slot: int):
    """Prefill ONE sequence into cache slot ``slot``.

    tokens: [S_bucket] (padded), length: true prompt length. Returns
    (cache, next-token logits [V] f32)."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    tokens = _as_tokens(tokens, dev)
    s = tokens.shape[0]
    _check_window(cache, 0, s)
    x = w.embed[tokens][None]  # [1, S, H]
    positions = torch.arange(s, device=dev)
    cos, sin = rope_cos_sin(positions, w.inv_freq)
    blocked = ~((positions[None, :] <= positions[:, None])
                & (positions[None, :] < length))  # [S, S]
    for l, lp in enumerate(w.layers):
        xn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, lp, xn, 1, s)
        q = apply_rope_cs(q, cos, sin)
        k = apply_rope_cs(k, cos, sin)
        cache["k"][l, slot, :, :s] = k[0]
        cache["v"][l, slot, :, :s] = v[0]
        x = _attn_out(lp, _attention(cfg, q, k, v, blocked), x)
        x = _mlp(cfg, lp, x)
    last = min(max(length - 1, 0), s - 1)
    # Only the row that is returned goes through the head (rows are
    # independent: same arithmetic as the JAX [S, V] product, row picked).
    return cache, _lm_head(cfg, w, x[0, last:last + 1])[0]


@torch.no_grad()
def prefill_chunk(cfg: LlamaConfig, params, cache, tokens, kv_len: int,
                  length: int, slot: int):
    """Prefill ONE chunk of one sequence (chunked prefill).

    tokens: [C] chunk (padded), kv_len: tokens already cached for this
    slot, length: true total prompt length. Queries attend to
    cache[0..kv_len) + the chunk's own causal prefix. Returns (cache,
    last-token logits [V] f32)."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    tokens = _as_tokens(tokens, dev)
    c = tokens.shape[0]
    max_seq = cache["k"].shape[3]
    _check_window(cache, kv_len, c)
    x = w.embed[tokens][None]  # [1, C, H]
    positions = torch.arange(kv_len, kv_len + c, device=dev)
    cos, sin = rope_cos_sin(positions, w.inv_freq)
    kpos = torch.arange(max_seq, device=dev)
    # [C, max_seq]: causal vs absolute kv position, limited to real tokens.
    blocked = ~((kpos[None, :] <= positions[:, None])
                & (kpos[None, :] < length))
    for l, lp in enumerate(w.layers):
        xn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, lp, xn, 1, c)
        q = apply_rope_cs(q, cos, sin)
        k = apply_rope_cs(k, cos, sin)
        k_line, v_line = cache["k"][l, slot], cache["v"][l, slot]
        k_line[:, kv_len:kv_len + c] = k[0]
        v_line[:, kv_len:kv_len + c] = v[0]
        x = _attn_out(lp, _attention(cfg, q, k_line[None], v_line[None],
                                     blocked), x)
        x = _mlp(cfg, lp, x)
    last = min(max(length - 1 - kv_len, 0), c - 1)
    return cache, _lm_head(cfg, w, x[0, last:last + 1])[0]


class _DecodeIndex:
    """Device-side indices for ``steps`` consecutive decode passes of K
    tokens per slot, pass j shifted j positions on (a burst runs K == 1).
    Built from host arrays in one upload: positions [B, K], the
    write-masked slots, and the flat (slot, position) rows a pass writes.
    Slots with write_mask False are never written: their cache window is
    left exactly as it was."""

    def __init__(self, positions0, write_mask, k: int, steps: int,
                 max_seq: int, device: torch.device):
        pos0 = np.asarray(positions0, np.int64).reshape(-1)
        wm = np.asarray(write_mask, bool).reshape(-1)
        if wm.shape != pos0.shape:
            raise ValueError("write_mask and positions differ in shape")
        b = pos0.shape[0]
        positions = pos0[:, None] + np.arange(k)[None, :]  # [B, K]
        wslots = np.flatnonzero(wm)
        last = positions.max(initial=0) + steps - 1
        if positions.min(initial=0) < 0 or last >= max_seq:
            raise ValueError(f"decode positions reach {last}, past the "
                             f"cache line of {max_seq} positions")
        n = wslots.shape[0]
        packed = np.concatenate([positions.reshape(-1), wslots,
                                 np.repeat(wslots, k),
                                 positions[wslots].reshape(-1)])
        t = _h2d(packed, device)
        o = b * k
        self._positions = t[:o].view(b, k)
        self.wslots = t[o:o + n]
        self.row_slot = t[o + n:o + n + n * k]
        self._row_pos = t[o + n + n * k:]
        self._kpos = torch.arange(max_seq, device=device)

    def at(self, j: int):
        """(positions [B, K], row positions, blocked [B, 1, K, S]) of pass j
        (positions shifted by j)."""
        pos = self._positions + j if j else self._positions
        rows = self._row_pos + j if j else self._row_pos
        blocked = (self._kpos[None, None, :] > pos[:, :, None])[:, None]
        return pos, rows, blocked


def _write_rows(cache_l, new, idx: _DecodeIndex, row_pos) -> None:
    """cache_l [B, Hkv, S, D] <- new [B, Hkv, K, D] at each write-masked
    slot's K positions; touches only those rows."""
    _, hkv, _, d = new.shape
    rows = new.permute(0, 2, 1, 3).index_select(0, idx.wslots)
    cache_l[idx.row_slot, :, row_pos] = rows.reshape(-1, hkv, d)


def _multi_token_impl(cfg: LlamaConfig, w: PreparedParams, cache, tokens,
                      idx: _DecodeIndex, j: int = 0):
    """Consume K tokens per slot in one pass against the KV cache.

    tokens: [B, K] on the device; pass ``j`` of ``idx``: tokens[:, t] is
    written at positions0 + j + t and attends kv through its own position.
    Returns (cache, logits [B, K, V] f32)."""
    b, k = tokens.shape
    positions, row_pos, blocked = idx.at(j)
    x = w.embed[tokens]  # [B, K, H]
    cos, sin = rope_cos_sin(positions, w.inv_freq)
    for l, lp in enumerate(w.layers):
        xn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, kk, v = _project_qkv(cfg, lp, xn, b, k)
        q = apply_rope_cs(q, cos, sin)
        kk = apply_rope_cs(kk, cos, sin)
        k_l, v_l = cache["k"][l], cache["v"][l]
        _write_rows(k_l, kk, idx, row_pos)
        _write_rows(v_l, v, idx, row_pos)
        x = _attn_out(lp, _attention(cfg, q, k_l, v_l, blocked), x)
        x = _mlp(cfg, lp, x)
    return cache, _lm_head(cfg, w, x)


@torch.no_grad()
def decode_step(cfg: LlamaConfig, params, cache, tokens, positions,
                write_mask=None):
    """One decode step for EVERY slot.

    tokens: [B] (device tensor or host array); positions / write_mask: [B]
    host arrays (they decide which cache rows are written). write_mask
    False keeps a slot's cache line (slots mid-prefill or empty). Returns
    (cache, logits [B, V] f32)."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    tokens = _as_tokens(tokens, dev)
    if write_mask is None:
        write_mask = np.ones(tokens.shape, bool)
    idx = _DecodeIndex(positions, write_mask, 1, 1, cache["k"].shape[3], dev)
    cache, logits = _multi_token_impl(cfg, w, cache, tokens[:, None], idx)
    return cache, logits[:, 0]


@torch.no_grad()
def decode_burst(cfg: LlamaConfig, params, cache, token0, positions0,
                 write_mask, temps, top_ps, generator: torch.Generator,
                 steps: int, need_top_p: bool = True):
    """``steps`` chained decode+sample steps in one dispatch: each sampled
    token feeds the next step on the device, nothing is read back.
    Greedy/temperature/top-p sampling (top-k takes single steps).
    Returns (cache, tokens [steps, B] int64 on the device)."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    tok = _as_tokens(token0, dev)
    idx = _DecodeIndex(positions0, write_mask, 1, steps,
                       cache["k"].shape[3], dev)
    temps = _as_f32(temps, dev)
    top_ps = _as_f32(top_ps, dev)
    out = torch.empty((steps, tok.shape[0]), dtype=torch.long, device=dev)
    for j in range(steps):
        cache, logits = _multi_token_impl(cfg, w, cache, tok[:, None], idx, j)
        tok = sample_tokens(logits[:, 0], temps, top_ps, 0, generator,
                            need_top_p)
        out[j] = tok
    return cache, out


@torch.no_grad()
def copy_prefix_kv(cfg: LlamaConfig, cache, src_slot: int, dst_slot: int):
    """Copy one slot's whole KV line to another slot, all layers at once
    (prefix-cache adoption from a donor). Positions past the adopted
    prefix are masked by ``length``/``positions`` downstream."""
    cache["k"][:, dst_slot] = cache["k"][:, src_slot]
    cache["v"][:, dst_slot] = cache["v"][:, src_slot]
    return cache


def _as_f32(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return _h2d(np.asarray(a, np.float32), device)


def top_p_keep(scaled: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Nucleus mask [B, V]: the smallest prefix of the sorted
    probabilities whose cumulative sum before each token is < top_p
    (the first token always stays)."""
    sorted_logits, sorted_idx = torch.sort(scaled, dim=-1, descending=True,
                                           stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_ps[:, None]
    return torch.zeros_like(keep_sorted).scatter_(-1, sorted_idx,
                                                  keep_sorted)


@torch.no_grad()
def sample_tokens(logits, temps, top_ps, top_k: int,
                  generator: torch.Generator | None,
                  need_top_p: bool = True):
    """logits [B, V] f32; temps/top_ps [B]. Greedy where temp == 0.

    ``need_top_p=False`` skips the vocab-wide sort of nucleus filtering
    (with top_p == 1 it keeps every token anyway). Sampling is Gumbel-max
    over the masked logits, the same distribution as
    ``jax.random.categorical``; it needs no host sync."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    if need_top_p:
        scaled = torch.where(top_p_keep(scaled, top_ps), scaled, NEG_INF)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


# ---------------------------------------------------------------------------
# Host scheduler.


@dataclass
class GenerationRequest:
    request_id: str
    prompt_ids: list[int]
    sampling: SamplingParams
    out_tokens: list[int] = field(default_factory=list)
    stream_queue: queue.Queue | None = None
    done: threading.Event = field(default_factory=threading.Event)
    error: str | None = None
    finish_reason: str | None = None
    next_pos: int = 0  # position the next token will occupy; <0 = prefilling
    prefilled_len: int = 0  # prompt tokens already in the KV cache
    trace_ctx: dict | None = None  # tracing is not ported: always None
    submit_ts: float = 0.0
    first_token_ts: float = 0.0


@dataclass
class GenerationResult:
    request_id: str
    prompt_ids: list[int]
    token_ids: list[int]
    text: str
    finish_reason: str


def _unported(config: LLMConfig) -> None:
    for on, what in (
            (config.kv_block_size > 0, "blocked KV (kv_block_size > 0)"),
            (config.speculative_model is not None, "speculative decoding"),
            (config.tensor_parallel_size > 1, "tensor parallelism"),
            (bool(config.checkpoint_path), "checkpoint loading")):
        if on:
            raise NotImplementedError(
                f"{what} is not ported to ray_tpu_torch yet")


class LLMEngine:
    """The continuous-batching engine. Thread-safe: ``generate``/``submit``
    may be called concurrently (they only enqueue); one background
    scheduler thread owns the device (it selects it and issues every
    launch on its current stream)."""

    # Minimum adopted-prefix length that justifies a cross-slot KV copy.
    PREFIX_COPY_MIN = 16

    # Decode-burst cap while a slot is mid-prefill (see _burst_len).
    PREFILL_PRIORITY_BURST = 8

    def __init__(self, config: LLMConfig, params: Any = None,
                 device: torch.device | str = "cuda"):
        _unported(config)
        self.device = resolve_device(device)
        self.config = config
        self.model_cfg = config.model_config()
        self.tokenizer = get_tokenizer(config.tokenizer)
        self.max_slots = config.max_num_seqs
        self.max_seq = config.max_seq_len or self.model_cfg.max_seq_len
        if self.tokenizer.vocab_size > self.model_cfg.vocab_size:
            raise ValueError("tokenizer vocab exceeds model vocab")
        if params is None:
            params = init_params(self.model_cfg, generator=config.seed,
                                 device=self.device)
        else:
            params = params_to(params, self.device)
        self.params = params
        self._weights = prepare_params(self.model_cfg, params)
        self.cache = init_kv_cache(self.model_cfg, self.max_slots,
                                   self.max_seq, self.device)

        self._slots: dict[int, GenerationRequest | None] = {
            i: None for i in range(self.max_slots)}
        # Prefix KV reuse (vLLM automatic-prefix-caching semantics):
        # - _prefix_live: slot -> prompt tokens, prefill COMPLETE, request
        #   still running (adoption copies the line to the new slot).
        # - _prefix_cached: retired slot -> (tokens, last_use); the slot is
        #   unoccupied but its KV is intact — an exact/prefix re-hit admits
        #   straight into it with zero copy; unrelated admits evict LRU.
        # Mutated only by the scheduler thread; user threads read snapshots.
        self._prefix_live: dict[int, tuple[int, ...]] = {}
        self._prefix_cached: dict[int, tuple[tuple[int, ...], float]] = {}
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.prefill_chunks = 0
        self.decode_bursts = 0
        self.chained_bursts = 0
        self.prefix_block = int(config.prefix_block_tokens or 0)
        self._prefix_hash_cache: dict[tuple, tuple[int, ...]] = {}
        self._prefill_rr = -1  # last slot that ran a prefill chunk
        self._waiting: queue.Queue[GenerationRequest] = queue.Queue()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(config.seed + 1)
        # Pipelined decode: (active snapshot, burst, fetch) of a chained
        # burst awaiting resolution at the next tick's start.
        self._pending_burst = None
        self._stop = threading.Event()
        self._work = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- public API ----

    def submit(self, prompt: str | list[int],
               sampling: SamplingParams | None = None,
               stream: bool = False) -> GenerationRequest:
        sampling = sampling or SamplingParams()
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        ids = ids[: self.max_seq - 1]
        req = GenerationRequest(
            request_id=uuid.uuid4().hex[:12], prompt_ids=ids,
            sampling=sampling,
            stream_queue=queue.Queue() if stream else None)
        req.submit_ts = time.time()
        self._waiting.put(req)
        self._work.set()
        return req

    def generate(self, prompt: str | list[int],
                 sampling: SamplingParams | None = None,
                 timeout: float = 300.0) -> GenerationResult:
        req = self.submit(prompt, sampling)
        if not req.done.wait(timeout):
            raise TimeoutError(f"generation {req.request_id} timed out")
        if req.error:
            raise RuntimeError(req.error)
        return self._result(req)

    def generate_stream(self, prompt: str | list[int],
                        sampling: SamplingParams | None = None):
        """Yields decoded text fragments as tokens arrive."""
        req = self.submit(prompt, sampling, stream=True)
        while True:
            item = req.stream_queue.get()
            if item is None:
                break
            yield self.tokenizer.decode([item])
        if req.error:
            raise RuntimeError(req.error)

    def prefill_only(self, *a, **kw):
        raise NotImplementedError(
            "prefill/decode hand-off is not ported to ray_tpu_torch yet")

    submit_prefilled = prefill_only
    release_slot = prefill_only

    def shutdown(self) -> None:
        self._stop.set()
        self._work.set()
        self._thread.join(timeout=5)

    def prefix_block_hashes(self) -> tuple[int, ...]:
        """Chain hashes (serve/prefix.py) of every prompt prefix whose KV
        this engine holds — live donors plus retired cached slots. Safe
        from any thread: the registries are snapshotted."""
        if self.prefix_block <= 0:
            return ()
        prefixes = list(self._prefix_live.values())
        prefixes += [toks for toks, _ in list(self._prefix_cached.values())]
        cache = self._prefix_hash_cache
        fresh: dict[tuple, tuple[int, ...]] = {}
        out: set[int] = set()
        for toks in prefixes:
            h = cache.get(toks)
            if h is None:
                h = block_hashes(toks, self.prefix_block)
            fresh[toks] = h
            out.update(h)
        self._prefix_hash_cache = fresh  # prune evicted prefixes
        return tuple(sorted(out))

    def router_prefix_blocks(self) -> dict | None:
        """The prefix-routing publication: {"blocks": [...], "block": n},
        or None when publication is disabled."""
        if self.prefix_block <= 0:
            return None
        return {"blocks": list(self.prefix_block_hashes()),
                "block": self.prefix_block}

    def stats(self) -> dict:
        active = sum(1 for r in self._slots.values() if r is not None)
        return {"active": active, "waiting": self._waiting.qsize(),
                "slots": self.max_slots,
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "prefix_cached_slots": len(self._prefix_cached),
                "prefix_block": self.prefix_block,
                "prefill_chunks": self.prefill_chunks,
                "decode_bursts": self.decode_bursts,
                "chained_bursts": self.chained_bursts}

    # ---- scheduler ----

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    worked = self._tick()
                except Exception:  # noqa: BLE001 - one bad request must
                    # not kill the scheduler thread; logged and backed off.
                    logger.exception("LLMEngine scheduler tick failed")
                    worked = False
                if not worked:
                    self._work.wait(timeout=0.02)
                    self._work.clear()
            # Drain a chained burst so its requests get their final tokens.
            try:
                self._resolve_pending_burst()
            except Exception:  # noqa: BLE001 - shutdown path
                pass

    def _tick(self) -> bool:
        """One scheduler step: a bounded budget of prefill chunks (their
        first-token fetches deferred), then one decode batch over the
        decoding slots. Admission into currently-empty slots runs BEFORE
        the pipelined burst is resolved: such a slot was free at that
        burst's dispatch, so its write mask excludes it."""
        worked = self._admit()
        deferred: list = []
        try:
            return self._tick_inner(deferred) or worked
        finally:
            # Whatever was dispatched, resolve it: a stranded deferred
            # fetch would leave its request prefilled but never decoding.
            self._resolve_prefills(deferred)

    def _tick_inner(self, deferred: list) -> bool:
        worked = False
        # Per-PASS chunk budget: one pass before and one after resolving
        # the pipelined burst.
        budget = max(1, int(self.config.prefill_chunks_per_tick or 1))
        spent = 0
        while spent < budget and self._prefill_step(deferred):
            spent += 1
            worked = True
        # Resolve the pipelined burst next: its emissions may finish
        # requests and free slots for the SECOND admission pass below.
        worked = self._resolve_pending_burst() or worked
        worked = self._admit() or worked
        spent = 0
        while spent < budget and self._prefill_step(deferred):
            spent += 1
            worked = True
        decoding = {s: r for s, r in self._slots.items()
                    if r is not None and r.next_pos >= 0
                    and not r.done.is_set()}
        if decoding:
            self._decode(decoding)
            worked = True
        return worked

    def _resolve_prefills(self, deferred: list) -> None:
        """Fetch the deferred first tokens (dispatched in _prefill_step)
        and start those requests decoding. Runs AFTER the tick's decode
        dispatch so the fetch overlaps the queued device work."""
        for req, fetch in deferred:
            if req.done.is_set():  # failed meanwhile (device recovery)
                continue
            try:
                tok = int(fetch.numpy()[0])
            except Exception as e:  # noqa: BLE001 - async device error
                logger.exception("deferred prefill sample failed for %s",
                                 req.request_id)
                self._recover_device_failure(f"prefill failed: {e!r}")
                return
            req.next_pos = len(req.prompt_ids)
            self._emit(req, tok)

    def _admit(self) -> bool:
        """Move waiting requests into unoccupied slots (prefill starts on
        subsequent ticks), adopting cached prompt prefixes when a donor
        slot shares one (the final prompt token is always recomputed so
        its logits seed decoding)."""
        admitted = False
        while any(o is None for o in self._slots.values()):
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                break
            donor, adopt, retired = self._best_prefix(req.prompt_ids)
            req.prefilled_len = 0
            if donor is not None and adopt < self.PREFIX_COPY_MIN:
                # Trivial LCP: not worth a copy, never worth a donor.
                donor = None
            if retired and donor is not None and \
                    adopt * 2 >= len(self._prefix_cached[donor][0]):
                # Zero-copy: admit straight into the retired slot whose KV
                # already holds the prefix — only when the new prompt
                # consumes most of it (an in-place adopt overwrites it).
                slot = donor
                self._prefix_cached.pop(slot, None)
                req.prefilled_len = adopt
                self.prefix_hits += 1
                self.prefix_tokens_saved += adopt
            else:
                slot = self._take_slot()
                if donor is not None and slot == donor:
                    # LRU eviction handed us the donor itself: its KV line
                    # is already in place.
                    req.prefilled_len = adopt
                    self.prefix_hits += 1
                    self.prefix_tokens_saved += adopt
                elif donor is not None:
                    # Content copy from the donor line (live OR retired)
                    # into the fresh slot, preserving the donor.
                    try:
                        self.cache = copy_prefix_kv(self.model_cfg,
                                                    self.cache, donor, slot)
                        req.prefilled_len = adopt
                        self.prefix_hits += 1
                        self.prefix_tokens_saved += adopt
                        if donor in self._prefix_cached:
                            self._prefix_cached[donor] = (
                                self._prefix_cached[donor][0],
                                time.monotonic())
                    except Exception as e:  # noqa: BLE001
                        logger.exception("prefix copy failed")
                        self._recover_device_failure(
                            f"prefix copy failed: {e!r}")
                        req.prefilled_len = 0
            # next_pos < 0 marks "still prefilling" (prefilled_len tracks
            # progress); _finish frees by identity.
            req.next_pos = -1
            self._slots[slot] = req
            admitted = True
        return admitted

    def _take_slot(self) -> int:
        """An unoccupied slot: prefer one with no cached prefix; otherwise
        evict the least-recently-used prefix entry."""
        fresh = [s for s, o in self._slots.items()
                 if o is None and s not in self._prefix_cached]
        if fresh:
            return fresh[0]
        slot = min((s for s, o in self._slots.items() if o is None),
                   key=lambda s: self._prefix_cached.get(s, ((), 0.0))[1])
        self._prefix_cached.pop(slot, None)
        return slot

    def _best_prefix(self, prompt_ids: list[int]):
        """(donor_slot, usable_prefix_len, donor_is_retired) — longest
        common prefix across donors, capped at len(prompt)-1. Retired
        donors win ties (adoption is zero-copy)."""
        cap = len(prompt_ids) - 1
        best_slot, best_p, best_retired = None, 0, False
        if cap <= 0:
            return best_slot, best_p, best_retired
        for slot, toks in list(self._prefix_live.items()):
            p = _lcp(prompt_ids, toks, cap)
            if p > best_p:
                best_slot, best_p, best_retired = slot, p, False
        for slot, (toks, _) in list(self._prefix_cached.items()):
            p = _lcp(prompt_ids, toks, cap)
            if p > best_p or (p == best_p and p > 0 and not best_retired):
                best_slot, best_p, best_retired = slot, p, True
        return best_slot, best_p, best_retired

    def _prefill_step(self, deferred: list) -> bool:
        """Run ONE chunk of ONE prefilling request, rotating across slots so
        concurrent long prompts interleave chunks. A final chunk's
        first-token sample is dispatched and its copy to the host started,
        but not waited for: (req, fetch) goes to ``deferred``."""
        slots = list(self._slots.keys())
        n = len(slots)
        for i in range(n):
            slot = slots[(self._prefill_rr + 1 + i) % n]
            req = self._slots.get(slot)
            if req is None or req.next_pos >= 0:
                continue
            p = len(req.prompt_ids)
            if req.prefilled_len >= p:
                # Fully prefilled, first-token fetch still deferred.
                continue
            self._prefill_rr = slot
            bucket, take = self._chunk_bucket(req.prefilled_len,
                                              p - req.prefilled_len)
            toks = np.zeros((bucket,), np.int64)
            toks[:take] = req.prompt_ids[req.prefilled_len:
                                         req.prefilled_len + take]
            try:
                self.cache, logits = prefill_chunk(
                    self.model_cfg, self._weights, self.cache,
                    _h2d(toks, self.device), req.prefilled_len, p, slot)
                req.prefilled_len += take
                self.prefill_chunks += 1
                if req.prefilled_len >= p:  # final chunk: sample 1st token
                    # The slot now holds the full prompt's KV: it becomes a
                    # prefix donor for later shared-prefix requests.
                    self._prefix_live[slot] = tuple(req.prompt_ids)
                    out = self._sample_dispatch(logits[None], [req])
                    deferred.append((req, _HostFetch(out)))
            except Exception as e:  # noqa: BLE001 - e.g. OOM on long prompt
                logger.exception("prefill failed for %s", req.request_id)
                self._recover_device_failure(f"prefill failed: {e!r}")
            return True
        return False

    def _recover_device_failure(self, err: str) -> None:
        """After a failed prefill/decode dispatch the KV cache is suspect
        (a half-written pass): fail every slotted request, then rebuild a
        fresh cache so the engine keeps serving NEW traffic."""
        self._pending_burst = None  # chained into the lost cache
        for req in list(self._slots.values()):
            if req is not None and not req.done.is_set():
                self._fail(req, err)
        self._slots = {i: None for i in range(self.max_slots)}
        self._prefix_live.clear()
        self._prefix_cached.clear()
        self.cache = None  # release the old pool before allocating anew
        self.cache = init_kv_cache(self.model_cfg, self.max_slots,
                                   self.max_seq, self.device)

    def _burst_len(self, active: dict[int, GenerationRequest]) -> int:
        """Largest safe burst length for this decode batch, rounded down to
        a power of two. The decode batch is the static slot array, so a
        request finishing mid-burst just stops emitting. The hard bound is
        the KV cache end (a burst never writes past max_seq). 1 means the
        single-step path."""
        burst = int(self.config.decode_burst or 1)
        if burst <= 1:
            return 1
        # Prefill priority: while a slot is mid-prefill, cap the burst so
        # the scheduler returns to the prefill quickly.
        if any(r is not None and r.next_pos < 0 and not r.done.is_set()
               for r in self._slots.values()):
            burst = min(burst, self.PREFILL_PRIORITY_BURST)
        budget = 0  # largest remaining token budget across the batch
        for req in active.values():
            if req.sampling.top_k:  # static-k sampling: single-step only
                return 1
            burst = min(burst, self.max_seq - 1 - req.next_pos)
            budget = max(budget,
                         req.sampling.max_tokens - len(req.out_tokens))
        burst = min(burst, budget)
        d = 1
        while d * 2 <= burst:
            d *= 2
        return max(d, 1)

    def _decode(self, active: dict[int, GenerationRequest]) -> bool:
        """Returns False iff a device failure wiped the engine state."""
        burst = self._burst_len(active)
        tokens = np.zeros((self.max_slots,), np.int64)
        positions = np.zeros((self.max_slots,), np.int64)
        write = np.zeros((self.max_slots,), bool)
        for slot, req in active.items():
            tokens[slot] = req.out_tokens[-1]
            positions[slot] = req.next_pos
            write[slot] = True
        if burst > 1:
            return self._decode_burst(active, burst, tokens, positions,
                                      write)
        try:
            self.cache, logits = decode_step(
                self.model_cfg, self._weights, self.cache,
                _h2d(tokens, self.device), positions, write)
        except Exception as e:  # noqa: BLE001 - cache state suspect
            logger.exception("decode step failed (%d active)", len(active))
            self._recover_device_failure(f"decode failed: {e!r}")
            return False
        try:
            reqs = [active.get(s) for s in range(self.max_slots)]
            sampled = self._sample_one(logits, reqs)
        except Exception as e:  # noqa: BLE001 - cache survived; only this
            # batch's requests lack tokens — fail them, keep other contexts.
            logger.exception("sampling failed (%d active)", len(active))
            for req in active.values():
                self._fail(req, f"sampling failed: {e!r}")
            return True
        for slot, req in active.items():
            req.next_pos += 1
            self._emit(req, int(sampled[slot]))
        return True

    def _decode_burst(self, active: dict[int, GenerationRequest],
                      burst: int, tokens, positions, write) -> bool:
        """Emit ``burst`` tokens per active slot from one dispatch. In
        steady state a SECOND burst is chained before this one's tokens
        are read (see _should_chain), fed the device-side last token; it
        is resolved at the next tick (_resolve_pending_burst)."""
        temps = np.zeros((self.max_slots,), np.float32)
        top_ps = np.ones((self.max_slots,), np.float32)
        for slot, req in active.items():
            temps[slot] = req.sampling.temperature
            top_ps[slot] = req.sampling.top_p
        need_top_p = bool((top_ps < 1.0).any())
        try:
            self.cache, toks = decode_burst(
                self.model_cfg, self._weights, self.cache,
                _h2d(tokens, self.device), positions, write, temps, top_ps,
                self._generator, burst, need_top_p)
            fetch = _HostFetch(toks)  # copy queued behind the burst
            self.decode_bursts += 1
            if self._should_chain(active, burst):
                self.cache, toks2 = decode_burst(
                    self.model_cfg, self._weights, self.cache,
                    toks[burst - 1], positions + burst, write, temps,
                    top_ps, self._generator, burst, need_top_p)
                self._pending_burst = (dict(active), burst,
                                       _HostFetch(toks2))
                self.decode_bursts += 1
                self.chained_bursts += 1
            toks = fetch.numpy()  # [burst, max_slots]
        except Exception as e:  # noqa: BLE001 - cache state suspect
            logger.exception("burst decode failed (%d active, burst %d)",
                             len(active), burst)
            self._recover_device_failure(f"decode failed: {e!r}")
            return False
        self._emit_burst(active, burst, toks)
        return True

    def _should_chain(self, active: dict[int, GenerationRequest],
                      burst: int) -> bool:
        """Chain a second burst only when the device would otherwise sit
        idle through the fetch: steady decode (nothing waiting to admit,
        no prefilling slot), every slot has cache headroom for TWO bursts,
        and someone still needs more than one burst of tokens."""
        if burst <= 1 or not self.config.decode_pipeline:
            return False
        if self._pending_burst is not None:
            return False
        if not self._waiting.empty():
            return False
        for r in self._slots.values():
            if r is not None and r.next_pos < 0:
                return False  # a prefill wants the next tick
        budget = 0
        for req in active.values():
            if self.max_seq - 1 - req.next_pos < 2 * burst:
                return False
            budget = max(budget,
                         req.sampling.max_tokens - len(req.out_tokens))
        return budget > burst

    def _resolve_pending_burst(self) -> bool:
        """Fetch + emit the burst chained by the previous tick."""
        if self._pending_burst is None:
            return False
        active, burst, fetch = self._pending_burst
        self._pending_burst = None
        try:
            toks = fetch.numpy()
        except Exception as e:  # noqa: BLE001 - async device error
            logger.exception("pipelined burst failed (%d slots)", len(active))
            self._recover_device_failure(f"decode failed: {e!r}")
            return True
        self._emit_burst(active, burst, toks)
        return True

    def _emit_burst(self, active, burst: int, toks) -> None:
        for j in range(burst):
            for slot, req in active.items():
                if req.done.is_set():
                    continue
                req.next_pos += 1
                self._emit(req, int(toks[j, slot]))

    def _chunk_bucket(self, start: int, remaining: int) -> tuple[int, int]:
        """(bucket, take) for one prefill chunk starting at ``start``:
        power-of-two bucket from prefill_bucket_min, capped at
        prefill_chunk, and CLAMPED to the cache tail (a window past
        max_seq would make the device functions raise)."""
        bucket = self.config.prefill_bucket_min
        while bucket < min(remaining, self.config.prefill_chunk):
            bucket *= 2
        bucket = min(bucket, self.max_seq - start)
        return bucket, min(remaining, bucket)

    def _sample_dispatch(self, logits, reqs) -> torch.Tensor:
        """Sample on the device; returns the (unfetched) token tensor so
        callers can defer the host roundtrip."""
        b = logits.shape[0]
        temps = np.zeros((b,), np.float32)
        top_ps = np.ones((b,), np.float32)
        top_k = 0
        for i, r in enumerate(reqs):
            if r is None:
                continue
            temps[i] = r.sampling.temperature
            top_ps[i] = r.sampling.top_p
            if r.sampling.top_k:
                top_k = max(top_k, r.sampling.top_k)
        return sample_tokens(logits.float(), _h2d(temps, self.device),
                             _h2d(top_ps, self.device), top_k,
                             self._generator, bool((top_ps < 1.0).any()))

    def _sample_one(self, logits, reqs) -> np.ndarray:
        return _HostFetch(self._sample_dispatch(logits, reqs)).numpy()

    def _emit(self, req: GenerationRequest, token: int) -> None:
        req.out_tokens.append(token)
        if len(req.out_tokens) == 1:
            req.first_token_ts = time.time()
        if req.stream_queue is not None:
            req.stream_queue.put(token)
        eos = {self.tokenizer.eos_id, *req.sampling.stop_token_ids}
        finish = None
        if token in eos:
            finish = "stop"
        elif len(req.out_tokens) >= req.sampling.max_tokens:
            finish = "length"
        elif req.next_pos + 1 >= self.max_seq:
            finish = "length"
        if finish:
            self._finish(req, finish)

    def _fail(self, req: GenerationRequest, err: str) -> None:
        """Fail one request: record the error, free its slot, and wake its
        waiter — the engine keeps serving others."""
        req.error = err
        self._finish(req, "error")

    def _finish(self, req: GenerationRequest, reason: str) -> None:
        req.finish_reason = reason
        for slot, r in self._slots.items():
            if r is req:
                toks = self._prefix_live.pop(slot, None)
                self._slots[slot] = None
                if toks is not None and reason != "error":
                    # Retire, don't discard: the slot's KV stays intact
                    # until the slot is reclaimed, so an identical or
                    # shared-prefix prompt admits with zero prefill.
                    self._prefix_cached[slot] = (toks, time.monotonic())
        if req.stream_queue is not None:
            req.stream_queue.put(None)
        req.done.set()

    def _result(self, req: GenerationRequest) -> GenerationResult:
        toks = req.out_tokens
        if toks and toks[-1] == self.tokenizer.eos_id:
            toks = toks[:-1]
        return GenerationResult(
            request_id=req.request_id, prompt_ids=req.prompt_ids,
            token_ids=list(toks), text=self.tokenizer.decode(toks),
            finish_reason=req.finish_reason or "stop")
