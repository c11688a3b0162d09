"""PyTorch LLM inference engine: continuous batching over a slot KV cache.

Port of ray_tpu/llm/engine.py to PyTorch on a CUDA card. The design is the
JAX engine's:

- The KV cache is a dense [layers, slots, kv_heads, max_seq, head_dim]
  pool where a sequence owns one slot's line for its lifetime, or, with
  ``kv_block_size > 0``, a pool of [layers, blocks, kv_heads, block_size,
  head_dim] blocks that per-slot block tables map positions onto (reads
  gather a slot's blocks into a line of max_seq positions, so dense and
  blocked run the same products on the same shapes); on pool exhaustion
  the newest of the requests that arrived after the one in need is
  preempted and later re-prefilled.
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

Also ported: speculative decoding with a draft model (greedy acceptance,
output equal to plain greedy), the prefill/decode KV hand-off
(``prefill_only``, ``submit_prefilled``, ``release_slot``; llm/pd.py
carries it between engines) and checkpoint loading (an HF Llama directory
through llm/hf.py, or a DCP directory of train/checkpoint.py in place of
orbax). Tensor parallelism (``tensor_parallel_size > 1``) runs the
engine's tp ranks as processes under this one scheduler (llm/tp.py): the
device functions take a ``PreparedParams`` whose ``tp`` carries the
group, and every scheduler call goes through ``LLMEngine._call``. With
tracing on, each request carries its submitter's trace context
(``GenerationRequest.trace_ctx``, taken on the submitting thread) and the
scheduler stamps its ``engine.queue``, ``engine.prefill`` (or
``engine.kv_import``) and ``engine.decode`` spans onto that trace; tp
ranks other than 0 run no scheduler and record nothing.
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device, tree_map
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models.llama import LlamaConfig, init_params, params_to
from ray_tpu_torch.ops.loss import _mm_f32
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope_cs, rope_cos_sin, rope_frequencies
from ray_tpu_torch.serve.prefix import block_hashes
from ray_tpu_torch.util import tracing

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
    """Device -> host copy of a tensor, started now (pinned memory,
    non-blocking, an event behind it on the tensor's device's current
    stream) and waited for in ``numpy()``/``tensor()``. On the CPU it
    keeps ``t`` itself (callers hand it fresh tensors or clone)."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def tensor(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host

    def numpy(self) -> np.ndarray:
        return self.tensor().numpy()


# ---------------------------------------------------------------------------
# Device functions (ray_tpu/llm/engine.py:67-304, :353-368, :556-585).


def init_kv_cache(cfg: LlamaConfig, max_slots: int, max_seq: int,
                  device: torch.device | str = "cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.num_layers, max_slots, cfg.num_kv_heads, max_seq,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


def init_kv_cache_blocked(cfg: LlamaConfig, num_blocks: int,
                          block_size: int,
                          device: torch.device | str = "cuda") -> dict:
    """The block pool [L, NB, Hkv, bs, D] (ray_tpu/llm/engine.py:383)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


def _gather_slot_kv(kv_l, table_row):
    """kv_l [NB, Hkv, bs, D] + table_row [MB] -> the slot's virtual line
    [1, Hkv, MB*bs, D] (a copy, as JAX's gather is)."""
    g = kv_l[table_row]  # [MB, Hkv, bs, D]
    mb, hkv, bs, d = g.shape
    return g.permute(1, 0, 2, 3).reshape(1, hkv, mb * bs, d)


def _gather_batch_kv(kv_l, tables):
    """kv_l [NB, Hkv, bs, D] + tables [B, MB] -> [B, Hkv, MB*bs, D]."""
    g = kv_l[tables]  # [B, MB, Hkv, bs, D]
    b, mb, hkv, bs, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)


@dataclass
class PreparedParams:
    """A param tree laid out for the layer loops: per-layer views of the
    stacked weights, the lm head in f32 (one copy, made once: casting the
    tied [2048, 128256] head per call would move 1 GB per step) and the
    rope frequencies. The device functions take a raw tree or this; the
    engine prepares once. Under tensor parallelism the tree is one rank's
    blocks (llm/tp.py ``rank_blocks``) and ``tp`` its group: the embedding
    holds vocabulary rows ``vocab_lo`` on, the head those columns."""
    embed: torch.Tensor
    final_norm: torch.Tensor
    layers: list
    head_f32: torch.Tensor
    inv_freq: torch.Tensor
    tp: Any = None  # llm/tp.py's Comm, None on one rank
    vocab_lo: int = 0


def prepare_params(cfg: LlamaConfig, params, tp=None) -> PreparedParams:
    """``cfg`` is the geometry the blocks have (llm/tp.py
    ``local_config`` under tensor parallelism), ``tp`` the group."""
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
                                  device=params["embed_tokens"].device),
        tp=tp, vocab_lo=tp.rank * params["embed_tokens"].shape[0]
        if tp is not None else 0)


def _embed(w: PreparedParams, tokens):
    """Token embeddings; vocabulary-parallel under tp: each rank looks up
    the ids among its rows, zeros elsewhere, and one all-reduce sums them
    (exact: every row has one non-zero term)."""
    if w.tp is None:
        return w.embed[tokens]
    n = w.embed.shape[0]
    local = tokens - w.vocab_lo
    inside = ((local >= 0) & (local < n))[..., None]
    x = torch.where(inside, w.embed[local.clamp(0, n - 1)], 0)
    return w.tp.all_reduce(x)


def _project_qkv(cfg: LlamaConfig, lp, xn, b, s):
    """q/k/v [B, heads, S, D] (a rank's heads under tp: ``cfg`` is its
    ``local_config``)."""
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


def _row_parallel(a, w, tp):
    """``a @ w``; under tp a row-parallel product: each rank's partial
    product in f32 (accumulated from a and w's own dtype), summed over the
    ranks in f32, so the sum is rounded once, as one rank's product is."""
    if tp is None:
        return a @ w
    y = _mm_f32(a.reshape(-1, a.shape[-1]), w)
    return tp.all_reduce(y).view(*a.shape[:-1], w.shape[-1])


def _attn_out(lp, o, x, tp=None):
    b, _, s, _ = o.shape
    y = _row_parallel(o.transpose(1, 2).reshape(b, s, -1), lp["wo"], tp)
    return x + y.to(x.dtype)


def _mlp(cfg: LlamaConfig, lp, x, tp=None):
    dt = x.dtype
    xn = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu((xn @ lp["w_gate"]).float()).to(dt)
    up = xn @ lp["w_up"]
    return x + _row_parallel(gate * up, lp["w_down"], tp).to(dt)


def _lm_head(cfg: LlamaConfig, w: PreparedParams, x):
    """f32 logits over the whole vocabulary (under tp each rank's columns,
    all-gathered)."""
    x = rms_norm(x, w.final_norm, cfg.norm_eps)
    logits = x.float() @ w.head_f32
    return logits if w.tp is None else w.tp.all_gather_last(logits)


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
    x = _embed(w, tokens)[None]  # [1, S, H]
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
        x = _attn_out(lp, _attention(cfg, q, k, v, blocked), x, w.tp)
        x = _mlp(cfg, lp, x, w.tp)
    last = min(max(length - 1, 0), s - 1)
    # Only the row that is returned goes through the head (rows are
    # independent: same arithmetic as the JAX [S, V] product, row picked).
    return cache, _lm_head(cfg, w, x[0, last:last + 1])[0]


def _prefill_chunk_impl(cfg: LlamaConfig, w: PreparedParams, tokens,
                        kv_len: int, length: int, max_seq: int, store):
    """The chunk forward both cache layouts share: queries at kv_len.. attend
    to the line ``store(l, k, v)`` returns for layer l after writing the
    chunk's k/v [Hkv, C, D] (a [1, Hkv, max_seq, D] line). Returns the
    last real token's logits [V] f32."""
    dev = tokens.device
    c = tokens.shape[0]
    x = _embed(w, tokens)[None]  # [1, C, H]
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
        k_line, v_line = store(l, k[0], v[0])
        x = _attn_out(lp, _attention(cfg, q, k_line, v_line, blocked), x,
                      w.tp)
        x = _mlp(cfg, lp, x, w.tp)
    last = min(max(length - 1 - kv_len, 0), c - 1)
    return _lm_head(cfg, w, x[0, last:last + 1])[0]


@torch.no_grad()
def prefill_chunk(cfg: LlamaConfig, params, cache, tokens, kv_len: int,
                  length: int, slot: int):
    """Prefill ONE chunk of one sequence (chunked prefill).

    tokens: [C] chunk (padded), kv_len: tokens already cached for this
    slot, length: true total prompt length. Queries attend to
    cache[0..kv_len) + the chunk's own causal prefix. Returns (cache,
    last-token logits [V] f32)."""
    w = prepare_params(cfg, params)
    tokens = _as_tokens(tokens, cache["k"].device)
    c = tokens.shape[0]
    _check_window(cache, kv_len, c)

    def store(l, k, v):
        k_line, v_line = cache["k"][l, slot], cache["v"][l, slot]
        k_line[:, kv_len:kv_len + c] = k
        v_line[:, kv_len:kv_len + c] = v
        return k_line[None], v_line[None]

    return cache, _prefill_chunk_impl(cfg, w, tokens, kv_len, length,
                                      cache["k"].shape[3], store)


@torch.no_grad()
def prefill_chunk_blocked(cfg: LlamaConfig, params, cache, table_row,
                          tokens, kv_len: int, length: int):
    """Blocked-pool chunked prefill for ONE slot (ray_tpu/llm/engine.py:
    408). ``table_row`` [MB] is the slot's block table (a host array);
    kv_len and the chunk are multiples of block_size, so the chunk writes
    whole blocks: one index_copy_ a layer for K and one for V. Returns
    (cache, last-token logits [V] f32)."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    tokens = _as_tokens(tokens, dev)
    c = tokens.shape[0]
    _, nb, _, bs, _ = cache["k"].shape
    row = np.asarray(table_row, np.int64).reshape(-1)
    mb = row.shape[0]
    if kv_len % bs or c % bs or kv_len < 0 or kv_len + c > mb * bs:
        raise ValueError(f"blocked chunk [{kv_len}, {kv_len + c}) is not "
                         f"whole blocks of {bs} inside {mb} blocks")
    _check_blocks(row, nb)
    table = _h2d(row, dev)
    dst = table[kv_len // bs:(kv_len + c) // bs]
    nblk = c // bs

    def store(l, k, v):
        k_l, v_l = cache["k"][l], cache["v"][l]
        hkv, _, d = k.shape
        k_l.index_copy_(0, dst, k.view(hkv, nblk, bs, d).transpose(0, 1))
        v_l.index_copy_(0, dst, v.view(hkv, nblk, bs, d).transpose(0, 1))
        return _gather_slot_kv(k_l, table), _gather_slot_kv(v_l, table)

    return cache, _prefill_chunk_impl(cfg, w, tokens, kv_len, length,
                                      mb * bs, store)


def _check_blocks(table, num_blocks: int) -> None:
    """A CUDA gather or scatter past the pool would fault the device."""
    if table.size and (table.min() < 0 or table.max() >= num_blocks):
        raise ValueError(f"block table names a block outside the pool of "
                         f"{num_blocks}")


class _DecodeIndex:
    """Device-side indices for ``steps`` consecutive decode passes of K
    tokens per slot, pass j shifted j positions on (a burst runs K == 1).
    Built from host arrays in one upload: positions [B, K], the
    write-masked slots, and the rows a pass writes: (slot, position) of a
    dense line, or with ``tables`` [B, MB] (the blocked pool) (block,
    offset) = (tables[b, p // bs], p % bs) for every pass, plus the tables
    for the gather. Slots with write_mask False are never written: their
    cache window (or their blocks) is left exactly as it was."""

    def __init__(self, positions0, write_mask, k: int, steps: int,
                 max_seq: int, device: torch.device, tables=None,
                 num_blocks: int = 0):
        pos0 = np.asarray(positions0, np.int64).reshape(-1)
        wm = np.asarray(write_mask, bool).reshape(-1)
        if wm.shape != pos0.shape:
            raise ValueError("write_mask and positions differ in shape")
        b = pos0.shape[0]
        positions = pos0[:, None] + np.arange(k)[None, :]  # [B, K]
        wslots = np.flatnonzero(wm)
        if tables is not None:
            tables = np.asarray(tables, np.int64)
            _check_blocks(tables, num_blocks)
            bs = max_seq // tables.shape[1]
        last = positions.max(initial=0) + steps - 1
        if positions.min(initial=0) < 0 or last >= max_seq:
            raise ValueError(f"decode positions reach {last}, past the "
                             f"cache line of {max_seq} positions")
        n = wslots.shape[0]
        wpos = positions[wslots].reshape(-1)  # [n*K], slot-major
        if tables is None:
            rows = [np.repeat(wslots, k), wpos]
        else:  # every pass's rows: [steps, n*K] blocks, then offsets
            p = wpos[None, :] + np.arange(steps)[:, None]
            rows = [tables[np.repeat(wslots, k)[None, :], p // bs].reshape(-1),
                    (p % bs).reshape(-1), tables.reshape(-1)]
        packed = np.concatenate([positions.reshape(-1), wslots, *rows])
        t = _h2d(packed, device)
        o = b * k
        self._positions = t[:o].view(b, k)
        self.wslots = t[o:o + n]
        o += n
        m = n * k
        self.tables = None
        if tables is None:
            self._row0, self._row2 = t[o:o + m], t[o + m:o + 2 * m]
        else:
            self._row0 = t[o:o + steps * m].view(steps, m)
            self._row2 = t[o + steps * m:o + 2 * steps * m].view(steps, m)
            self.tables = t[o + 2 * steps * m:].view(tables.shape)
        self._kpos = torch.arange(max_seq, device=device)

    def at(self, j: int):
        """(positions [B, K], the rows pass j writes as (first, third)
        cache indices, blocked [B, 1, K, S]) of pass j (positions shifted
        by j)."""
        pos = self._positions + j if j else self._positions
        if self.tables is None:
            rows = (self._row0, self._row2 + j if j else self._row2)
        else:
            rows = (self._row0[j], self._row2[j])
        blocked = (self._kpos[None, None, :] > pos[:, :, None])[:, None]
        return pos, rows, blocked


def _write_rows(cache_l, new, idx: _DecodeIndex, rows) -> None:
    """cache_l [B, Hkv, S, D] (or the pool's [NB, Hkv, bs, D]) <- new
    [B, Hkv, K, D] at each write-masked slot's K rows; touches only those
    rows (torch has no dropping scatter: masked slots are left out)."""
    _, hkv, _, d = new.shape
    vals = new.permute(0, 2, 1, 3).index_select(0, idx.wslots)
    cache_l[rows[0], :, rows[1]] = vals.reshape(-1, hkv, d)


def _multi_token_impl(cfg: LlamaConfig, w: PreparedParams, cache, tokens,
                      idx: _DecodeIndex, j: int = 0):
    """Consume K tokens per slot in one pass against the KV cache: JAX's
    ``_multi_token_impl`` and, when ``idx`` carries block tables,
    ``_multi_token_impl_blocked`` (row writes into the pool, attention over
    each slot's gathered line), in one body.

    tokens: [B, K] on the device; pass ``j`` of ``idx``: tokens[:, t] is
    written at positions0 + j + t and attends kv through its own position.
    Returns (cache, logits [B, K, V] f32)."""
    b, k = tokens.shape
    positions, rows, blocked = idx.at(j)
    x = _embed(w, tokens)  # [B, K, H]
    cos, sin = rope_cos_sin(positions, w.inv_freq)
    for l, lp in enumerate(w.layers):
        xn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, kk, v = _project_qkv(cfg, lp, xn, b, k)
        q = apply_rope_cs(q, cos, sin)
        kk = apply_rope_cs(kk, cos, sin)
        k_l, v_l = cache["k"][l], cache["v"][l]
        _write_rows(k_l, kk, idx, rows)
        _write_rows(v_l, v, idx, rows)
        if idx.tables is not None:
            k_l = _gather_batch_kv(k_l, idx.tables)
            v_l = _gather_batch_kv(v_l, idx.tables)
        x = _attn_out(lp, _attention(cfg, q, k_l, v_l, blocked), x, w.tp)
        x = _mlp(cfg, lp, x, w.tp)
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
def decode_step_blocked(cfg: LlamaConfig, params, cache, tables, tokens,
                        positions, write_mask):
    """decode_step against the block pool; ``tables`` [B, MB] host array
    (ray_tpu/llm/engine.py:517)."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    idx = _blocked_index(cache, tables, positions, write_mask, 1, 1)
    cache, logits = _multi_token_impl(cfg, w, cache,
                                      _as_tokens(tokens, dev)[:, None], idx)
    return cache, logits[:, 0]


def _blocked_index(cache, tables, positions0, write_mask, k: int,
                   steps: int) -> _DecodeIndex:
    _, nb, _, bs, _ = cache["k"].shape
    tables = np.asarray(tables)
    return _DecodeIndex(positions0, write_mask, k, steps,
                        tables.shape[1] * bs, cache["k"].device, tables, nb)


def _burst(cfg, w, cache, tok, idx, temps, top_ps, generator, steps: int,
           need_top_p: bool):
    out = torch.empty((steps, tok.shape[0]), dtype=torch.long,
                      device=tok.device)
    for j in range(steps):
        cache, logits = _multi_token_impl(cfg, w, cache, tok[:, None], idx, j)
        tok = sample_tokens(logits[:, 0], temps, top_ps, 0, generator,
                            need_top_p)
        out[j] = tok
    return cache, out


@torch.no_grad()
def decode_burst(cfg: LlamaConfig, params, cache, token0, positions0,
                 write_mask, temps, top_ps, generator: torch.Generator,
                 steps: int, need_top_p: bool = True):
    """``steps`` chained decode+sample steps in one dispatch: each sampled
    token feeds the next step on the device, nothing is read back.
    Greedy/temperature/top-p sampling (top-k takes single steps).
    Returns (cache, tokens [steps, B] int64 on the device)."""
    dev = cache["k"].device
    idx = _DecodeIndex(positions0, write_mask, 1, steps,
                       cache["k"].shape[3], dev)
    return _burst(cfg, prepare_params(cfg, params), cache,
                  _as_tokens(token0, dev), idx, _as_f32(temps, dev),
                  _as_f32(top_ps, dev), generator, steps, need_top_p)


@torch.no_grad()
def decode_burst_blocked(cfg: LlamaConfig, params, cache, tables, token0,
                         positions0, write_mask, temps, top_ps,
                         generator: torch.Generator, steps: int,
                         need_top_p: bool = True):
    """decode_burst against the block pool (ray_tpu/llm/engine.py:525):
    the engine allocates blocks covering positions0 + steps for every
    written slot before the dispatch; the tables are uploaded once."""
    dev = cache["k"].device
    idx = _blocked_index(cache, tables, positions0, write_mask, 1, steps)
    return _burst(cfg, prepare_params(cfg, params), cache,
                  _as_tokens(token0, dev), idx, _as_f32(temps, dev),
                  _as_f32(top_ps, dev), generator, steps, need_top_p)


# Speculative decoding (ray_tpu/llm/engine.py:308-351). Rollback is free:
# entries written past the accepted prefix sit at positions >= next_pos,
# which every later read masks and every later write overwrites.


@torch.no_grad()
def draft_propose(cfg: LlamaConfig, params, cache, token0, positions0,
                  k: int, write_mask):
    """Greedy-propose ``k`` tokens with the draft model in one dispatch:
    k + 1 decode steps, so the last proposal's KV is written too (its own
    proposal is dropped) and a fully accepted tick needs no catch-up.
    Returns (cache, proposals [B, k] int64 on the device)."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    tok = _as_tokens(token0, dev)
    idx = _DecodeIndex(positions0, write_mask, 1, k + 1,
                       cache["k"].shape[3], dev)
    out = torch.empty((tok.shape[0], k + 1), dtype=torch.long, device=dev)
    for j in range(k + 1):
        cache, logits = _multi_token_impl(cfg, w, cache, tok[:, None], idx, j)
        tok = torch.argmax(logits[:, 0], dim=-1)
        out[:, j] = tok
    return cache, out[:, :k]


@torch.no_grad()
def spec_verify_step(cfg: LlamaConfig, params, cache, tokens, positions0,
                     write_mask):
    """Target forward over K tokens per slot in one pass (decode_step is
    its K = 1 case). tokens: [B, K], the last sampled token then the
    draft's proposals; positions0 / write_mask: [B] host arrays. Writes
    K/V at positions0 .. positions0 + K - 1 and returns (cache, logits
    [B, K, V] f32): logits[:, j] scores the token at positions0 + j + 1."""
    w = prepare_params(cfg, params)
    dev = cache["k"].device
    tokens = _as_tokens(tokens, dev)
    idx = _DecodeIndex(positions0, write_mask, tokens.shape[1], 1,
                       cache["k"].shape[3], dev)
    return _multi_token_impl(cfg, w, cache, tokens, idx)


@torch.no_grad()
def copy_prefix_kv(cfg: LlamaConfig, cache, src_slot: int, dst_slot: int):
    """Copy one slot's whole KV line to another slot, all layers at once
    (prefix-cache adoption from a donor). Positions past the adopted
    prefix are masked by ``length``/``positions`` downstream."""
    cache["k"][:, dst_slot] = cache["k"][:, src_slot]
    cache["v"][:, dst_slot] = cache["v"][:, src_slot]
    return cache


@torch.no_grad()
def copy_blocks(cache, src_blocks, dst_blocks):
    """Copy pool blocks src[i] -> dst[i], all layers (blocked prefix
    adoption: a content copy). src/dst: host arrays, uploaded at once."""
    src = np.asarray(src_blocks, np.int64).reshape(-1)
    dst = np.asarray(dst_blocks, np.int64).reshape(-1)
    nb = cache["k"].shape[1]
    _check_blocks(src, nb)
    _check_blocks(dst, nb)
    t = _h2d(np.concatenate([src, dst]), cache["k"].device)
    n = src.shape[0]
    for name in ("k", "v"):
        cache[name].index_copy_(1, t[n:], cache[name].index_select(1, t[:n]))
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
    preloaded: tuple | None = None  # (kv_k, kv_v, first_token) P/D import
    last_slot: int = -1  # slot the request last occupied (KV export)
    hold_slot: bool = False  # keep the slot (and its KV) after finishing
    draft_len: int = 0  # draft-cache positions filled (speculative decoding)
    draft_fail_count: int = 0  # consecutive draft catch-up failures
    spec_disabled: bool = False  # excluded from speculation (see _spec_decode)
    arrival_seq: int = 0  # admission order: preemption evicts later ones
    prefill_gen: int = 0  # bumped on preemption: stale deferred fetches no-op
    n_prompt: int = -1  # the submitted prompt's length, once preempted
    # Request tracing: the submitter's propagated context (None = untraced)
    # — the scheduler thread stamps this request's queue/prefill/decode
    # phase spans onto it.
    trace_ctx: dict | None = None
    cancelled: bool = False  # its reader is gone: finish at the next token
    submit_ts: float = 0.0
    admit_ts: float = 0.0
    first_token_ts: float = 0.0
    kv_imported: bool = False  # a P/D hand-off continuation


@dataclass
class GenerationResult:
    request_id: str
    prompt_ids: list[int]
    token_ids: list[int]
    text: str
    finish_reason: str


def _unported(config: LLMConfig) -> None:
    if config.placement_group_config is not None:
        raise NotImplementedError(
            "placement_group_config: gang placement groups need the "
            "cluster runtime (ROADMAP Queue A item 7(b))")
    if config.engine_kwargs:
        raise NotImplementedError(
            f"engine_kwargs {sorted(config.engine_kwargs)}: the engine "
            "takes its options as LLMConfig fields")


def _check_tp_devices(tp: int, device: torch.device) -> None:
    """A tp engine's ranks sit on cards 0..tp-1, rank 0 on cuda:0 (JAX's on
    ``jax.devices()[:tp]``); on the CPU they are processes."""
    if device.type != "cuda":
        return
    n = torch.cuda.device_count()
    if tp > n:
        raise ValueError(
            f"tensor_parallel_size={tp} but only {n} CUDA devices are "
            "visible")
    if device.index != 0:
        raise ValueError(
            f"a tensor-parallel engine's rank 0 runs on cuda:0 (ranks on "
            f"cards 0..{tp - 1}), not {device}")


def _load_checkpoint(path: str, dtype: str | None):
    """(config or None, CPU params) from ``path``: an HF Llama directory
    (config.json; its geometry comes back too) through llm/hf.py, else a
    save_pytree (DCP) directory, whose float leaves are cast to ``dtype``
    when one is given."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory {path!r} not found")
    if os.path.isfile(os.path.join(path, "config.json")):
        from ray_tpu_torch.llm.hf import convert_hf_llama

        return convert_hf_llama(path, dtype=dtype)
    from ray_tpu_torch.train.checkpoint import restore_pytree

    params = restore_pytree(path)
    if dtype is not None:
        dt = getattr(torch, dtype)
        params = tree_map(lambda t: t.to(dt) if t.is_floating_point()
                          else t, params)
    return None, params


def _kv_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A payload's KV as a CPU tensor in the cache dtype: the port's
    tensors, or numpy arrays (JAX's ml_dtypes bfloat16 through float32,
    which is exact)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(dtype)


def _leaf_specs(tree) -> list:
    """(path, shape, dtype name) of every leaf: what a follower allocates
    before rank 0 sends it the leaves."""
    from ray_tpu_torch.parallel.sharding import tree_paths

    return [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in tree_paths(tree)]


def _empty_tree(specs, device: torch.device) -> dict:
    out: dict = {}
    for path, shape, dtype in specs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, dtype=getattr(torch, dtype),
                                     device=device)
    return out


class _RankCalls:
    """The scheduler's device calls: each a method on host arguments that
    every tensor-parallel rank runs on its own blocks (rank 0 through
    ``LLMEngine._call``, which hands the call to the followers first). A
    result that a later call consumes stays on each rank: the last logits
    (``_c_sample`` samples them) and the last burst's tokens (a chained
    burst starts from them). State: ``model_cfg`` (the whole geometry),
    ``_rank_cfg`` (this rank's), ``_weights``, ``cache``, ``draft_cfg``,
    ``_draft_weights``, ``draft_cache``, ``_generator`` and ``_comm``
    (llm/tp.py's group; None on one rank)."""

    _comm = None
    _logits = None
    _toks = None
    _sampled = None  # the sampled tokens while a query records them

    def _tp_layout(self) -> None:
        """This rank's kv heads and, for an export, the first rank holding
        each kv head (a head tp does not split is on several)."""
        from ray_tpu_torch.llm.tp import rank_layout

        n = self._comm.size
        layouts = [rank_layout(self.model_cfg, n, r) for r in range(n)]
        self._kv_range = layouts[self._comm.rank].kv_heads
        self._kv_owners = []
        for h in range(self.model_cfg.num_kv_heads):
            r = next(r for r, lay in enumerate(layouts)
                     if lay.kv_heads[0] <= h < lay.kv_heads[1])
            self._kv_owners.append((r, h - layouts[r].kv_heads[0]))

    def _new_cache(self) -> dict:
        if self.blocked:
            return init_kv_cache_blocked(self._rank_cfg, self.num_blocks,
                                         self.block_size, self.device)
        return init_kv_cache(self._rank_cfg, self.max_slots, self.max_seq,
                             self.device)

    def _record(self, tok: torch.Tensor) -> None:
        if self._sampled is not None:
            self._sampled.append(tok.cpu().numpy().reshape(-1))

    def _c_prefill(self, toks, kv_len: int, length: int, slot: int,
                   table_row):
        """One prefill chunk (``table_row``: the slot's block table, or
        None for a dense line); returns the last real token's logits."""
        tok = _h2d(toks, self.device)
        if table_row is not None:
            self.cache, logits = prefill_chunk_blocked(
                self._rank_cfg, self._weights, self.cache, table_row, tok,
                kv_len, length)
        else:
            self.cache, logits = prefill_chunk(
                self._rank_cfg, self._weights, self.cache, tok, kv_len,
                length, slot)
        self._logits = logits[None]
        return logits

    def _c_decode(self, tokens, positions, write, tables):
        """One decode step for every slot (``tables``: the block pool's, or
        None); returns logits [B, V]."""
        tok = _h2d(tokens, self.device)
        if tables is not None:
            self.cache, logits = decode_step_blocked(
                self._rank_cfg, self._weights, self.cache, tables, tok,
                positions, write)
        else:
            self.cache, logits = decode_step(
                self._rank_cfg, self._weights, self.cache, tok, positions,
                write)
        self._logits = logits
        return logits

    def _c_sample(self, temps, top_ps, top_k: int):
        """Sample the last call's logits; every rank draws from equal
        logits with a generator seeded alike, so the tokens agree."""
        tok = sample_tokens(self._logits.float(), _h2d(temps, self.device),
                            _h2d(top_ps, self.device), top_k,
                            self._generator, bool((top_ps < 1.0).any()))
        self._record(tok)
        return tok

    def _c_burst(self, token0, positions0, write, temps, top_ps, steps: int,
                 need_top_p: bool, tables):
        """A decode burst from ``token0`` (a host array; None chains from
        the last burst's final tokens on the device)."""
        tok = self._toks[-1] if token0 is None else _h2d(token0, self.device)
        if tables is not None:
            self.cache, toks = decode_burst_blocked(
                self._rank_cfg, self._weights, self.cache, tables, tok,
                positions0, write, temps, top_ps, self._generator, steps,
                need_top_p)
        else:
            self.cache, toks = decode_burst(
                self._rank_cfg, self._weights, self.cache, tok, positions0,
                write, temps, top_ps, self._generator, steps, need_top_p)
        self._toks = toks
        self._record(toks)
        return toks

    def _c_spec(self, token0, positions0, k: int, write):
        """The draft's k proposals (the draft whole on every rank), then the
        target's verify forward; returns (proposals, logits [B, k+1, V])."""
        tok0 = _h2d(token0, self.device)
        self.draft_cache, proposals = draft_propose(
            self.draft_cfg, self._draft_weights, self.draft_cache, tok0,
            positions0, k, write)
        verify = torch.cat([tok0[:, None], proposals], dim=1)  # [B, k+1]
        self.cache, logits = spec_verify_step(
            self._rank_cfg, self._weights, self.cache, verify, positions0,
            write)
        return proposals, logits

    def _c_draft_prefill(self, toks, start: int, length: int, slot: int):
        self.draft_cache, _ = prefill_chunk(
            self.draft_cfg, self._draft_weights, self.draft_cache,
            _h2d(toks, self.device), start, length, slot)

    def _c_copy_prefix(self, src: int, dst: int) -> None:
        self.cache = copy_prefix_kv(self._rank_cfg, self.cache, src, dst)

    def _c_copy_blocks(self, src, dst) -> None:
        self.cache = copy_blocks(self.cache, src, dst)

    def _c_new_cache(self) -> None:
        self.cache = None  # release the old pool before allocating anew
        self.cache = self._new_cache()

    def _c_new_draft_cache(self) -> None:
        self.draft_cache = None
        self.draft_cache = init_kv_cache(self.draft_cfg, self.max_slots,
                                         self.max_seq, self.device)

    def _c_import_kv(self, slot: int, p: int, kv_k, kv_v) -> None:
        """Write a payload's KV [L, Hkv, p, D] (CPU tensors, all kv heads)
        into ``slot``'s line. Under tp rank 0 broadcasts it (a follower is
        passed None) and each rank keeps its own heads."""
        cfg = self.model_cfg
        for name, t in (("k", kv_k), ("v", kv_v)):
            if t is None:
                t = torch.empty((cfg.num_layers, cfg.num_kv_heads, p,
                                 cfg.head_dim), dtype=cfg.torch_dtype,
                                device=self.device)
            elif self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            if self._comm is not None:
                t = self._comm.broadcast(t.contiguous())
                t = t[:, self._kv_range[0]:self._kv_range[1]]
            self.cache[name][:, slot, :, :p] = t

    def _c_export_kv(self, slot: int, p: int):
        """Under tp: every rank's heads of ``slot``'s first ``p`` positions,
        all-gathered; rank 0 returns the whole (kv_k, kv_v) [L, Hkv, p, D]
        on the CPU, the followers None."""
        out = []
        for name in ("k", "v"):
            g = self._comm.all_gather(self.cache[name][:, slot, :, :p])
            if self._comm.rank == 0:
                t = torch.stack([g[r, :, i] for r, i in self._kv_owners],
                                dim=1)
                out.append(_HostFetch(t).tensor() if t.is_cuda else t)
        return tuple(out) if out else None

    def _c_set_draft(self, params) -> None:
        """The draft's weights, whole on every rank: under tp rank 0
        broadcasts each leaf (a follower is passed their specs)."""
        if self._comm is not None:
            from ray_tpu_torch.parallel.sharding import tree_paths

            if isinstance(params, list):
                params = _empty_tree(params, self.device)
            for _, t in tree_paths(params):
                self._comm.broadcast(t)
        self._draft_params = params
        self._draft_weights = prepare_params(self.draft_cfg, params)

    def _c_query(self, what: str):
        """A reading of this rank: "peak_bytes" (the card's allocator),
        "reset_peak", "record" (start keeping every sampled token),
        "sampled" (them, and stop), "rms_norm_launches" (K1's count in
        this process)."""
        cuda = self.device.type == "cuda"
        if what == "peak_bytes":
            return torch.cuda.max_memory_allocated(self.device) if cuda else 0
        if what == "reset_peak":
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            return None
        if what == "record":
            self._sampled = []
            return None
        if what == "sampled":
            out = [int(t) for a in (self._sampled or ()) for t in a]
            self._sampled = None
            return out
        if what == "rms_norm_launches":
            return rms_norm.launches
        raise ValueError(f"unknown rank query {what!r}")


class TPFollower(_RankCalls):
    """A follower rank of a tensor-parallel engine (``python -m
    ray_tpu_torch.llm.tp`` builds it): its weight blocks (scattered by rank
    0, leaf by leaf), its share of the KV cache, the whole draft and a
    generator seeded as rank 0's, driven by rank 0's calls."""

    def __init__(self, comm, cfg: LlamaConfig, draft_cfg, max_slots: int,
                 max_seq: int, block_size: int, num_blocks: int, seed: int,
                 leaves: list):
        from ray_tpu_torch.llm.tp import local_config, rank_layout
        from ray_tpu_torch.parallel.sharding import tree_paths

        self.device, self._comm, self.model_cfg = comm.device, comm, cfg
        self._rank_cfg = local_config(cfg, rank_layout(cfg, comm.size,
                                                       comm.rank))
        self._tp_layout()
        self.params = _empty_tree(leaves, self.device)
        for _, t in tree_paths(self.params):
            comm.scatter(t)
        self._weights = prepare_params(self._rank_cfg, self.params, comm)
        self.max_slots, self.max_seq = max_slots, max_seq
        self.block_size, self.num_blocks = block_size, num_blocks
        self.blocked = block_size > 0
        self.cache = self._new_cache()
        self.draft_cfg = draft_cfg
        self._draft_params = self._draft_weights = self.draft_cache = None
        if draft_cfg is not None:
            self._c_new_draft_cache()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed + 1)


class LLMEngine(_RankCalls):
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
        self.tp_size = int(config.tensor_parallel_size or 1)
        if self.tp_size > 1:
            _check_tp_devices(self.tp_size, self.device)
        self.model_cfg = config.model_config()
        self.tokenizer = get_tokenizer(config.tokenizer)
        self.max_slots = config.max_num_seqs
        if params is None and config.checkpoint_path:
            ck_cfg, params = _load_checkpoint(config.checkpoint_path,
                                              config.dtype)
            if ck_cfg is not None:  # an HF checkpoint's own geometry
                self.model_cfg = ck_cfg
        # Validate against the final geometry (an HF checkpoint replaces
        # config.model, and its vocab is what the tokenizer must fit).
        self.max_seq = config.max_seq_len or self.model_cfg.max_seq_len
        if self.tokenizer.vocab_size > self.model_cfg.vocab_size:
            raise ValueError("tokenizer vocab exceeds model vocab")

        # KV layout: dense [slots, max_seq] lines or the block pool.
        self.block_size = int(config.kv_block_size or 0)
        self.blocked = self.block_size > 0
        self.num_blocks = 0
        if self.blocked:
            if config.speculative_model is not None:
                raise ValueError(
                    "speculative decoding requires the dense KV layout "
                    "(kv_block_size=0)")
            if self.block_size & (self.block_size - 1):
                raise ValueError("kv_block_size must be a power of two")
            if self.max_seq % self.block_size:
                raise ValueError(
                    "max_seq_len must be a multiple of kv_block_size")
            self.blocks_per_slot = self.max_seq // self.block_size
            self.num_blocks = int(
                config.kv_num_blocks
                or (self.max_slots * self.blocks_per_slot + 1) // 2)
            self._tables = np.zeros(
                (self.max_slots, self.blocks_per_slot), np.int32)
            self._free_blocks: list[int] = list(range(self.num_blocks))
            self._slot_nblk = [0] * self.max_slots
            self.preemptions = 0

        # Speculative decoding: a draft model with its own dense cache,
        # in the target's vocab space (whole on every tp rank).
        self.draft_cfg = config.draft_model_config()
        self.spec_k = max(1, int(config.speculative_tokens))
        self._draft_params = self._draft_weights = None
        self.draft_cache = None
        self.spec_ticks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        dp = None
        if self.draft_cfg is not None:
            if config.speculative_checkpoint_path:
                ck_cfg, dp = _load_checkpoint(
                    config.speculative_checkpoint_path, config.dtype)
                if ck_cfg is not None:
                    self.draft_cfg = ck_cfg
            if self.draft_cfg.vocab_size != self.model_cfg.vocab_size:
                raise ValueError(
                    "speculative draft must share the target's vocab "
                    f"({self.draft_cfg.vocab_size} != "
                    f"{self.model_cfg.vocab_size})")

        if params is None:
            params = init_params(self.model_cfg, generator=config.seed,
                                 device=self.device)
        else:
            params = params_to(params, self.device)
        # Tensor parallelism: the followers start here and take their
        # blocks; this process keeps rank 0's.
        self._tp = None
        self._tp_lock = threading.RLock()
        self._dead: str | None = None  # why a tp engine stopped serving
        self._rank_cfg = self.model_cfg
        self._work = threading.Event()
        if self.tp_size > 1:
            params = self._start_tp(params)
        self.params = params
        self._weights = prepare_params(self._rank_cfg, params, self._comm)
        self.cache = self._new_cache()
        if self.draft_cfg is not None:
            if dp is None:
                dp = init_params(self.draft_cfg, generator=config.seed + 7,
                                 device=self.device)
            self.draft_params = dp
            self.draft_cache = init_kv_cache(self.draft_cfg, self.max_slots,
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
        self._cache_gen = 0  # bumped when a device failure rebuilds the cache
        self._prefill_rr = -1  # last slot that ran a prefill chunk
        self._waiting: queue.Queue[GenerationRequest] = queue.Queue()
        # Held slots handed back by release_slot (user threads); the
        # scheduler thread frees and retires them at tick start.
        self._released: queue.Queue[GenerationRequest] = queue.Queue()
        # Preempted (blocked-KV) requests re-admit ahead of the queue.
        self._preempted: deque[GenerationRequest] = deque()
        self._arrival_seq = 0
        self._submit_lock = threading.Lock()  # guards _arrival_seq
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(config.seed + 1)
        # Pipelined decode: (active snapshot, burst, fetch) of a chained
        # burst awaiting resolution at the next tick's start.
        self._pending_burst = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def draft_params(self):
        return self._draft_params

    @draft_params.setter
    def draft_params(self, params) -> None:
        """Swap the draft's weights (a test hands the target's own for a
        perfect draft); they move to the engine's device (every tp rank's)
        and are prepared once, here."""
        params = tree_map(lambda t: t.to(self.device).contiguous(), params)
        self._call("set_draft", params, remote=(_leaf_specs(params),))

    # ---- tensor parallelism (llm/tp.py) ----

    def _start_tp(self, params: dict) -> dict:
        """Start the followers, scatter every leaf's blocks (rank 0
        initialised, loaded or converted the whole tree) and return rank
        0's. The split is checked first: a dim tp does not divide raises
        ValueError before any process starts."""
        from ray_tpu_torch.llm import tp as tpmod

        n, cfg = self.tp_size, self.model_cfg
        meta = tree_map(lambda t: t.to("meta"), params)
        leaves = [(path, tuple(b[0].shape),
                   str(b[0].dtype).removeprefix("torch."))
                  for path, b in tpmod.rank_blocks(cfg, meta, n)]
        self._rank_cfg = tpmod.local_config(cfg, tpmod.rank_layout(cfg, n, 0))
        self._tp = tpmod.TPGroup(n, self.device, on_broken=self._tp_broken)
        try:
            self._comm = self._tp.comm
            self._tp_layout()
            self._tp.send("init", (dict(
                cfg=cfg, draft_cfg=self.draft_cfg, max_slots=self.max_slots,
                max_seq=self.max_seq, block_size=self.block_size,
                num_blocks=self.num_blocks, seed=self.config.seed,
                leaves=leaves),))
            mine: dict = {}
            for path, b in tpmod.rank_blocks(cfg, params, n):
                node = mine
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = self._comm.scatter(torch.empty_like(b[0]), b)
            del params, b
            self._tp.wait_ready()
        except BaseException:
            self._tp.close()
            raise
        return mine

    def _tp_broken(self, err: str) -> None:
        """The monitor's word that a follower exited: wake the scheduler,
        whose next tick fails every request."""
        self._work.set()

    def _call(self, name: str, *args, remote: tuple | None = None):
        """Run device call ``name`` (``_RankCalls._c_<name>``) here; under tp
        hand it to every follower first (``remote``: their arguments where
        they differ). A call that fails under tp ends the engine: its ranks
        can no longer be known to be in step."""
        fn = getattr(self, "_c_" + name)
        if self._tp is None:
            return fn(*args)
        with self._tp_lock:
            if self._dead is not None:
                raise RuntimeError(self._dead)
            try:
                self._tp.send(name, args if remote is None else remote)
                return fn(*args)
            except BaseException as e:
                self._die(self._tp.broken or f"{name} failed: {e!r}")
                raise

    def _die(self, err: str) -> None:
        """A tp engine stops serving: its followers end (killed if they
        hang); requests fail with ``err`` from the next tick on."""
        if self._dead is None:
            self._dead = f"tensor-parallel engine stopped: {err}"
            self._tp.close()
            self._work.set()

    def tp_query(self, what: str) -> list:
        """One reading per rank, in rank order (``_RankCalls._c_query``:
        peak memory, recorded samples, K1's launches); a one-element list
        at tp 1."""
        if self._tp is None:
            return [self._c_query(what)]
        with self._tp_lock:
            mine = self._call("query", what)
            return [mine, *self._tp.replies()]

    @property
    def error(self) -> str | None:
        """Why a tensor-parallel engine stopped serving (None while it
        serves)."""
        return self._dead

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
        return self._enqueue(req)

    def _enqueue(self, req: GenerationRequest) -> GenerationRequest:
        # Capture the submitter's trace context while its thread-local is
        # live: the scheduler thread stamps the engine phase spans onto
        # the REQUEST's trace from a thread that never entered it.
        req.trace_ctx = tracing.inject() if tracing.current_context() \
            else None
        req.submit_ts = time.time()
        with self._submit_lock:
            self._arrival_seq += 1
            req.arrival_seq = self._arrival_seq
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

    # -- prefill/decode disaggregation: a prefill engine computes the
    #    prompt's KV once, ships it, and a decode engine continues --

    def prefill_only(self, prompt: str | list[int],
                     sampling: SamplingParams | None = None) -> dict:
        """Run ONLY the prompt prefill; return the prompt's KV (CPU tensors
        [L, Hkv, P, D] in the cache dtype) and the first sampled token, for
        a decode engine's ``submit_prefilled``."""
        if self.blocked:
            raise ValueError(
                "prefill/decode disaggregation exports dense KV lines; "
                "run the prefill engine with kv_block_size=0")
        sampling = sampling or SamplingParams()
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        ids = ids[: self.max_seq - 1]
        req = GenerationRequest(
            request_id=uuid.uuid4().hex[:12], prompt_ids=ids,
            sampling=replace(sampling, max_tokens=1), hold_slot=True)
        self._enqueue(req)
        try:
            if not req.done.wait(120):
                raise TimeoutError("prefill timed out")
            # The cache and its generation BEFORE the error check: a device
            # failure that rebuilds the cache mid-export turns into an
            # error below instead of an export of the fresh zeros.
            cache, gen = self.cache, self._cache_gen
            if req.error:
                raise RuntimeError(req.error)
            p = len(ids)
            # hold_slot kept the slot reserved: no admit overwrote its
            # line. The copies queue on the device's current stream behind
            # the prefill that wrote it.
            if self._tp is not None:  # every rank's heads, gathered
                kv_k, kv_v = self._call("export_kv", req.last_slot, p)
            else:
                lines = [cache[n][:, req.last_slot, :, :p]
                         for n in ("k", "v")]
                if self.device.type == "cuda":
                    fetches = [_HostFetch(t) for t in lines]
                    kv_k, kv_v = (f.tensor() for f in fetches)
                else:
                    kv_k, kv_v = (t.clone() for t in lines)
            if self._cache_gen != gen or req.error:
                raise RuntimeError(
                    req.error or "KV cache lost during prefill export")
        finally:
            # On timeout the request may still run: without hold_slot its
            # own _finish frees the slot (an orphaned hold leaks it).
            req.hold_slot = False
            self.release_slot(req)
        return {"prompt_ids": ids, "kv_k": kv_k, "kv_v": kv_v,
                "first_token": req.out_tokens[0],
                "finish_reason": req.finish_reason}

    def release_slot(self, req: GenerationRequest) -> None:
        """Return a ``hold_slot`` reservation (prefill_only's export is
        done). The scheduler thread frees the slot and retires its line as
        a cached prefix (a prefill engine so builds the prefix cache it
        publishes); freeing here would race the scheduler's admit."""
        self._released.put(req)
        self._work.set()

    def _process_releases(self) -> None:
        """Scheduler-thread half of release_slot."""
        while True:
            try:
                req = self._released.get_nowait()
            except queue.Empty:
                return
            if req.finish_reason is None and not req.error:
                # The export timed out while the prefill still runs: its
                # _finish (hold_slot was dropped) frees the slot.
                continue
            for slot, r in self._slots.items():
                if r is req:
                    self._slots[slot] = None
                    self._prefix_live.pop(slot, None)
                    if self.blocked:
                        self._free_slot_blocks(slot)
                    elif (req.finish_reason not in (None, "error")
                          and not req.error):
                        # A clean prefill: the line holds exactly the
                        # prompt's prefix. Retire it.
                        self._prefix_cached[slot] = (
                            tuple(req.prompt_ids), time.monotonic())

    def submit_prefilled(self, payload: dict,
                         sampling: SamplingParams | None = None,
                         stream: bool = False) -> GenerationRequest:
        """Continue decoding from a shipped prefill (KV import). The
        payload's KV may be the port's CPU tensors or numpy arrays (a JAX
        engine's payload, bfloat16 included)."""
        if self.blocked:
            raise ValueError(
                "KV import writes dense KV lines; run the decode engine "
                "with kv_block_size=0")
        sampling = sampling or SamplingParams()
        req = GenerationRequest(
            request_id=uuid.uuid4().hex[:12],
            prompt_ids=[int(t) for t in payload["prompt_ids"]],
            sampling=sampling,
            stream_queue=queue.Queue() if stream else None)
        dt = self.model_cfg.torch_dtype
        req.preloaded = (_kv_tensor(payload["kv_k"], dt),
                         _kv_tensor(payload["kv_v"], dt),
                         int(payload["first_token"]))
        req.kv_imported = True
        return self._enqueue(req)

    def cancel(self, req: GenerationRequest) -> None:
        """Stop generating for a request whose reader went away (a client
        that closed its stream): it finishes, and frees its slot, at its
        next token."""
        req.cancelled = True

    def shutdown(self) -> None:
        """Stop the scheduler thread and, under tp, every follower. A
        request still held ends with an error: a replica here is a thread
        of the process (a process in ray_tpu, whose exit ends its
        waiters), and a handler left waiting would hold its pool thread,
        and the process's exit, for its whole timeout."""
        self._stop.set()
        self._work.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5)
        if self._tp is not None:
            self._tp.close()
        if not self._thread.is_alive():
            self._fail_held("the engine was shut down")

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
        out = {"active": active, "waiting": self._waiting.qsize(),
               "slots": self.max_slots,
               "prefix_hits": self.prefix_hits,
               "prefix_tokens_saved": self.prefix_tokens_saved,
               "prefix_cached_slots": len(self._prefix_cached),
               "prefix_block": self.prefix_block,
               "prefill_chunks": self.prefill_chunks,
               "decode_bursts": self.decode_bursts,
               "chained_bursts": self.chained_bursts}
        if self.blocked:
            out["kv_blocks_total"] = self.num_blocks
            out["kv_blocks_free"] = len(self._free_blocks)
            out["kv_block_size"] = self.block_size
            out["preemptions"] = self.preemptions
        if self.draft_cfg is not None:
            out["spec_ticks"] = self.spec_ticks
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_acceptance"] = (
                round(self.spec_accepted / self.spec_proposed, 3)
                if self.spec_proposed else 0.0)
        if self._tp is not None:
            tp = self._tp
            out["tp"] = {
                "size": self.tp_size, "headers": tp.headers,
                "header_us": (tp.header_s / tp.headers * 1e6
                              if tp.headers else 0.0),
                "collectives": self._comm.collectives,
                "followers_alive": sum(tp.alive()), "error": self._dead}
        return out

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
        if self._tp is not None and (self._dead or self._tp.broken):
            return self._fail_dead()
        self._process_releases()
        worked = self._admit()
        deferred: list = []
        try:
            return self._tick_inner(deferred) or worked
        finally:
            # Whatever was dispatched, resolve it: a stranded deferred
            # fetch would leave its request prefilled but never decoding.
            self._resolve_prefills(deferred)

    def _fail_dead(self) -> bool:
        """A stopped tp engine fails what it holds and what arrives."""
        self._die(self._tp.broken or "a rank failed")
        self._pending_burst = None
        failed = self._fail_held(self._dead)
        self._slots = {i: None for i in range(self.max_slots)}
        self._prefix_live.clear()
        self._prefix_cached.clear()
        return failed

    def _fail_held(self, err: str) -> bool:
        """Fail every request in a slot or waiting; True if there was one."""
        failed = False
        for req in list(self._slots.values()):
            if req is not None and not req.done.is_set():
                self._fail(req, err)
                failed = True
        while True:
            try:
                req = self._next_waiting()
            except queue.Empty:
                return failed
            self._fail(req, err)
            failed = True

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
        if decoding and self._draft_params is not None:
            # Greedy requests with room for a speculative tick speculate;
            # the rest (sampled, near the cache end) decode plainly in the
            # same tick.
            spec = {s: r for s, r in decoding.items()
                    if r.sampling.temperature <= 0.0
                    and r.next_pos + self.spec_k + 1 < self.max_seq}
            rest = {s: r for s, r in decoding.items() if s not in spec}
            if spec:
                self._spec_decode(spec)
            # A device failure in the speculative half failed every slot.
            rest = {s: r for s, r in rest.items()
                    if self._slots.get(s) is r and not r.done.is_set()}
            if rest:
                self._decode(rest)
            return True
        if decoding:
            self._decode(decoding)
            worked = True
        return worked

    def _resolve_prefills(self, deferred: list) -> None:
        """Fetch the deferred first tokens (dispatched in _prefill_step)
        and start those requests decoding. Runs AFTER the tick's decode
        dispatch so the fetch overlaps the queued device work."""
        for req, gen, fetch in deferred:
            if req.done.is_set():  # failed meanwhile (device recovery)
                continue
            if gen != req.prefill_gen:
                # Preempted after this fetch was dispatched: the token
                # belongs to a KV state that no longer exists (emitting it
                # would duplicate the re-prefill's first token).
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
                req = self._next_waiting()
            except queue.Empty:
                break
            req.admit_ts = time.time()
            if req.preloaded is not None:
                slot = self._take_slot()
                try:
                    self._admit_prefilled(req, slot)
                except Exception as e:  # noqa: BLE001 - bad KV payload
                    self._slots[slot] = None
                    self._fail(req, f"KV import failed: {e!r}")
                admitted = True
                continue
            donor, adopt, retired = self._best_prefix(req.prompt_ids)
            req.prefilled_len = 0
            if self.blocked:
                self._admit_blocked(req, donor, adopt, retired)
                admitted = True
                continue
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
                self._adopted(req, adopt)
            else:
                slot = self._take_slot()
                if donor is not None and slot == donor:
                    # LRU eviction handed us the donor itself: its KV line
                    # is already in place.
                    self._adopted(req, adopt)
                elif donor is not None:
                    # Content copy from the donor line (live OR retired)
                    # into the fresh slot, preserving the donor.
                    try:
                        self._call("copy_prefix", donor, slot)
                        self._adopted(req, adopt)
                        if donor in self._prefix_cached:
                            self._prefix_cached[donor] = (
                                self._prefix_cached[donor][0],
                                time.monotonic())
                    except Exception as e:  # noqa: BLE001
                        logger.exception("prefix copy failed")
                        self._recover_device_failure(
                            f"prefix copy failed: {e!r}")
                        req.prefilled_len = 0
            self._occupy(slot, req)
            admitted = True
        return admitted

    def _adopted(self, req: GenerationRequest, adopt: int) -> None:
        req.prefilled_len = adopt
        self.prefix_hits += 1
        self.prefix_tokens_saved += adopt

    def _occupy(self, slot: int, req: GenerationRequest) -> None:
        # next_pos < 0 marks "still prefilling" (prefilled_len tracks
        # progress); _finish frees by identity.
        req.next_pos = -1
        req.last_slot = slot
        self._slots[slot] = req

    def _admit_blocked(self, req: GenerationRequest, donor, adopt: int,
                       retired: bool) -> None:
        """Block-pool admission: prefix adoption is a whole-block content
        copy from a LIVE donor (finished requests return their blocks to
        the pool, so there are no retired lines)."""
        slot = self._take_slot()
        adopt = (adopt // self.block_size) * self.block_size
        if (donor is not None and not retired
                and adopt >= max(self.PREFIX_COPY_MIN, self.block_size)
                # preempt=False: an eviction could pick the DONOR, whose
                # freed blocks would become the copy's destination while
                # its table row still names them.
                and self._ensure_blocks(slot, adopt - 1, preempt=False)):
            nb = adopt // self.block_size
            try:
                self._call("copy_blocks", self._tables[donor, :nb],
                           self._tables[slot, :nb])
                self._adopted(req, adopt)
            except Exception as e:  # noqa: BLE001
                logger.exception("block prefix copy failed")
                self._recover_device_failure(f"prefix copy failed: {e!r}")
                req.prefilled_len = 0
        self._occupy(slot, req)

    # ---- blocked-KV pool accounting (scheduler thread only) ----
    #
    # A chained burst still in flight may write blocks the host has freed
    # (a request that finished inside the first burst keeps its rows in
    # the chained burst's snapshot) and that a later admission re-issues.
    # That is safe only by stream order: every later writer of the pool
    # (prefill chunks, decode passes, copy_blocks) is enqueued on the
    # scheduler thread's current stream, behind the in-flight burst. Keep
    # every pool write on that one stream.

    def _ensure_blocks(self, slot: int, upto_pos: int,
                       preempt: bool = True) -> bool:
        """Grow ``slot``'s block table to cover position ``upto_pos``. On
        pool exhaustion, preempt requests that arrived after this slot's
        (unless ``preempt`` is False). False if the pool cannot cover it
        now."""
        need = min(upto_pos // self.block_size + 1, self.blocks_per_slot)
        while self._slot_nblk[slot] < need:
            if not self._free_blocks:
                if preempt and self._preempt_for_blocks(slot):
                    continue
                return False
            self._tables[slot, self._slot_nblk[slot]] = \
                self._free_blocks.pop()
            self._slot_nblk[slot] += 1
        return True

    def _free_slot_blocks(self, slot: int) -> None:
        n = self._slot_nblk[slot]
        if n:
            self._free_blocks.extend(int(b) for b in self._tables[slot, :n])
            self._slot_nblk[slot] = 0

    def _preempt_for_blocks(self, slot: int) -> bool:
        """Evict the NEWEST request that arrived after ``slot``'s and holds
        blocks (vLLM's order: later arrivals yield to earlier ones), by
        recompute: its blocks return to the pool and it is requeued;
        readmitted, its prompt + generated tokens re-prefill and decoding
        continues without re-emitting a token. The oldest request is so
        never evicted and always progresses. (The JAX engine evicts the
        newest other request whatever the requester's age, and counts an
        eviction that freed no block as progress: under pool pressure its
        requests evict one another without end, and its free list can be
        popped empty.) True if blocks were freed."""
        me = self._slots[slot].arrival_seq

        def victims():
            return [(s, r) for s, r in self._slots.items()
                    if r is not None and s != slot and self._slot_nblk[s]
                    and r.arrival_seq > me and not r.done.is_set()
                    and not r.hold_slot and r.preloaded is None]

        if not victims():
            return False
        # An in-flight chained burst still emits for its snapshot: resolve
        # it first so a preempted request can't receive its tokens.
        self._resolve_pending_burst()
        if self._free_blocks:
            return True  # the resolve's finishes freed enough
        left = victims()
        if not left:
            return False
        s, req = max(left, key=lambda sr: sr[1].arrival_seq)
        self._preempt_slot(s, req)
        return True

    def _preempt_slot(self, slot: int, req: GenerationRequest) -> None:
        self.preemptions += 1
        self._prefix_live.pop(slot, None)
        self._slots[slot] = None
        self._free_slot_blocks(slot)
        # Re-prefill the submitted prompt and everything emitted so far.
        # (The JAX engine appends out_tokens to the already-grown prompt,
        # so a second preemption of one request repeats its tokens in the
        # context; the submitted length is kept here to avoid that.)
        if req.n_prompt < 0:
            req.n_prompt = len(req.prompt_ids)
        req.prompt_ids = req.prompt_ids[:req.n_prompt] + list(req.out_tokens)
        req.prefilled_len = 0
        req.next_pos = -1
        req.prefill_gen += 1  # invalidate in-flight deferred fetches
        if len(req.prompt_ids) >= self.max_seq:
            self._finish(req, "length")
        else:
            self._preempted.append(req)

    def _ensure_decode_blocks(self, active: dict, burst: int) -> dict:
        """Cover positions next_pos .. next_pos + burst - 1 for every
        active slot before a decode dispatch; a slot the pool cannot cover
        (even after evicting newer requests) is itself preempted."""
        out = {}
        for slot, req in active.items():
            if self._slots.get(slot) is not req or req.done.is_set():
                continue  # evicted by an earlier slot's ensure
            if self._ensure_blocks(slot, req.next_pos + burst - 1):
                out[slot] = req
            else:
                self._preempt_slot(slot, req)
        # A LATER slot's ensure may have evicted a request accepted above:
        # dispatching it would write through its stale table into blocks
        # the pool already re-issued. Re-filter against the live slots.
        return {s: r for s, r in out.items()
                if self._slots.get(s) is r and not r.done.is_set()}

    def _next_waiting(self) -> GenerationRequest:
        """Preempted requests re-admit ahead of fresh arrivals."""
        if self._preempted:
            return self._preempted.popleft()
        return self._waiting.get_nowait()

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

    def _admit_prefilled(self, req: GenerationRequest, slot: int) -> None:
        """KV import: write the shipped prefill into this slot's line (one
        host-to-device copy each for K and V, queued on the scheduler's
        stream) and enter decode directly, the shipped first token
        emitted first."""
        kv_k, kv_v, first_token = req.preloaded
        want = (self.model_cfg.num_layers, self.model_cfg.num_kv_heads,
                self.model_cfg.head_dim)
        got = (kv_k.shape[0], kv_k.shape[1], kv_k.shape[3]) \
            if kv_k.dim() == 4 else None
        p = kv_k.shape[2] if kv_k.dim() == 4 else 0
        if got != want or p > self.max_seq or kv_v.shape != kv_k.shape:
            raise ValueError(
                f"payload KV shape {tuple(kv_k.shape)} incompatible with "
                f"this engine (layers/kv_heads/head_dim {want}, max_seq "
                f"{self.max_seq})")
        self._call("import_kv", slot, p, kv_k, kv_v,
                   remote=(slot, p, None, None))
        req.preloaded = None
        req.next_pos = p
        req.last_slot = slot
        self._slots[slot] = req
        self._prefix_live[slot] = tuple(req.prompt_ids)  # imported KV = donor
        self._emit(req, first_token)

    def _prefill_step(self, deferred: list) -> bool:
        """Run ONE chunk of ONE prefilling request, rotating across slots so
        concurrent long prompts interleave chunks. A final chunk's
        first-token sample is dispatched and its copy to the host started,
        but not waited for: (req, prefill_gen, fetch) goes to
        ``deferred``."""
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
            if self.blocked and not self._ensure_blocks(
                    slot, req.prefilled_len + bucket - 1):
                if any(self._slot_nblk[s] for s, r in self._slots.items()
                       if r is not None and s != slot):
                    continue  # older requests hold blocks: wait for them
                self._slots[slot] = None
                self._free_slot_blocks(slot)
                self._fail(req, "KV block pool exhausted "
                                f"({self.num_blocks} blocks x "
                                f"{self.block_size} tokens)")
                return True
            try:
                self._call("prefill", toks, req.prefilled_len, p, slot,
                           self._tables[slot] if self.blocked else None)
                req.prefilled_len += take
                self.prefill_chunks += 1
                if req.prefilled_len >= p:  # final chunk: sample 1st token
                    # The slot now holds the full prompt's KV: it becomes a
                    # prefix donor for later shared-prefix requests.
                    self._prefix_live[slot] = tuple(req.prompt_ids)
                    out = self._sample_dispatch([req])
                    deferred.append((req, req.prefill_gen, _HostFetch(out)))
            except Exception as e:  # noqa: BLE001 - e.g. OOM on long prompt
                logger.exception("prefill failed for %s", req.request_id)
                self._recover_device_failure(f"prefill failed: {e!r}")
            return True
        return False

    def _recover_device_failure(self, err: str) -> None:
        """After a failed prefill/decode dispatch the KV cache is suspect
        (a half-written pass): fail every slotted request, then rebuild
        fresh caches (the draft's too) so the engine keeps serving NEW
        traffic. A tp engine instead stops (``_die``): its ranks may have
        parted mid-call."""
        if self._tp is not None:
            self._die(err)
            err = self._dead
        self._cache_gen += 1  # invalidates in-flight prefill_only exports
        self._pending_burst = None  # chained into the lost cache
        for req in list(self._slots.values()):
            if req is None:
                continue
            if req.done.is_set():
                # Finished and held for export: its waiter has the result;
                # mark the held KV unusable so the export raises.
                req.error = err
            else:
                self._fail(req, err)
        self._slots = {i: None for i in range(self.max_slots)}
        self._prefix_live.clear()
        self._prefix_cached.clear()
        if self._dead is not None:
            return
        if self.blocked:
            self._tables[:] = 0
            self._free_blocks = list(range(self.num_blocks))
            self._slot_nblk = [0] * self.max_slots
        self._call("new_cache")
        if self.draft_cfg is not None:
            self._call("new_draft_cache")

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
        """Returns False iff a device failure wiped the engine state
        (callers mid-tick then abandon the rest of the tick)."""
        burst = self._burst_len(active)
        if self.blocked:
            active = self._ensure_decode_blocks(active, burst)
            if not active:
                return True
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
            self._call("decode", tokens, positions, write,
                       self._tables if self.blocked else None)
        except Exception as e:  # noqa: BLE001 - cache state suspect
            logger.exception("decode step failed (%d active)", len(active))
            self._recover_device_failure(f"decode failed: {e!r}")
            return False
        try:
            reqs = [active.get(s) for s in range(self.max_slots)]
            sampled = self._sample_one(reqs)
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

    def _burst_call(self, token0, positions0, write, temps, top_ps,
                    burst: int, need_top_p: bool):
        """``token0``: a host array, or None to chain from the last burst."""
        return self._call("burst", token0, positions0, write, temps, top_ps,
                          burst, need_top_p,
                          self._tables if self.blocked else None)

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
            toks = self._burst_call(tokens, positions, write, temps, top_ps,
                                    burst, need_top_p)
            fetch = _HostFetch(toks)  # copy queued behind the burst
            self.decode_bursts += 1
            chain = self._should_chain(active, burst)
            if chain and self.blocked:
                # A chain never evicts: it runs only when every slot's
                # blocks for the second burst are already coverable.
                chain = all(self._ensure_blocks(
                    s, r.next_pos + 2 * burst - 1, preempt=False)
                    for s, r in active.items())
            if chain:
                toks2 = self._burst_call(None, positions + burst, write,
                                         temps, top_ps, burst, need_top_p)
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
        no prefilling slot, no draft model sharing the tick), every slot
        has cache headroom for TWO bursts, and someone still needs more
        than one burst of tokens."""
        if burst <= 1 or not self.config.decode_pipeline:
            return False
        if self._pending_burst is not None or \
                self._draft_params is not None:
            return False
        if not self._waiting.empty() or self._preempted:
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

    def _spec_decode(self, active: dict[int, GenerationRequest]) -> None:
        """One speculative tick: the draft proposes spec_k tokens per slot
        in one dispatch, the target verifies them (and the bonus position)
        in one forward, and each slot advances by accepted + 1 tokens.
        Greedy acceptance makes the output that of plain greedy decoding
        whatever the draft proposes. The proposals stay on the device:
        one fetch a tick brings back proposals and the target's argmax."""
        k = self.spec_k
        # A request whose draft catch-up keeps failing is excluded from
        # speculation (one bad request must not turn it off for all): it
        # decodes plainly, the rest speculate.
        spec_active = {s: r for s, r in active.items() if not r.spec_disabled}
        plain_active = {s: r for s, r in active.items() if r.spec_disabled}
        if not spec_active:
            self._decode(active)
            return
        if plain_active and not self._decode(plain_active):
            # The plain half hit a device failure: every slot was failed
            # and both caches rebuilt; nothing valid remains to speculate.
            return
        active = spec_active
        # Draft catch-up: a slot whose draft cache lags (fresh prompt,
        # prefix adoption, P/D import) prefills the missing span.
        for slot, req in active.items():
            if req.draft_len < req.next_pos and \
                    not self._draft_catch_up(slot, req):
                # The failure reset the whole draft state (cache rebuilt,
                # every draft_len zeroed): decode this tick plainly.
                self._decode(active)
                return
        token0 = np.zeros((self.max_slots,), np.int64)
        pos0 = np.zeros((self.max_slots,), np.int64)
        write = np.zeros((self.max_slots,), bool)
        for slot, req in active.items():
            token0[slot] = req.out_tokens[-1]
            pos0[slot] = req.next_pos
            write[slot] = True
        try:
            proposals, logits = self._call("spec", token0, pos0, k, write)
            both = _HostFetch(torch.cat(
                [proposals, torch.argmax(logits, dim=-1)], dim=1)).numpy()
        except Exception as e:  # noqa: BLE001 - caches state suspect
            logger.exception("speculative step failed (%d active)",
                             len(active))
            self._recover_device_failure(f"speculative decode failed: {e!r}")
            return
        proposals, greedy = both[:, :k], both[:, k:]  # [B, k], [B, k+1]
        self.spec_ticks += 1
        for slot, req in active.items():
            accepted = 0
            while accepted < k and \
                    proposals[slot, accepted] == greedy[slot, accepted]:
                accepted += 1
            self.spec_proposed += k
            self.spec_accepted += accepted
            emit = [int(t) for t in proposals[slot, :accepted]]
            emit.append(int(greedy[slot, accepted]))  # corrected/bonus
            for tok in emit:
                if req.done.is_set():
                    break
                req.next_pos += 1
                self._emit(req, tok)
            # The draft's KV is valid through the accepted prefix:
            # draft_propose writes k + 1 rows, enough for all accepted.
            req.draft_len = req.next_pos

    def _chunk_bucket(self, start: int, remaining: int) -> tuple[int, int]:
        """(bucket, take) for one prefill chunk starting at ``start``:
        power-of-two bucket from prefill_bucket_min, capped at
        prefill_chunk, and CLAMPED to the cache tail (a window past
        max_seq would make the device functions raise). Blocked chunks
        write whole pool blocks: buckets are power-of-two multiples of
        block_size and starts stay block-aligned."""
        bucket = self.config.prefill_bucket_min
        if self.blocked:
            bucket = max(bucket, self.block_size)
        while bucket < min(remaining, self.config.prefill_chunk):
            bucket *= 2
        bucket = min(bucket, self.max_seq - start)
        return bucket, min(remaining, bucket)

    def _draft_catch_up(self, slot: int, req: GenerationRequest) -> bool:
        """Prefill the draft cache for positions draft_len .. next_pos - 1
        (the tokens the target has consumed)."""
        seq = list(req.prompt_ids) + req.out_tokens[:-1]
        start = req.draft_len
        try:
            while start < req.next_pos:
                bucket, take = self._chunk_bucket(start,
                                                  req.next_pos - start)
                toks = np.zeros((bucket,), np.int64)
                toks[:take] = seq[start:start + take]
                self._call("draft_prefill", toks, start, start + take, slot)
                start += take
            req.draft_len = req.next_pos
            req.draft_fail_count = 0
            return True
        except Exception as e:  # noqa: BLE001 - draft trouble must not
            # kill the request; the caller decodes plainly. The draft cache
            # is suspect: rebuild it and mark every request's draft state
            # cold. A request failing three times in a row is excluded
            # from speculation, so it stops resetting everyone's.
            logger.exception("draft catch-up failed for %s", req.request_id)
            if self._tp is not None:
                self._recover_device_failure(f"draft catch-up failed: {e!r}")
                return False
            req.draft_fail_count += 1
            if req.draft_fail_count >= 3:
                req.spec_disabled = True
                logger.warning("disabling speculation for %s after %d "
                               "failed draft catch-ups", req.request_id,
                               req.draft_fail_count)
            self._call("new_draft_cache")
            for r in self._slots.values():
                if r is not None:
                    r.draft_len = 0
            return False

    def _sample_dispatch(self, reqs) -> torch.Tensor:
        """Sample the last device call's logits (one row per entry of
        ``reqs``) on the device; returns the (unfetched) token tensor so
        callers can defer the host roundtrip."""
        b = len(reqs)
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
        return self._call("sample", temps, top_ps, top_k)

    def _sample_one(self, reqs) -> np.ndarray:
        return _HostFetch(self._sample_dispatch(reqs)).numpy()

    def _emit(self, req: GenerationRequest, token: int) -> None:
        req.out_tokens.append(token)
        if len(req.out_tokens) == 1:
            now = req.first_token_ts = time.time()
            if req.trace_ctx is not None:
                # First token: stamp the TTFT phase breakdown onto the
                # request's trace — queue wait (submit→admit) and the
                # prefill (or P/D KV import) interval ending here.
                if req.admit_ts and req.submit_ts:
                    tracing.record_span(
                        "engine.queue", req.submit_ts, req.admit_ts,
                        ctx=req.trace_ctx,
                        attributes={"request_id": req.request_id})
                tracing.record_span(
                    "engine.kv_import" if req.kv_imported
                    else "engine.prefill",
                    req.admit_ts or req.submit_ts or now, now,
                    ctx=req.trace_ctx,
                    attributes={"request_id": req.request_id,
                                "prompt_tokens": len(req.prompt_ids),
                                "prefix_adopted": req.prefilled_len})
        if req.stream_queue is not None:
            req.stream_queue.put(token)
        eos = {self.tokenizer.eos_id, *req.sampling.stop_token_ids}
        finish = None
        if token in eos:
            finish = "stop"
        elif req.cancelled:
            finish = "abort"
        elif len(req.out_tokens) >= req.sampling.max_tokens:
            finish = "length"
        elif req.next_pos + 1 >= self.max_seq:
            finish = "length"
        if finish:
            self._finish(req, finish)

    def _fail(self, req: GenerationRequest, err: str) -> None:
        """Fail one request: record the error, free its slot and any staged
        KV payload, and wake its waiter — the engine keeps serving others."""
        req.error = err
        req.preloaded = None
        req.hold_slot = False  # never pin a slot for a failed request
        self._finish(req, "error")

    def _finish(self, req: GenerationRequest, reason: str) -> None:
        req.finish_reason = reason
        if req.trace_ctx is not None and req.first_token_ts:
            tracing.record_span(
                "engine.decode", req.first_token_ts, time.time(),
                ctx=req.trace_ctx,
                attributes={"request_id": req.request_id,
                            "tokens": len(req.out_tokens),
                            "finish_reason": reason})
        for slot, r in self._slots.items():
            if r is req:
                req.last_slot = slot
                toks = self._prefix_live.pop(slot, None)
                if req.hold_slot:
                    continue  # released after the export (release_slot)
                self._slots[slot] = None
                if self.blocked:
                    # The pool takes the blocks back; no retired lines.
                    self._free_slot_blocks(slot)
                elif toks is not None and reason != "error":
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
        prompt = req.prompt_ids if req.n_prompt < 0 else \
            req.prompt_ids[:req.n_prompt]
        return GenerationResult(
            request_id=req.request_id, prompt_ids=prompt,
            token_ids=list(toks), text=self.tokenizer.decode(toks),
            finish_reason=req.finish_reason or "stop")
