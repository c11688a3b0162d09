"""ray_tpu_torch's block-pooled KV cache against the JAX engine's.

One JAX initialization drives both sides (``params_from_jax``); pools,
tables and tokens are numpy arrays from fixed seeds. The blocked device
functions are held to JAX's on the same pool and tables: f32 logits and
pool within rtol = atol = 1e-5, bf16 within test_torch_llm.py's 2e-2 with
the same greedy token. Then the JAX package's tests/test_llm_blocked.py,
case by case, on the port's engine (``device="cpu"``), and the port's
blocked engine's greedy streams against JAX's blocked engine's.
"""

import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.llm.engine as jax_engine
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params

from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.engine import (
    copy_blocks,
    decode_burst_blocked,
    decode_step_blocked,
    init_kv_cache_blocked,
    prefill_chunk_blocked,
)
from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
NB, BS = 12, 8
# Two slots of MB = 4 blocks (32 positions); block 0 unallocated in both.
TABLES = np.array([[5, 2, 9, 11], [1, 3, 4, 6]], np.int32)


def _pair(dtype):
    jcfg = replace(JaxLlamaConfig.tiny(), dtype=dtype)
    tcfg = replace(LlamaConfig.tiny(), dtype=dtype)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _pair("float32")


@pytest.fixture(scope="module")
def tiny_bf16():
    return _pair("bfloat16")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


def _pools(jcfg, tcfg):
    return (jax_engine.init_kv_cache_blocked(jcfg, NB, BS),
            init_kv_cache_blocked(tcfg, NB, BS, device="cpu"))


def _prefill_both(jcfg, jp, tcfg, tp, jc, tc, slot, prompt, tol):
    """Chunks of one block through both sides; returns the last logits."""
    n = len(prompt)
    for start in range(0, n, BS):
        toks = np.zeros((BS,), np.int32)
        take = min(BS, n - start)
        toks[:take] = prompt[start:start + take]
        jc, jl = jax_engine.prefill_chunk_blocked(
            jcfg, jp, jc, jnp.asarray(TABLES[slot]), jnp.asarray(toks),
            jnp.int32(start), jnp.int32(n))
        tc, tl = prefill_chunk_blocked(tcfg, tp, tc, TABLES[slot], toks,
                                       start, n)
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    return jc, tc, jl


def test_prefill_chunk_blocked_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _pools(jcfg, tcfg)
    prompt = np.random.default_rng(0).integers(1, 256, 20)
    jc, tc, _ = _prefill_both(jcfg, jp, tcfg, tp, jc, tc, 0, prompt, F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)
    # Only the three blocks the 20 tokens' chunks wrote hold data.
    touched = tc["k"].abs().sum(dim=(0, 2, 3, 4)) > 0
    assert touched.nonzero().flatten().tolist() == [2, 5, 9]


def test_prefill_chunk_blocked_rejects_bad_windows(tiny):
    _, _, tcfg, tp = tiny
    _, tc = _pools(*tiny[::2])
    with pytest.raises(ValueError, match="whole blocks"):
        prefill_chunk_blocked(tcfg, tp, tc, TABLES[0], np.ones(8), 4, 12)
    with pytest.raises(ValueError, match="outside the pool"):
        prefill_chunk_blocked(tcfg, tp, tc, np.array([0, NB, 1, 2]),
                              np.ones(8), 0, 8)


def test_decode_step_blocked_with_masked_slot_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _pools(jcfg, tcfg)
    rng = np.random.default_rng(1)
    for slot, n in ((0, 11), (1, 6)):
        jc, tc, _ = _prefill_both(jcfg, jp, tcfg, tp, jc, tc, slot,
                                  rng.integers(1, 256, n), F32)
    before = tc["k"][:, TABLES[1]].clone()
    tokens = np.array([17, 99], np.int32)
    positions = np.array([11, 6], np.int32)
    write = np.array([True, False])
    jc, jl = jax_engine.decode_step_blocked(
        jcfg, jp, jc, jnp.asarray(TABLES), jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(write))
    tc, tl = decode_step_blocked(tcfg, tp, tc, TABLES, tokens, positions,
                                 write)
    np.testing.assert_allclose(_np(tl[0]), _np(jl[0]), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)
    assert torch.equal(tc["k"][:, TABLES[1]], before)  # masked: untouched
    # Position 11 is row 3 of the slot's second block (pool block 2).
    assert tc["k"][:, 2, :, 3].abs().sum() > 0


def test_decode_burst_blocked_greedy_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _pools(jcfg, tcfg)
    rng = np.random.default_rng(2)
    for slot, n in ((0, 7), (1, 13)):
        jc, tc, _ = _prefill_both(jcfg, jp, tcfg, tp, jc, tc, slot,
                                  rng.integers(1, 256, n), F32)
    token0 = np.array([26, 53], np.int32)
    pos0 = np.array([7, 13], np.int32)
    write = np.array([True, True])
    # 10 steps: slot 0 crosses into its second block, slot 1 its third.
    jc, jt = jax_engine.decode_burst_blocked(
        jcfg, jp, jc, jnp.asarray(TABLES), jnp.asarray(token0),
        jnp.asarray(pos0), jnp.asarray(write), jnp.zeros(2), jnp.ones(2),
        jax.random.PRNGKey(0), 10, False)
    tc, tt = decode_burst_blocked(tcfg, tp, tc, TABLES, token0, pos0, write,
                                  np.zeros(2), np.ones(2),
                                  torch.Generator().manual_seed(0), 10,
                                  False)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)


def test_bf16_blocked_prefill_and_burst_match_jax(tiny_bf16):
    jcfg, jp, tcfg, tp = tiny_bf16
    jc, tc = _pools(jcfg, tcfg)
    prompt = np.array([2, 7, 1, 8, 2, 8, 1, 8, 2, 8], np.int32)
    jc, tc, jl = _prefill_both(jcfg, jp, tcfg, tp, jc, tc, 0, prompt, BF16)
    assert tc["k"].dtype == torch.bfloat16
    first = int(np.argmax(np.asarray(jl)))
    token0 = np.array([first, 0], np.int32)
    pos0 = np.array([10, 0], np.int32)
    write = np.array([True, False])
    jc, jt = jax_engine.decode_burst_blocked(
        jcfg, jp, jc, jnp.asarray(TABLES), jnp.asarray(token0),
        jnp.asarray(pos0), jnp.asarray(write), jnp.zeros(2), jnp.ones(2),
        jax.random.PRNGKey(0), 2, False)
    tc, tt = decode_burst_blocked(tcfg, tp, tc, TABLES, token0, pos0, write,
                                  np.zeros(2), np.ones(2),
                                  torch.Generator().manual_seed(0), 2,
                                  False)
    assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **BF16)


def test_copy_blocks_matches_jax(tiny):
    jcfg, _, tcfg, _ = tiny
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, NB, 2, BS, 16)).astype(np.float32)
    v = rng.standard_normal((2, NB, 2, BS, 16)).astype(np.float32)
    src, dst = np.array([1, 4, 9], np.int32), np.array([7, 2, 0], np.int32)
    jc = jax_engine.copy_blocks({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                jnp.asarray(src), jnp.asarray(dst))
    tc = copy_blocks({"k": torch.from_numpy(k.copy()),
                      "v": torch.from_numpy(v.copy())}, src, dst)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    assert np.array_equal(tc["k"][:, 7].numpy(), k[:, 1])


# ---- the engine: the JAX package's tests/test_llm_blocked.py, case by case


def _gen(engine, prompts, max_tokens=12):
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens)
    reqs = [engine.submit(p, sp) for p in prompts]
    outs = []
    for r in reqs:
        assert r.done.wait(120), "generation timed out"
        assert r.error is None, r.error
        outs.append(list(r.out_tokens))
    return outs


def _eng(**kw):
    return LLMEngine(LLMConfig(model="tiny", **kw), device="cpu")


@pytest.fixture(scope="module")
def dense_engine():
    eng = _eng(max_num_seqs=4, max_seq_len=128)
    yield eng
    eng.shutdown()


PROMPTS = ["hello block world", "a different prompt!", "third one",
           "and a somewhat longer fourth prompt to chunk"]


def test_blocked_matches_dense_greedy(dense_engine):
    want = _gen(dense_engine, PROMPTS)
    eng = _eng(max_num_seqs=4, max_seq_len=128, kv_block_size=16,
               kv_num_blocks=4 * 128 // 16)
    try:
        assert _gen(eng, PROMPTS) == want
    finally:
        eng.shutdown()


def test_blocked_half_memory_double_slots(dense_engine):
    """The auto-sized pool holds max_slots x max_seq / 2 tokens: the bytes
    of a dense cache of half the slots, and it serves a full house."""
    slots = 8
    eng = _eng(max_num_seqs=slots, max_seq_len=128, kv_block_size=16)
    try:
        dense_bytes_half_slots = (dense_engine.cache["k"].nbytes
                                  + dense_engine.cache["v"].nbytes)
        assert eng.cache["k"].nbytes + eng.cache["v"].nbytes == \
            dense_bytes_half_slots
        outs = _gen(eng, [f"prompt number {i}" for i in range(slots)],
                    max_tokens=10)
        assert all(len(o) == 10 for o in outs)
        assert eng.preemptions == 0
        st = eng.stats()
        assert st["kv_blocks_total"] == st["kv_blocks_free"] == 32
        assert st["kv_block_size"] == 16
    finally:
        eng.shutdown()


def test_pool_exhaustion_preempts_and_resumes_exactly():
    """A pool too small for all three requests (5 blocks; each needs 4)
    preempts the newest (recompute); every request completes with exactly
    max_tokens tokens (none lost or repeated) equal to an uncontended run,
    a request preempted twice or more included. The JAX package holds its
    preempted request only to >= 12 of 16 agreeing tokens: its engine
    re-appends every emitted token to the already-grown prompt, so a
    request preempted twice sees its tokens twice; the port re-prefills
    the submitted prompt and the emitted tokens."""
    prompts = ["first request prompt", "second request here",
               "third request text"]
    big = _eng(max_num_seqs=3, max_seq_len=128, kv_block_size=16,
               kv_num_blocks=24)
    try:
        want = _gen(big, prompts, max_tokens=40)
    finally:
        big.shutdown()
    eng = _eng(max_num_seqs=3, max_seq_len=128, kv_block_size=16,
               kv_num_blocks=5)
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=40)
        reqs = [eng.submit(p, sp) for p in prompts]
        assert all(r.done.wait(120) and r.error is None for r in reqs)
        assert max(r.prefill_gen for r in reqs) >= 2, \
            "no request was preempted twice"
        assert eng.preemptions == sum(r.prefill_gen for r in reqs)
        assert [r.out_tokens for r in reqs] == want
        for r, p in zip(reqs, prompts):
            assert eng._result(r).prompt_ids == eng.tokenizer.encode(p)
    finally:
        eng.shutdown()


def test_pool_too_small_for_single_prompt_fails_cleanly():
    eng = _eng(max_num_seqs=2, max_seq_len=128, kv_block_size=16,
               kv_num_blocks=2)
    try:
        req = eng.submit("a prompt that is longer than two blocks of kv",
                         SamplingParams(temperature=0.0, max_tokens=4))
        assert req.done.wait(60)
        assert req.error and "pool exhausted" in req.error
        assert eng.stats()["kv_blocks_free"] == 2
    finally:
        eng.shutdown()


def test_blocked_prefix_adoption():
    shared = "You are a careful assistant. Answer briefly and stay calm. "
    eng = _eng(max_num_seqs=4, max_seq_len=256, kv_block_size=16)
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=8)
        r1 = eng.submit(shared + "Q1?", sp)
        assert r1.done.wait(120) and r1.error is None
        # Blocks return to the pool at finish: adoption needs a LIVE donor.
        long_req = eng.submit(shared + "Hold this slot open please",
                              SamplingParams(temperature=0.0,
                                             max_tokens=48))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not eng._prefix_live:
            time.sleep(0.002)
        assert eng._prefix_live, "donor never finished prefill"
        before = eng.prefix_hits
        r2 = eng.submit(shared + "Q2?", sp)
        assert r2.done.wait(120) and r2.error is None
        assert eng.prefix_hits > before, "no block-prefix adoption"
        assert long_req.done.wait(120)
        # The adopted request's tokens equal a cold run's.
        cold = _eng(max_num_seqs=4, max_seq_len=256, kv_block_size=16)
        try:
            assert _gen(cold, [shared + "Q2?"], 8)[0] == r2.out_tokens
        finally:
            cold.shutdown()
    finally:
        eng.shutdown()


def test_blocked_rejects_pd_and_spec():
    eng = _eng(max_num_seqs=2, max_seq_len=128, kv_block_size=16)
    try:
        with pytest.raises(ValueError, match="dense"):
            eng.prefill_only("prompt")
        with pytest.raises(ValueError, match="dense"):
            eng.submit_prefilled({})
    finally:
        eng.shutdown()
    with pytest.raises(ValueError, match="dense KV layout"):
        _eng(max_num_seqs=2, max_seq_len=128, kv_block_size=16,
             speculative_model="tiny")
    with pytest.raises(ValueError, match="power of two"):
        _eng(max_num_seqs=2, max_seq_len=128, kv_block_size=12)
    with pytest.raises(ValueError, match="multiple"):
        _eng(max_num_seqs=2, max_seq_len=120, kv_block_size=16)


@pytest.mark.parametrize("burst", [1, 8])
def test_blocked_engine_streams_match_jax_blocked_engine(burst):
    """The same params in both blocked engines (the auto-sized pool): the
    port's greedy streams equal JAX's."""
    jcfg = JaxLLMConfig(model="tiny").model_config()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    kw = dict(model="tiny", max_num_seqs=2, max_seq_len=96,
              kv_block_size=16, decode_burst=burst, prefill_chunk=16)
    prompts = ["hello", "prompt number 3", "x",
               list(np.random.default_rng(0).integers(1, 200, 40))]
    jeng = JaxLLMEngine(JaxLLMConfig(**kw), params=jp)
    teng = LLMEngine(LLMConfig(**kw), params=params_from_jax(jp, "cpu"),
                     device="cpu")
    try:
        for p in prompts:
            want = jeng.generate(p, SamplingParams(max_tokens=12))
            got = teng.generate(p, SamplingParams(max_tokens=12))
            assert got.token_ids == want.token_ids, p
            assert got.finish_reason == want.finish_reason
    finally:
        jeng.shutdown()
        teng.shutdown()
