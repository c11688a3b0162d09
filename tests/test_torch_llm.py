"""ray_tpu_torch LLM engine against the JAX engine on the same params.

Params come from the JAX package's ``init_params`` and convert with
``params_from_jax``; inputs are numpy arrays with fixed seeds. Device
functions are held to f32 rtol=atol=1e-4 (sum order differs between XLA
and PyTorch's CPU kernels) and to 2e-2 in bf16 (the frameworks round at
the same points but may differ by a bf16 ulp per op), with the same greedy
token. Engines run with ``device="cpu"``, where rms_norm is its plain
version; greedy token streams must be identical.
"""

import subprocess
import sys
import threading
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
from ray_tpu.serve.prefix import block_hashes as jax_block_hashes

import ray_tpu_torch.llm.engine as eng_mod
from ray_tpu_torch.llm import LLMConfig, LLMEngine, LLMServer, SamplingParams
from ray_tpu_torch.llm.engine import (
    copy_prefix_kv,
    decode_burst,
    decode_step,
    init_kv_cache,
    prefill,
    prefill_chunk,
    sample_tokens,
    top_p_keep,
)
from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _pair(dtype="float32"):
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


def _caches(jcfg, tcfg, slots=2, max_seq=32):
    return (jax_engine.init_kv_cache(jcfg, slots, max_seq),
            init_kv_cache(tcfg, slots, max_seq, device="cpu"))


def test_prefill_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _caches(jcfg, tcfg)
    toks = np.zeros((16,), np.int32)
    toks[:5] = [5, 7, 11, 13, 17]
    jc, jl = jax_engine.prefill(jcfg, jp, jc, jnp.asarray(toks),
                                jnp.int32(5), jnp.int32(1))
    tc, tl = prefill(tcfg, tp, tc, toks, 5, 1)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)


def test_prefill_chunk_multi_chunk_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _caches(jcfg, tcfg)
    prompt = np.arange(1, 13, dtype=np.int32)  # 12 tokens, 3 chunks of 4
    for start in range(0, 12, 4):
        chunk = prompt[start:start + 4]
        jc, jl = jax_engine.prefill_chunk(jcfg, jp, jc, jnp.asarray(chunk),
                                          jnp.int32(start), jnp.int32(12),
                                          jnp.int32(1))
        tc, tl = prefill_chunk(tcfg, tp, tc, chunk, start, 12, 1)
        np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)


def test_prefill_chunk_rejects_a_window_past_the_cache():
    """JAX's dynamic_update_slice would clamp the start; the port raises."""
    cfg = LlamaConfig.tiny()
    tp = params_from_jax(jax_init_params(JaxLlamaConfig.tiny(),
                                         jax.random.PRNGKey(0)), "cpu")
    cache = init_kv_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        prefill_chunk(cfg, tp, cache, np.ones(8, np.int64), 12, 20, 0)


def test_decode_step_with_masked_slot_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _caches(jcfg, tcfg)
    toks = np.zeros((16,), np.int32)
    toks[:4] = [5, 7, 11, 13]
    jc, _ = jax_engine.prefill(jcfg, jp, jc, jnp.asarray(toks),
                               jnp.int32(4), jnp.int32(1))
    tc, _ = prefill(tcfg, tp, tc, toks, 4, 1)
    before = tc["k"][:, 0].clone()
    tokens = np.array([99, 17], np.int32)
    positions = np.array([0, 4], np.int32)
    write = np.array([False, True])
    jc, jl = jax_engine.decode_step(jcfg, jp, jc, jnp.asarray(tokens),
                                    jnp.asarray(positions),
                                    jnp.asarray(write))
    tc, tl = decode_step(tcfg, tp, tc, tokens, positions, write)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)
    assert torch.equal(tc["k"][:, 0], before)  # masked slot untouched
    assert tc["k"][:, 1, :, 4].abs().sum() > 0  # active slot written


def test_decode_burst_greedy_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _caches(jcfg, tcfg, slots=3)
    toks = np.zeros((16,), np.int32)
    toks[:6] = [3, 1, 4, 1, 5, 9]
    for slot in (0, 2):
        jc, _ = jax_engine.prefill(jcfg, jp, jc, jnp.asarray(toks),
                                   jnp.int32(6), jnp.int32(slot))
        tc, _ = prefill(tcfg, tp, tc, toks, 6, slot)
    token0 = np.array([26, 0, 53], np.int32)
    pos0 = np.array([6, 0, 6], np.int32)
    write = np.array([True, False, True])
    jc, jt = jax_engine.decode_burst(
        jcfg, jp, jc, jnp.asarray(token0), jnp.asarray(pos0),
        jnp.asarray(write), jnp.zeros(3), jnp.ones(3),
        jax.random.PRNGKey(0), 8, False)
    tc, tt = decode_burst(tcfg, tp, tc, token0, pos0, write, np.zeros(3),
                          np.ones(3), torch.Generator().manual_seed(0), 8,
                          False)
    np.testing.assert_array_equal(tt.numpy()[:, [0, 2]],
                                  np.asarray(jt)[:, [0, 2]])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)


def test_bf16_prefill_and_burst_match_jax(tiny_bf16):
    jcfg, jp, tcfg, tp = tiny_bf16
    jc, tc = _caches(jcfg, tcfg)
    toks = np.zeros((16,), np.int32)
    toks[:7] = [2, 7, 1, 8, 2, 8, 1]
    jc, jl = jax_engine.prefill(jcfg, jp, jc, jnp.asarray(toks),
                                jnp.int32(7), jnp.int32(0))
    tc, tl = prefill(tcfg, tp, tc, toks, 7, 0)
    assert tc["k"].dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16)
    first = int(np.argmax(np.asarray(jl)))
    assert int(tl.argmax()) == first
    token0 = np.array([first, 0], np.int32)
    pos0 = np.array([7, 0], np.int32)
    write = np.array([True, False])
    jc, jt = jax_engine.decode_burst(
        jcfg, jp, jc, jnp.asarray(token0), jnp.asarray(pos0),
        jnp.asarray(write), jnp.zeros(2), jnp.ones(2),
        jax.random.PRNGKey(0), 2, False)
    tc, tt = decode_burst(tcfg, tp, tc, token0, pos0, write, np.zeros(2),
                          np.ones(2), torch.Generator().manual_seed(0), 2,
                          False)
    assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])


def test_copy_prefix_kv_copies_the_whole_line(tiny):
    _, _, tcfg, _ = tiny
    cache = init_kv_cache(tcfg, 3, 8, device="cpu")
    cache["k"][:, 0].normal_(generator=torch.Generator().manual_seed(1))
    cache["v"][:, 0].fill_(2.0)
    copy_prefix_kv(tcfg, cache, 0, 2)
    assert torch.equal(cache["k"][:, 2], cache["k"][:, 0])
    assert torch.equal(cache["v"][:, 2], cache["v"][:, 0])
    assert cache["k"][:, 1].abs().sum() == 0


LOGITS = np.array([[0.0, 5.0, 1.0, 2.0], [10.0, 0.0, 0.0, 0.0]], np.float32)


@pytest.mark.parametrize("temp,top_p,top_k", [
    (0.0, 1.0, 0),    # greedy
    (5.0, 1e-6, 0),   # a tiny top_p keeps only the argmax
    (5.0, 1.0, 1),    # top_k=1 likewise
])
def test_sample_tokens_cases_match_jax(temp, top_p, top_k):
    j = jax_engine.sample_tokens(jnp.asarray(LOGITS), jnp.full((2,), temp),
                                 jnp.full((2,), top_p), top_k,
                                 jax.random.PRNGKey(0))
    t = sample_tokens(torch.from_numpy(LOGITS), torch.full((2,), temp),
                      torch.full((2,), top_p), top_k,
                      torch.Generator().manual_seed(0))
    assert list(np.asarray(j)) == [1, 0] == t.tolist()


def _jax_top_p_keep(scaled, top_ps):
    """The nucleus mask exactly as ray_tpu's sample_tokens builds it."""
    sorted_idx = jnp.argsort(-scaled, axis=-1)
    sorted_logits = jnp.take_along_axis(scaled, sorted_idx, axis=-1)
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep_sorted = cum - probs < top_ps[:, None]
    return jnp.zeros_like(keep_sorted).at[
        jnp.arange(scaled.shape[0])[:, None], sorted_idx].set(keep_sorted)


def test_top_p_sampling_keeps_the_jax_nucleus():
    """Stochastic sampling differs in its random bits (a torch.Generator is
    not a threefry key); it is held by property: the same keep mask, and
    every sampled token inside it."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    temps = np.array([0.7, 1.0, 1.5, 0.3], np.float32)
    top_ps = np.array([0.5, 0.9, 0.3, 0.95], np.float32)
    scaled = logits / temps[:, None]
    want = np.asarray(_jax_top_p_keep(jnp.asarray(scaled),
                                      jnp.asarray(top_ps)))
    got = top_p_keep(torch.from_numpy(scaled), torch.from_numpy(top_ps))
    np.testing.assert_array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(0)
    seen = np.zeros_like(want)
    for _ in range(200):
        tok = sample_tokens(torch.from_numpy(logits), torch.from_numpy(temps),
                            torch.from_numpy(top_ps), 0, gen).numpy()
        seen[np.arange(4), tok] = True
    assert not (seen & ~want).any()  # never outside the nucleus
    assert (seen.sum(1) > 1).any()   # and actually stochastic


# ---- the engine ----


def _cfg(**kw):
    base = dict(model="tiny", max_num_seqs=2, max_seq_len=64)
    base.update(kw)
    return LLMConfig(**base)


@pytest.fixture(scope="module")
def engine_params():
    """One tiny param tree (vocab 512, as LLMConfig(model="tiny") uses)
    for both engines."""
    jcfg = JaxLLMConfig(model="tiny").model_config()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("burst", [1, 8])
def test_engine_greedy_streams_match_jax_engine(engine_params, burst):
    jp, tp = engine_params
    prompts = ["hello", "prompt number 3", "x",
               list(np.random.default_rng(0).integers(1, 200, 40))]
    jeng = JaxLLMEngine(JaxLLMConfig(model="tiny", max_num_seqs=2,
                                     max_seq_len=96, decode_burst=burst,
                                     prefill_chunk=16), params=jp)
    teng = LLMEngine(_cfg(max_seq_len=96, decode_burst=burst,
                          prefill_chunk=16), params=tp, device="cpu")
    try:
        for p in prompts:
            want = jeng.generate(p, SamplingParams(max_tokens=12))
            got = teng.generate(p, SamplingParams(max_tokens=12))
            assert got.token_ids == want.token_ids, p
            assert got.finish_reason == want.finish_reason
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_engine_generate_deterministic():
    eng = LLMEngine(_cfg(), device="cpu")
    try:
        r1 = eng.generate("hello", SamplingParams(max_tokens=8))
        r2 = eng.generate("hello", SamplingParams(max_tokens=8))
        assert r1.token_ids == r2.token_ids
        assert 0 < len(r1.token_ids) <= 8
        assert r1.finish_reason in ("stop", "length")
    finally:
        eng.shutdown()


def test_engine_continuous_batching_concurrent():
    """More concurrent requests than slots: all complete, >1 slot was
    active at once, and each matches its solo regeneration."""
    eng = LLMEngine(_cfg(), device="cpu")
    try:
        peak = [0]
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                peak[0] = max(peak[0], eng.stats()["active"])
                stop.wait(0.001)  # a spinning watcher starves the scheduler

        w = threading.Thread(target=watch, daemon=True)
        w.start()
        results = [None] * 5

        def gen(i):
            results[i] = eng.generate(f"prompt number {i}",
                                      SamplingParams(max_tokens=12))

        threads = [threading.Thread(target=gen, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        w.join(timeout=10)
        assert all(r is not None for r in results)
        assert peak[0] >= 2
        solo = eng.generate("prompt number 3", SamplingParams(max_tokens=12))
        assert solo.token_ids == results[3].token_ids
    finally:
        eng.shutdown()


@pytest.mark.parametrize("blocked", [False, True])
def test_shutdown_ends_the_requests_it_holds(monkeypatch, blocked):
    """A request still decoding, and one still waiting for a slot, end
    with an error when the engine shuts down: their waiters (a replica's
    handler threads) wake at once instead of at their timeout. Each
    decode burst is slowed to 20 ms so the first is still running."""
    burst = LLMEngine._decode_burst

    def slow_burst(self, *args, **kw):
        time.sleep(0.02)
        return burst(self, *args, **kw)

    monkeypatch.setattr(LLMEngine, "_decode_burst", slow_burst)
    kw = dict(max_num_seqs=1, max_seq_len=256, decode_burst=1)
    if blocked:
        kw.update(kv_block_size=16, kv_num_blocks=32)
    eng = LLMEngine(_cfg(**kw), device="cpu")
    long = SamplingParams(max_tokens=240, temperature=0.0)
    running = eng.submit([1, 2, 3], long)
    waiting = eng.submit([4, 5, 6], long)
    deadline = time.monotonic() + 30
    while not running.out_tokens and time.monotonic() < deadline:
        time.sleep(0.005)
    assert running.out_tokens and not running.done.is_set()
    t0 = time.monotonic()
    eng.shutdown()
    for req in (running, waiting):
        assert req.done.wait(5), req.request_id
        assert req.error == "the engine was shut down"
        assert req.finish_reason == "error"
    assert time.monotonic() - t0 < 10


def test_engine_streaming():
    eng = LLMEngine(_cfg(), device="cpu")
    try:
        chunks = list(eng.generate_stream("stream me",
                                          SamplingParams(max_tokens=6)))
        assert 1 <= len(chunks) <= 6
    finally:
        eng.shutdown()


def test_engine_long_prompt_chunked():
    eng = LLMEngine(_cfg(max_seq_len=96, prefill_chunk=16), device="cpu")
    try:
        prompt = list(np.random.default_rng(0).integers(1, 200, 40))
        out = eng.generate(prompt, SamplingParams(max_tokens=4), timeout=120)
        assert len(out.token_ids) >= 1
        assert eng.stats()["prefill_chunks"] == 3  # 16 + 16 + 8
    finally:
        eng.shutdown()


def test_prefix_cache_exact_rehit_zero_copy():
    eng = LLMEngine(_cfg(), device="cpu")
    try:
        prompt = list(range(2, 34))  # 32 tokens
        r1 = eng.generate(prompt, SamplingParams(max_tokens=6))
        assert eng.prefix_hits == 0
        r2 = eng.generate(prompt, SamplingParams(max_tokens=6))
        assert eng.prefix_hits == 1
        assert eng.prefix_tokens_saved == len(prompt) - 1
        assert r1.token_ids == r2.token_ids
    finally:
        eng.shutdown()


def test_prefix_cache_shared_prefix_correctness():
    prefix = list(range(2, 34))
    prompt_b = prefix + [40, 41, 42, 43]
    cold = LLMEngine(_cfg(), device="cpu")
    try:
        expect = cold.generate(prompt_b, SamplingParams(max_tokens=6))
    finally:
        cold.shutdown()
    eng = LLMEngine(_cfg(), device="cpu")
    try:
        eng.generate(prefix, SamplingParams(max_tokens=4))
        got = eng.generate(prompt_b, SamplingParams(max_tokens=6))
        assert eng.prefix_hits == 1
        assert eng.prefix_tokens_saved == len(prefix)
        assert got.token_ids == expect.token_ids
    finally:
        eng.shutdown()


def test_prefix_cache_live_donor_copy():
    import time as _t

    prefix = list(range(2, 34))
    prompt_b = prefix + [45, 46]
    cold = LLMEngine(_cfg(max_num_seqs=3, max_seq_len=96), device="cpu")
    try:
        expect = cold.generate(prompt_b, SamplingParams(max_tokens=5))
    finally:
        cold.shutdown()
    eng = LLMEngine(_cfg(max_num_seqs=3, max_seq_len=96), device="cpu")
    try:
        long_req = eng.submit(prefix, SamplingParams(max_tokens=48))
        deadline = _t.time() + 60
        while not eng._prefix_live and _t.time() < deadline:
            _t.sleep(0.001)
        assert eng._prefix_live, "donor prefill never completed"
        got = eng.generate(prompt_b, SamplingParams(max_tokens=5))
        assert eng.prefix_hits >= 1
        assert got.token_ids == expect.token_ids
        assert long_req.done.wait(60)
    finally:
        eng.shutdown()


def test_prefix_block_hashes_match_jax():
    prompt = list(range(2, 70))
    eng = LLMEngine(_cfg(max_seq_len=96), device="cpu")
    try:
        eng.generate(prompt, SamplingParams(max_tokens=2))
        assert eng.prefix_block_hashes() == tuple(sorted(
            jax_block_hashes(prompt, 32)))
        assert eng.router_prefix_blocks() == {
            "blocks": list(eng.prefix_block_hashes()), "block": 32}
    finally:
        eng.shutdown()


class TestBurstDecoding:
    def test_burst_matches_single_step_greedy(self):
        e1 = LLMEngine(_cfg(decode_burst=1), device="cpu")
        e2 = LLMEngine(_cfg(decode_burst=4), device="cpu")
        try:
            for prompt, n in [("hello burst", 13), ("x", 3), ("abc", 8)]:
                r1 = e1.generate(prompt, SamplingParams(max_tokens=n))
                r2 = e2.generate(prompt, SamplingParams(max_tokens=n))
                assert r1.token_ids == r2.token_ids, (prompt, n)
                assert r2.finish_reason == r1.finish_reason
        finally:
            e1.shutdown()
            e2.shutdown()

    def test_burst_concurrent_isolated_and_chained(self):
        eng = LLMEngine(_cfg(max_num_seqs=4, decode_burst=8), device="cpu")
        try:
            results = [None] * 4

            def gen(i):
                results[i] = eng.generate(f"burst prompt {i}",
                                          SamplingParams(max_tokens=30))

            threads = [threading.Thread(target=gen, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert all(r is not None for r in results)
            solo = eng.generate("burst prompt 2",
                                SamplingParams(max_tokens=30))
            assert solo.token_ids == results[2].token_ids
            assert eng.stats()["chained_bursts"] >= 1
        finally:
            eng.shutdown()

    def test_pipeline_off_never_chains_and_gives_the_same_tokens(self):
        outs = {}
        for pipeline in (True, False):
            eng = LLMEngine(_cfg(decode_burst=4, decode_pipeline=pipeline),
                            device="cpu")
            try:
                outs[pipeline] = eng.generate(
                    "pipelined or not", SamplingParams(max_tokens=20)
                ).token_ids
                st = eng.stats()
                assert st["decode_bursts"] >= 2
                assert (st["chained_bursts"] >= 1) == pipeline
            finally:
                eng.shutdown()
        assert outs[True] == outs[False]

    def test_top_k_falls_back_to_single_step(self):
        eng = LLMEngine(_cfg(decode_burst=8), device="cpu")
        try:
            out = eng.generate("topk", SamplingParams(
                max_tokens=6, temperature=0.9, top_k=3))
            assert 1 <= len(out.token_ids) <= 6
            assert eng.stats()["decode_bursts"] == 0
        finally:
            eng.shutdown()


def test_engine_recovers_from_device_failure(monkeypatch):
    """A failed decode dispatch fails the in-flight requests, rebuilds the
    cache, and the engine keeps serving new traffic."""
    eng = LLMEngine(_cfg(), device="cpu")
    real_decode, real_burst = eng_mod.decode_step, eng_mod.decode_burst
    boom = {"n": 0}

    def flaky(real):
        def call(*a, **kw):
            if boom["n"] == 0:
                boom["n"] += 1
                raise RuntimeError("CUDA out of memory (simulated)")
            return real(*a, **kw)
        return call

    try:
        monkeypatch.setattr(eng_mod, "decode_step", flaky(real_decode))
        monkeypatch.setattr(eng_mod, "decode_burst", flaky(real_burst))
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=4))
        assert req.done.wait(60)
        assert req.error and "decode failed" in req.error
        assert req.finish_reason == "error"
        res = eng.generate([1, 2, 3], SamplingParams(max_tokens=3))
        assert len(res.token_ids) > 0 and boom["n"] == 1
    finally:
        eng.shutdown()


def test_llm_server_handle_surface():
    srv = LLMServer(_cfg(), device="cpu")
    try:
        out = srv.completions("hi there", max_tokens=5)
        assert out["object"] == "text_completion"
        assert isinstance(out["choices"][0]["text"], str)
        assert out["usage"]["completion_tokens"] > 0
        chat = srv.chat([{"role": "user", "content": "hello"}], max_tokens=4)
        assert chat["choices"][0]["message"]["role"] == "assistant"
        frames = list(srv.chat_stream([{"role": "user", "content": "yo"}],
                                      max_tokens=3))
        assert frames[-1] == "data: [DONE]\n\n"
        assert srv.router_meta()["block"] == 32
        srv.check_health()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("kw", [
    dict(placement_group_config={"bundles": [{"GPU": 1}]}),
    dict(engine_kwargs={"block_size": 16})])
def test_unported_options_raise(kw):
    """The refusals that stand (tensor parallelism serves: see
    tests/test_torch_llm_tp.py)."""
    match = "7\\(b\\)" if "placement_group_config" in kw else \
        "engine_kwargs"
    with pytest.raises(NotImplementedError, match=match):
        LLMEngine(_cfg(**kw), device="cpu")


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from ray_tpu_torch.models.llama import init_params

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(LlamaConfig.tiny(), 1, 8)


def test_import_loads_neither_jax_nor_ray_tpu():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.llm, "
            "ray_tpu_torch.llm.pd, ray_tpu_torch.llm.hf, "
            "ray_tpu_torch.llm.tp, "
            "ray_tpu_torch.ops.norms, ray_tpu_torch.ops.rope\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ray_tpu' or "
            "m.startswith('ray_tpu.'))\n"
            "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
