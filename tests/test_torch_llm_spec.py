"""ray_tpu_torch's speculative decoding against the JAX engine's.

One JAX initialization drives both sides (``params_from_jax``). The device
functions ``draft_propose`` and ``spec_verify_step`` are held to JAX's on
the same cache and inputs (f32 logits and cache within rtol = atol =
1e-5, the same proposals). Then the JAX package's TestSpeculativeDecoding
(tests/test_llm.py), case by case, on the port's engine
(``device="cpu"``), and the port's speculative engine against JAX's with
the same target and draft params: the same tokens and the same
acceptance counts.
"""

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

import ray_tpu_torch.llm.engine as eng_mod
from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.engine import (
    decode_step,
    draft_propose,
    init_kv_cache,
    prefill,
    spec_verify_step,
)
from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxLlamaConfig.tiny()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, LlamaConfig.tiny(), params_from_jax(jp, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


def _prefilled(jcfg, jp, tcfg, tp, prompts):
    jc = jax_engine.init_kv_cache(jcfg, len(prompts), 32)
    tc = init_kv_cache(tcfg, len(prompts), 32, device="cpu")
    for slot, p in enumerate(prompts):
        toks = np.zeros((16,), np.int32)
        toks[:len(p)] = p
        jc, _ = jax_engine.prefill(jcfg, jp, jc, jnp.asarray(toks),
                                   jnp.int32(len(p)), jnp.int32(slot))
        tc, _ = prefill(tcfg, tp, tc, toks, len(p), slot)
    return jc, tc


def test_draft_propose_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _prefilled(jcfg, jp, tcfg, tp, [[5, 7, 11, 13], [3, 1, 4]])
    token0 = np.array([17, 9], np.int32)
    pos0 = np.array([4, 3], np.int32)
    write = np.array([True, True])
    before = tc["k"].clone()
    jc, jprop = jax_engine.draft_propose(jcfg, jp, jc, jnp.asarray(token0),
                                         jnp.asarray(pos0), 3,
                                         jnp.asarray(write))
    tc, tprop = draft_propose(tcfg, tp, tc, token0, pos0, 3, write)
    assert tprop.shape == (2, 3)
    np.testing.assert_array_equal(tprop.numpy(), np.asarray(jprop))
    for name in ("k", "v"):  # k + 1 = 4 rows written per slot
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)
    # Rows 4..7 of slot 0 rewritten (the prefill's padding wrote them
    # first), nothing from row 8 on.
    assert not torch.equal(tc["k"][:, 0, :, 7], before[:, 0, :, 7])
    assert torch.equal(tc["k"][:, 0, :, 8:], before[:, 0, :, 8:])


def test_spec_verify_step_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _prefilled(jcfg, jp, tcfg, tp, [[5, 7, 11, 13], [3, 1, 4]])
    tokens = np.array([[17, 19, 23, 29], [0, 0, 0, 0]], np.int32)
    pos0 = np.array([4, 0], np.int32)
    write = np.array([True, False])
    before = tc["k"][:, 1].clone()
    jc, jl = jax_engine.spec_verify_step(jcfg, jp, jc, jnp.asarray(tokens),
                                         jnp.asarray(pos0),
                                         jnp.asarray(write))
    tc, tl = spec_verify_step(tcfg, tp, tc, tokens, pos0, write)
    np.testing.assert_allclose(_np(tl[0]), _np(jl[0]), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32)
    assert torch.equal(tc["k"][:, 1], before)


def test_spec_verify_matches_sequential_decode(tiny):
    """spec_verify_step over K tokens gives the logits and cache of K
    sequential decode_step calls."""
    _, _, cfg, params = tiny
    prompt = np.array([5, 7, 11, 13], np.int64)
    toks = np.array([17, 19, 23], np.int64)
    c1 = init_kv_cache(cfg, 2, 32, device="cpu")
    c1, _ = prefill(cfg, params, c1, prompt, len(prompt), 0)
    c2 = {n: t.clone() for n, t in c1.items()}
    seq = []
    for j, t in enumerate(toks):
        c1, lg = decode_step(cfg, params, c1, np.array([t, 0]),
                             np.array([len(prompt) + j, 0]),
                             np.array([True, False]))
        seq.append(lg[0])
    c2, logits = spec_verify_step(cfg, params, c2,
                                  np.stack([toks, np.zeros_like(toks)]),
                                  np.array([len(prompt), 0]),
                                  np.array([True, False]))
    for j in range(3):
        torch.testing.assert_close(logits[0, j], seq[j], rtol=2e-4,
                                   atol=2e-4)
    torch.testing.assert_close(c1["k"], c2["k"], rtol=1e-5, atol=1e-5)


# ---- the engine: the JAX package's TestSpeculativeDecoding, case by case


def _cfg(**kw):
    base = dict(model="tiny", max_num_seqs=2, max_seq_len=64)
    base.update(kw)
    return LLMConfig(**base)


@pytest.fixture(scope="module")
def target():
    """The tiny engine geometry's params (vocab 512), from JAX's seed 3,
    as JAX's spec tests draw them."""
    jp = jax_init_params(JaxLLMConfig(model="tiny").model_config(),
                         jax.random.PRNGKey(3))
    return jp, params_from_jax(jp, device="cpu")


def test_spec_output_identical_perfect_draft(target):
    """Draft == target: the output equals plain greedy and acceptance is
    near total."""
    _, tp = target
    base = LLMEngine(_cfg(), params=tp, device="cpu")
    spec = LLMEngine(_cfg(speculative_model="tiny", speculative_tokens=3),
                     params=tp, device="cpu")
    spec.draft_params = tp  # perfect draft
    try:
        sp = SamplingParams(max_tokens=24, temperature=0.0)
        assert spec.generate("hello tpu", sp).token_ids == \
            base.generate("hello tpu", sp).token_ids
        st = spec.stats()
        assert st["spec_ticks"] > 0
        assert st["spec_acceptance"] > 0.9, st
    finally:
        base.shutdown()
        spec.shutdown()


def test_spec_output_identical_bad_draft(target):
    """A different (seeded random) draft still gives exactly the plain
    greedy output: speculation changes speed, never results."""
    _, tp = target
    base = LLMEngine(_cfg(), params=tp, device="cpu")
    spec = LLMEngine(_cfg(speculative_model="tiny", speculative_tokens=4),
                     params=tp, device="cpu")  # draft: seed + 7
    try:
        sp = SamplingParams(max_tokens=20, temperature=0.0)
        for prompt in ("abc", "speculate this"):
            assert spec.generate(prompt, sp).token_ids == \
                base.generate(prompt, sp).token_ids, prompt
        assert spec.stats()["spec_ticks"] > 0
    finally:
        base.shutdown()
        spec.shutdown()


def test_spec_disabled_after_repeated_catchup_failure(monkeypatch):
    """A request whose draft catch-up keeps failing is excluded from
    speculation after 3 failures and completes by plain decode; the
    engine keeps speculating for later requests."""
    eng = LLMEngine(_cfg(speculative_model="tiny", speculative_tokens=3),
                    device="cpu")
    orig = eng_mod.prefill_chunk
    victim = None

    def failing(cfg, params, cache, toks, start, end, slot):
        if cfg is eng.draft_cfg and eng._slots.get(int(slot)) is victim:
            raise RuntimeError("injected draft prefill failure")
        return orig(cfg, params, cache, toks, start, end, slot)

    monkeypatch.setattr(eng_mod, "prefill_chunk", failing)
    try:
        victim = eng.submit("doomed draft", SamplingParams(
            max_tokens=30, temperature=0.0))
        assert victim.done.wait(60) and victim.error is None
        assert victim.spec_disabled and victim.draft_fail_count >= 3
        assert len(victim.out_tokens) == 30
        healthy = eng.submit("fine", SamplingParams(max_tokens=10,
                                                    temperature=0.0))
        assert healthy.done.wait(60) and healthy.error is None
        assert not healthy.spec_disabled
        assert eng.stats()["spec_ticks"] > 0
    finally:
        eng.shutdown()


def test_spec_tick_abandoned_after_plain_decode_device_failure(monkeypatch):
    """Mixed tick: the plain half fails on the device, which fails every
    request and rebuilds both caches; the speculative half must not be
    dispatched after that."""
    eng = LLMEngine(_cfg(speculative_model="tiny", speculative_tokens=3),
                    device="cpu")
    plain = spec = None
    failed, after = [], []

    def both_ready():
        return (plain is not None and spec is not None and plain.out_tokens
                and spec.out_tokens and not plain.done.is_set()
                and not spec.done.is_set())

    def failing(real):
        def call(*a, **kw):
            if both_ready():
                failed.append(True)
                raise RuntimeError("injected device failure")
            return real(*a, **kw)
        return call

    def recording(*a, **kw):
        if failed:
            after.append(True)
        return orig_propose(*a, **kw)

    orig_propose = eng_mod.draft_propose
    monkeypatch.setattr(eng_mod, "decode_step",
                        failing(eng_mod.decode_step))
    monkeypatch.setattr(eng_mod, "decode_burst",
                        failing(eng_mod.decode_burst))
    monkeypatch.setattr(eng_mod, "draft_propose", recording)
    try:
        plain = eng.submit("plain one", SamplingParams(max_tokens=32,
                                                       temperature=0.0))
        plain.spec_disabled = True  # rides the plain half of the tick
        spec = eng.submit("spec one", SamplingParams(max_tokens=32,
                                                     temperature=0.0))
        assert plain.done.wait(60) and spec.done.wait(60)
        assert failed, "the mixed tick never ran"
        assert plain.error is not None and spec.error is not None
        assert not after, "speculative half dispatched after recovery"
        # The engine serves new traffic on the rebuilt caches.
        monkeypatch.setattr(eng_mod, "decode_step", decode_step)
        res = eng.generate("again", SamplingParams(max_tokens=5))
        assert len(res.token_ids) > 0
    finally:
        eng.shutdown()


def test_spec_mixed_batch_stochastic_falls_back():
    """Sampled requests ride the plain decode while greedy ones speculate;
    both finish in one engine."""
    eng = LLMEngine(_cfg(speculative_model="tiny", speculative_tokens=3),
                    device="cpu")
    try:
        greedy = eng.submit("aaa", SamplingParams(max_tokens=12,
                                                  temperature=0.0))
        warm = eng.submit("bbb", SamplingParams(max_tokens=12,
                                                temperature=0.8))
        assert greedy.done.wait(60) and warm.done.wait(60)
        assert greedy.error is None and warm.error is None
        assert len(greedy.out_tokens) > 0 and len(warm.out_tokens) > 0
        assert eng.stats()["spec_ticks"] > 0
    finally:
        eng.shutdown()


def test_spec_draft_vocab_must_match():
    with pytest.raises(ValueError, match="vocab"):
        LLMEngine(_cfg(speculative_model=LlamaConfig.tiny()), device="cpu")


def test_spec_engine_matches_jax_spec_engine(target):
    """The same target params and the same draft params (JAX's seed + 7
    draft, converted) in both engines: equal tokens and equal speculation
    counts, request by request."""
    jp, tp = target
    kw = dict(model="tiny", max_num_seqs=2, max_seq_len=64,
              speculative_model="tiny", speculative_tokens=4)
    jeng = JaxLLMEngine(JaxLLMConfig(**kw), params=jp)
    teng = LLMEngine(LLMConfig(**kw), params=tp, device="cpu")
    teng.draft_params = params_from_jax(jeng.draft_params, "cpu")
    try:
        for prompt in ("abc", "speculate this", "x"):
            sp = SamplingParams(max_tokens=20, temperature=0.0)
            want = jeng.generate(prompt, sp)
            got = teng.generate(prompt, sp)
            assert got.token_ids == want.token_ids, prompt
            js, ts = jeng.stats(), teng.stats()
            for key in ("spec_ticks", "spec_proposed", "spec_accepted"):
                assert ts[key] == js[key], (prompt, key, ts, js)
    finally:
        jeng.shutdown()
        teng.shutdown()
