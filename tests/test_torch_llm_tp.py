"""ray_tpu_torch's tensor-parallel engine against the JAX engine's at the
same tp.

JAX's engine shards its params over a tp mesh axis of the 8 virtual CPU
devices (``tests/conftest.py``); the port runs its tp ranks as processes
over gloo (``llm/tp.py``) with ``device="cpu"``. One JAX initialization
of ``model="tiny"`` (vocab 512, f32) drives both sides through
``params_from_jax``. Held to JAX, token for token: greedy streams at tp 2
and 4, dense and with ``kv_block_size=16`` (tp 4 replicates tiny's 2 kv
heads), speculative decoding at tp 2, and the P/D hand-off from tp 2 to
tp 1 and back (the exported KV within 1e-6 of JAX's payload, relative
to its largest value). One
prefill's logits are held within rtol 1e-5, atol 1e-6 of JAX's (the
ranks' partial sums add in another order). A sampled wave at tp 2 gives
the port's tp 1 tokens on the same seed, and every rank draws the same
ones. A killed follower fails the request with an error; ``shutdown()``
leaves no live child; ``build_openai_app`` serves a tp engine over HTTP.
Engines start in parallel threads (each follower imports torch).
"""

import json
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import psutil
import pytest

import ray_tpu.llm.engine as jax_engine
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models.llama import init_params as jax_init_params

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import build_openai_app
from ray_tpu_torch.llm.tp import rank_blocks, rank_layout
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.train.checkpoint import save_pytree

BASE = dict(model="tiny", dtype="float32", max_num_seqs=4, max_seq_len=64)
RNG = np.random.default_rng(11)
PROMPTS = [[int(t) for t in RNG.integers(1, 250, n)] for n in (7, 21, 3)]
GREEDY = SamplingParams(max_tokens=8, temperature=0.0)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-6)
# The payload's KV against JAX's: max |difference| over max |value| (XLA's
# and PyTorch's f32 sums part by ~2e-6 on values up to ~4 at layer 2).
KV_TOL = 1e-6
# (tp, kv_block_size) of the greedy cases; tp 4 replicates tiny's kv heads.
CASES = [(2, 0), (4, 0), (2, 16), (4, 16)]


def _followers():
    """This process's live tp followers."""
    return [p for p in psutil.Process().children(recursive=True)
            if p.is_running() and p.status() != psutil.STATUS_ZOMBIE
            and "ray_tpu_torch.llm.tp" in " ".join(p.cmdline())]


def _no_followers(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _followers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _followers()


@pytest.fixture(scope="module")
def jp():
    cfg = JaxLLMConfig(**BASE).model_config()
    return jax_init_params(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def engines(jp):
    """The port's engines, started at once: (tp, block) -> engine, plus
    "spec" (tp 2 speculative) and "tp1". The dense tp engines' first call
    is a prefill whose logits the logits test reads (into slot 0, before
    any request: no cached prefix lives there)."""
    tp = params_from_jax(jp, "cpu")
    specs = {c: dict(tensor_parallel_size=c[0], kv_block_size=c[1])
             for c in CASES}
    specs["spec"] = dict(tensor_parallel_size=2, speculative_model="tiny",
                         speculative_tokens=4)
    specs["tp1"] = {}
    with ThreadPoolExecutor(3) as pool:  # a few imports of torch at once
        futs = {k: pool.submit(LLMEngine, LLMConfig(**BASE, **kw), tp,
                               "cpu") for k, kw in specs.items()}
        engs = {k: f.result() for k, f in futs.items()}
    try:
        toks = np.zeros((32,), np.int64)
        toks[:len(PROMPTS[1])] = PROMPTS[1]
        for n in (2, 4):
            eng = engs[(n, 0)]
            with eng._tp_lock:
                eng.logits0 = eng._call("prefill", toks, 0, len(PROMPTS[1]),
                                        0, None).numpy().copy()
        yield engs
    finally:
        for e in engs.values():
            e.shutdown()
    _no_followers()


@pytest.fixture(scope="module")
def jax_engines(jp):
    engs = {c: JaxLLMEngine(JaxLLMConfig(**BASE, tensor_parallel_size=c[0],
                                         kv_block_size=c[1]), params=jp)
            for c in CASES}
    engs["spec"] = JaxLLMEngine(JaxLLMConfig(
        **BASE, tensor_parallel_size=2, speculative_model="tiny",
        speculative_tokens=4), params=jp)
    yield engs
    for e in engs.values():
        e.shutdown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"tp{c[0]}-bs{c[1]}")
def test_greedy_streams_equal_jax_at_the_same_tp(case, engines, jax_engines):
    eng, jeng = engines[case], jax_engines[case]
    assert eng.stats()["tp"]["size"] == case[0]
    for prompt in PROMPTS:
        want = jeng.generate(prompt, GREEDY).token_ids
        assert eng.generate(prompt, GREEDY).token_ids == want, prompt
    assert eng.stats()["tp"]["followers_alive"] == case[0] - 1


@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_logits_within_tolerance_of_jax(tp, engines, jax_engines):
    jeng = jax_engines[(tp, 0)]
    cfg = jeng.model_cfg
    toks = np.zeros((32,), np.int32)
    toks[:len(PROMPTS[1])] = PROMPTS[1]
    _, want = jax_engine.prefill_chunk(
        cfg, jeng.params, jax_engine.init_kv_cache(cfg, 1, 64),
        jnp.asarray(toks), jnp.int32(0), jnp.int32(len(PROMPTS[1])),
        jnp.int32(0))
    got = engines[(tp, 0)].logits0
    assert got.shape == (cfg.vocab_size,)
    np.testing.assert_allclose(got, np.asarray(want), **LOGITS_TOL)


def test_rank_blocks_are_jax_shards_and_kv_heads_replicate(jp, jax_engines):
    """Every leaf but wk/wv is JAX's shard on the tp mesh, block for block;
    at tp 4 tiny's 2 kv heads sit on ranks {0, 1} and {2, 3}."""
    cfg = jax_engines[(4, 0)].model_cfg
    tp_params = params_from_jax(jp, "cpu")
    for n in (2, 4):
        sharded = jax_engines[(n, 0)].params
        blocks = dict(rank_blocks(cfg, tp_params, n))
        for path in (("embed_tokens",), ("lm_head",), ("layers", "wq"),
                     ("layers", "wo"), ("layers", "w_gate"),
                     ("layers", "w_down")):
            leaf = sharded
            for k in path:
                leaf = leaf[k]
            for r in range(n):
                shard = next(s for s in leaf.addressable_shards
                             if s.device == jax.devices()[r])
                np.testing.assert_array_equal(blocks[path][r].numpy(),
                                              np.asarray(shard.data))
    assert [rank_layout(cfg, 4, r).kv_heads for r in range(4)] == \
        [(0, 1), (0, 1), (1, 2), (1, 2)]
    with pytest.raises(ValueError, match="num_heads"):
        rank_layout(cfg, 8, 0)
    with pytest.raises(ValueError, match="divide"):
        LLMEngine(LLMConfig(**BASE, tensor_parallel_size=3), device="cpu")


def test_speculative_decoding_at_tp2_equals_jax(engines, jax_engines):
    eng, jeng = engines["spec"], jax_engines["spec"]
    eng.draft_params = params_from_jax(jeng.draft_params, "cpu")
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    for prompt in PROMPTS[:2]:
        assert eng.generate(prompt, sp).token_ids == \
            jeng.generate(prompt, sp).token_ids, prompt
    js, ts = jeng.stats(), eng.stats()
    for key in ("spec_ticks", "spec_proposed", "spec_accepted"):
        assert ts[key] == js[key], key
    assert ts["spec_ticks"] > 0


@pytest.mark.parametrize("direction", ["tp2_to_tp1", "tp1_to_tp2"])
def test_pd_handoff_across_tp_sizes_equals_jax(direction, engines,
                                               jax_engines):
    prompt = PROMPTS[1]
    jeng = jax_engines[(2, 0)]
    want_payload = jeng.prefill_only(prompt)
    want = jeng.generate(prompt, GREEDY).token_ids
    pre, dec = ((engines[(2, 0)], engines["tp1"])
                if direction == "tp2_to_tp1"
                else (engines["tp1"], engines[(2, 0)]))
    payload = pre.prefill_only(prompt)
    for name in ("kv_k", "kv_v"):
        got, ref = payload[name].numpy(), np.asarray(want_payload[name])
        assert got.shape == ref.shape
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= KV_TOL, (name, err)
    assert payload["first_token"] == want_payload["first_token"] == want[0]
    req = dec.submit_prefilled(payload, GREEDY)
    assert req.done.wait(60) and req.error is None, req.error
    assert req.out_tokens == want


def test_sampled_wave_at_tp2_equals_tp1_and_ranks_agree(jp):
    """Sequential requests (a deterministic draw order): temperature 0.8,
    top-p 0.9 at tp 2 gives tp 1's tokens on the same seed, and every rank
    sampled the same tokens (each samples the all-gathered logits)."""
    sp = SamplingParams(max_tokens=12, temperature=0.8, top_p=0.9)
    params = params_from_jax(jp, "cpu")
    one = LLMEngine(LLMConfig(**BASE, seed=5), params, device="cpu")
    two = LLMEngine(LLMConfig(**BASE, seed=5, tensor_parallel_size=2),
                    params, device="cpu")
    try:
        want = [one.generate(p, sp).token_ids for p in PROMPTS]
        two.tp_query("record")
        got = [two.generate(p, sp).token_ids for p in PROMPTS]
        drawn = two.tp_query("sampled")
        assert got == want
        assert len(drawn) == 2 and drawn[0] == drawn[1] and drawn[0]
    finally:
        one.shutdown()
        two.shutdown()


def test_killed_follower_fails_requests_and_shutdown_returns():
    eng = LLMEngine(LLMConfig(**{**BASE, "max_seq_len": 256},
                              tensor_parallel_size=2), device="cpu")
    try:
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=200))
        deadline = time.monotonic() + 30
        while len(req.out_tokens) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(req.out_tokens) >= 2
        eng._tp.procs[0].kill()
        assert req.done.wait(30)
        assert req.error and "tensor-parallel" in req.error
        late = eng.submit([4, 5], SamplingParams(max_tokens=4))
        assert late.done.wait(30) and late.error
        assert eng.error is not None
    finally:
        t0 = time.monotonic()
        eng.shutdown()
        assert time.monotonic() - t0 < 20
    assert not any(eng._tp.alive())


def test_shutdown_leaves_no_live_child(jp):
    eng = LLMEngine(LLMConfig(**BASE, tensor_parallel_size=4),
                    params_from_jax(jp, "cpu"), device="cpu")
    procs = list(eng._tp.procs)
    assert all(p.poll() is None for p in procs) and len(procs) == 3
    eng.shutdown()
    assert all(p.poll() is not None for p in procs)
    assert eng.stats()["tp"]["followers_alive"] == 0


def test_openai_app_serves_a_tp_engine_over_http(jp, engines, tmp_path):
    """A replica's tp engine answers as the direct engine does; stopping
    serve ends the replica's followers."""
    ckpt = str(tmp_path / "dcp")
    save_pytree(params_from_jax(jp, "cpu"), ckpt)
    prompt = "the quick brown fox"
    want = engines[(2, 0)].generate(
        prompt, SamplingParams(max_tokens=6)).text
    before = {p.pid for p in _followers()}
    ray_tpu_torch.init()
    try:
        serve.run(build_openai_app(
            LLMConfig(**BASE, tensor_parallel_size=2, checkpoint_path=ckpt),
            device="cpu"), route_prefix="/", http=True,
            _blocking_timeout=300)
        body = json.dumps({"prompt": prompt, "max_tokens": 6,
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{serve.http_port()}/v1/completions",
            data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        assert {p.pid for p in _followers()} - before
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert got["choices"][0]["text"] == want
    assert got["usage"]["completion_tokens"] == 6
    deadline = time.monotonic() + 20
    while {p.pid for p in _followers()} - before and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert not {p.pid for p in _followers()} - before


def test_tp_engine_uses_no_default_process_group(engines):
    import torch.distributed as dist

    assert engines[(2, 0)].stats()["tp"]["followers_alive"] == 1
    assert not dist.is_initialized()
