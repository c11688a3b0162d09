"""ray_tpu_torch's prefill/decode KV hand-off against the JAX engine's.

A JAX ``prefill_only`` payload (numpy, bfloat16 included) imported by the
port's ``submit_prefilled`` continues exactly as JAX's own decode engine
does; the port's payloads give the port's single-engine greedy tokens;
then the JAX package's tests/test_pd_kv_handoff.py round trips on the
port (odd prompt lengths, a reused slot, prefix retirement) and llm/pd.py's
servers under the "inline" transport. "store" needs the object plane and
raises. Engines run with ``device="cpu"``.
"""

import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models.llama import init_params as jax_init_params

from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.pd import (
    DecodeServer,
    PrefillServer,
    export_kv_payload,
    kv_metrics,
    resolve_kv_payload,
)
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.serve.prefix import block_hashes


def _greedy(n):
    return SamplingParams(max_tokens=n, temperature=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_payload_continues_in_the_port_as_in_jax(dtype):
    """One JAX prefill: JAX's decode engine and the port's import the same
    payload. The port's cache line holds the payload's values bit for
    bit; f32 continues with JAX's tokens; bf16 (frameworks may round a
    product apart) with JAX's imported token and first decoded one."""
    kw = dict(model="tiny", max_num_seqs=2, max_seq_len=96, dtype=dtype)
    jcfg = JaxLLMConfig(**kw).model_config()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(5))
    prompt = [int(t) for t in np.random.default_rng(6).integers(1, 200, 29)]
    pre, dec = JaxLLMEngine(JaxLLMConfig(**kw), params=jp), \
        JaxLLMEngine(JaxLLMConfig(**kw), params=jp)
    teng = LLMEngine(LLMConfig(**kw), params=params_from_jax(jp, "cpu"),
                     device="cpu")
    try:
        payload = pre.prefill_only(prompt)
        assert payload["kv_k"].dtype.name == dtype
        jreq = dec.submit_prefilled(payload, _greedy(8))
        treq = teng.submit_prefilled(payload, _greedy(8))
        assert jreq.done.wait(120) and treq.done.wait(120)
        assert jreq.error is None and treq.error is None, treq.error
        slot = treq.last_slot
        for name in ("k", "v"):
            want = np.asarray(payload[f"kv_{name}"]).astype(np.float32)
            got = teng.cache[name][:, slot, :, :len(prompt)].float().numpy()
            np.testing.assert_array_equal(got, want)
        assert treq.kv_imported and treq.out_tokens[0] == \
            payload["first_token"]
        n = 8 if dtype == "float32" else 2
        assert treq.out_tokens[:n] == jreq.out_tokens[:n]
    finally:
        for e in (pre, dec, teng):
            e.shutdown()


def test_port_payload_gives_single_engine_greedy():
    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=96, seed=3)
    prompt = [int(t) for t in np.random.default_rng(2).integers(1, 200, 15)]
    single = LLMEngine(cfg, device="cpu")
    want = single.generate(prompt, _greedy(6)).token_ids
    single.shutdown()
    pre, dec = LLMEngine(cfg, device="cpu"), LLMEngine(cfg, device="cpu")
    try:
        payload = pre.prefill_only(prompt)
        assert isinstance(payload["kv_k"], torch.Tensor)
        assert payload["kv_k"].shape == (2, 2, 15, 16)
        assert payload["finish_reason"] == "length"
        req = dec.submit_prefilled(payload, _greedy(6))
        assert req.done.wait(120) and not req.error
        assert req.out_tokens == want
        assert dec._result(req).prompt_ids == prompt
    finally:
        pre.shutdown()
        dec.shutdown()


@pytest.mark.parametrize("prompt_len", [13, 33, 47])
def test_prefill_chunk_kv_roundtrip_odd_lengths(prompt_len):
    """Export -> import at lengths that leave partial last chunks (13 <
    bucket_min, 33 crosses a 16-bucket, 47 leaves a 15-token tail)
    against the single-engine greedy tokens."""
    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=128, seed=7,
                    prefill_bucket_min=16, prefill_chunk=16)
    prompt = [int(t) for t in
              np.random.default_rng(prompt_len).integers(1, 200, prompt_len)]
    single = LLMEngine(cfg, device="cpu")
    want = single.generate(prompt, _greedy(6)).token_ids
    single.shutdown()
    pre, dec = LLMEngine(cfg, device="cpu"), LLMEngine(cfg, device="cpu")
    try:
        payload = pre.prefill_only(prompt)
        assert payload["kv_k"].shape[2] == prompt_len
        assert payload["first_token"] == want[0]
        req = dec.submit_prefilled(payload, _greedy(5))
        assert req.done.wait(120) and not req.error
        assert req.out_tokens == want[:len(req.out_tokens)]
    finally:
        pre.shutdown()
        dec.shutdown()


def test_kv_import_into_reused_slot_after_eviction():
    """A 1-slot decode engine first runs a LONG sequence, then imports a
    SHORTER prefill into the same slot: the old tenant's tail must stay
    masked."""
    cfg = LLMConfig(model="tiny", max_num_seqs=1, max_seq_len=96, seed=11)
    long_prompt = [int(t) for t in
                   np.random.default_rng(3).integers(1, 200, 40)]
    short_prompt = [int(t) for t in
                    np.random.default_rng(4).integers(1, 200, 9)]
    single = LLMEngine(cfg, device="cpu")
    want = single.generate(short_prompt, _greedy(6)).token_ids
    single.shutdown()
    pre, dec = LLMEngine(cfg, device="cpu"), LLMEngine(cfg, device="cpu")
    try:
        dec.generate(long_prompt, _greedy(8))
        req = dec.submit_prefilled(pre.prefill_only(short_prompt),
                                   _greedy(5))
        assert req.done.wait(120) and not req.error
        assert req.out_tokens == want[:len(req.out_tokens)], \
            "stale KV from the evicted tenant leaked into the import"
    finally:
        pre.shutdown()
        dec.shutdown()


def test_prefill_only_retires_prefix_for_publication():
    """prefill_only's exported line retires as a cached prefix: the engine
    publishes its block hashes, and a shared-prefix follow-up adopts it."""
    eng = LLMEngine(LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=96,
                              prefix_block_tokens=8), device="cpu")
    try:
        prompt = list(range(1, 34))  # 33 tokens -> 4 full blocks of 8
        eng.prefill_only(prompt)
        want = set(block_hashes(prompt, 8))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                not want <= set(eng.prefix_block_hashes()):
            time.sleep(0.01)  # the release runs on the next tick
        assert want <= set(eng.prefix_block_hashes()), \
            "prefill_only slot was not retired for publication"
        saved = eng.prefix_tokens_saved
        out = eng.prefill_only(prompt + [77, 78, 79])
        assert out["kv_k"].shape[2] == len(prompt) + 3
        assert eng.prefix_hits >= 1 and eng.prefix_tokens_saved > saved
    finally:
        eng.shutdown()


def test_prefill_only_export_fails_after_device_recovery(monkeypatch):
    """A device failure that rebuilds the cache while a prefill is held
    for export turns the export into an error, not zeros."""
    import ray_tpu_torch.llm.engine as eng_mod

    eng = LLMEngine(LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=96),
                    device="cpu")
    real = eng_mod.prefill_chunk

    def boom(*a, **kw):
        raise RuntimeError("CUDA error (simulated)")

    try:
        monkeypatch.setattr(eng_mod, "prefill_chunk", boom)
        with pytest.raises(RuntimeError, match="prefill failed"):
            eng.prefill_only([1, 2, 3, 4])
        monkeypatch.setattr(eng_mod, "prefill_chunk", real)
        assert eng.prefill_only([1, 2, 3, 4])["kv_k"].shape[2] == 4
    finally:
        eng.shutdown()


def test_prefill_and_decode_servers_inline():
    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=96, seed=1,
                    pd_transfer_mode="inline")
    prompt = [int(t) for t in np.random.default_rng(8).integers(1, 200, 21)]
    single = LLMEngine(cfg, device="cpu")
    want = single.generate(prompt, _greedy(6))
    single.shutdown()
    pre = PrefillServer(cfg, device="cpu")
    dec = DecodeServer(cfg, device="cpu")
    try:
        b0 = kv_metrics()["bytes"].value({"path": "inline"})
        payload = pre.prefill(prompt, {"max_tokens": 6})
        nbytes = 2 * payload["kv_k"].numel() * 4
        assert kv_metrics()["bytes"].value({"path": "inline"}) - b0 == nbytes
        out = dec.decode(payload, {"max_tokens": 6})
        assert out["token_ids"] == want.token_ids
        assert out["text"] == want.text
        frames = list(dec.decode_stream(pre.prefill(prompt,
                                                    {"max_tokens": 6}),
                                        {"max_tokens": 6}))
        assert frames[-1] == ("__finish__", want.finish_reason)
        # One frame a token emitted (a stop token too).
        assert len(frames) - 1 == len(want.token_ids) + (
            want.finish_reason == "stop")
        assert pre.router_prefix_blocks()["block"] == 32
        pre.check_health()
        dec.check_health()
    finally:
        pre.shutdown()
        dec.shutdown()


def test_store_transport_raises():
    with pytest.raises(NotImplementedError, match="object plane"):
        PrefillServer(LLMConfig(model="tiny"), device="cpu")  # "store"
    payload = {"kv_k": np.zeros((1,)), "kv_v": np.zeros((1,))}
    with pytest.raises(NotImplementedError, match="object plane"):
        export_kv_payload(payload, "store")
    with pytest.raises(NotImplementedError, match="object plane"):
        resolve_kv_payload({"kv_ref_k": 1, "kv_ref_v": 2})
    with pytest.raises(ValueError, match="unknown pd_transfer_mode"):
        export_kv_payload(payload, "shm")
    assert resolve_kv_payload(payload) is payload


def test_bad_payload_fails_the_request_only():
    eng = LLMEngine(LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=96),
                    device="cpu")
    try:
        bad = {"prompt_ids": [1, 2], "kv_k": np.zeros((2, 2, 2, 8), "f4"),
               "kv_v": np.zeros((2, 2, 2, 8), "f4"), "first_token": 5}
        req = eng.submit_prefilled(bad)
        assert req.done.wait(60) and "KV import failed" in req.error
        assert len(eng.generate([1, 2, 3], _greedy(3)).token_ids) > 0
    finally:
        eng.shutdown()
