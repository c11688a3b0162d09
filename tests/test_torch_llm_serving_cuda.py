"""The serving engine's blocked, speculative, P/D and tensor-parallel
paths on a CUDA card (tp 2 needs two).

Marked ``cuda``: they skip without a card. On one, they run each path with
``device="cuda"`` (f32 at tiny width, TF32 off, PyTorch's default), hold
its greedy tokens against the same engine on the CPU (rms_norm's plain
version there) and check that rms_norm's kernel launched. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_llm_serving_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models.llama import init_params
from ray_tpu_torch.ops import norms

PROMPTS = ["hello block world", "a different prompt!", "third one",
           [int(t) for t in np.random.default_rng(0).integers(1, 200, 40)]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: rms_norm's kernel runs there only")


def _tokens(eng, prompts, n=12):
    sp = SamplingParams(max_tokens=n, temperature=0.0)
    reqs = [eng.submit(p, sp) for p in prompts]
    assert all(r.done.wait(120) and r.error is None for r in reqs)
    return [r.out_tokens for r in reqs]


def _both(cfg, params, prompts, setup=None):
    """(cuda tokens, cpu tokens, kernel launches on the card's run)."""
    out = {}
    for dev in ("cuda", "cpu"):
        eng = LLMEngine(cfg, params=params, device=dev)
        try:
            if setup is not None:
                setup(eng)
            norms.rms_norm.launches = 0
            out[dev] = _tokens(eng, prompts), norms.rms_norm.launches
        finally:
            eng.shutdown()
    return out["cuda"][0], out["cpu"][0], out["cuda"][1]


@pytest.mark.cuda
def test_blocked_engine_on_card_with_preemption():
    _need_card()
    cfg = LLMConfig(model="tiny", max_num_seqs=4, max_seq_len=128,
                    kv_block_size=16, kv_num_blocks=9)
    params = init_params(cfg.model_config(), generator=0, device="cpu")
    cuda, cpu, launches = _both(cfg, params, PROMPTS)
    assert cuda == cpu
    assert launches > 0


@pytest.mark.cuda
def test_speculative_engine_on_card():
    _need_card()
    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=64,
                    speculative_model="tiny", speculative_tokens=4)
    params = init_params(cfg.model_config(), generator=0, device="cpu")
    plain = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=64)
    cuda, cpu, launches = _both(cfg, params, PROMPTS[:2])
    want, _, _ = _both(plain, params, PROMPTS[:2])
    assert cuda == cpu == want
    assert launches > 0


@pytest.mark.cuda
def test_pd_handoff_across_card_and_cpu():
    """Prefill on the card, decode on the CPU, and the other way round:
    the payload is device-independent; both give the single engine's
    tokens."""
    _need_card()
    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=96)
    params = init_params(cfg.model_config(), generator=0, device="cpu")
    prompt = PROMPTS[3]
    single = LLMEngine(cfg, params=params, device="cuda")
    want = _tokens(single, [prompt], 8)[0]
    single.shutdown()
    for pre_dev, dec_dev in (("cuda", "cpu"), ("cpu", "cuda")):
        pre = LLMEngine(cfg, params=params, device=pre_dev)
        dec = LLMEngine(cfg, params=params, device=dec_dev)
        try:
            norms.rms_norm.launches = 0
            payload = pre.prefill_only(prompt)
            assert payload["kv_k"].device.type == "cpu"
            req = dec.submit_prefilled(payload, SamplingParams(
                max_tokens=8, temperature=0.0))
            assert req.done.wait(120) and req.error is None
            assert req.out_tokens == want, (pre_dev, dec_dev)
            assert norms.rms_norm.launches > 0
        finally:
            pre.shutdown()
            dec.shutdown()


@pytest.mark.cuda
def test_tp_above_the_visible_cards_raises():
    """Before any follower starts, naming both counts (JAX's
    ``_shard_for_tp`` refuses as much devices as it lacks)."""
    _need_card()
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"tensor_parallel_size={n + 1} "
                                         f"but only {n} CUDA"):
        LLMEngine(LLMConfig(model="tiny", tensor_parallel_size=n + 1))


@pytest.mark.cuda
def test_tp2_on_two_cards_gives_one_cards_tokens():
    """f32 tiny over NCCL, rank r on cuda:r: one card's greedy tokens, K1
    launched, and no follower left after shutdown()."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    base = dict(model="tiny", max_num_seqs=4, max_seq_len=128)
    params = init_params(LLMConfig(**base).model_config(), generator=0,
                         device="cpu")
    one = LLMEngine(LLMConfig(**base), params=params)
    try:
        want = _tokens(one, PROMPTS)
    finally:
        one.shutdown()
    two = LLMEngine(LLMConfig(**base, tensor_parallel_size=2), params=params)
    try:
        norms.rms_norm.launches = 0
        assert _tokens(two, PROMPTS) == want
        assert norms.rms_norm.launches > 0
    finally:
        two.shutdown()
    assert not any(two._tp.alive())
