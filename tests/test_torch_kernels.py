"""ray_tpu_torch's CUDA kernels and their wrappers, without JAX.

The card machine has no JAX, and tests/conftest.py imports it, so this
file imports only torch and the port. On a card, from the repo root:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q

Tests marked ``cuda`` skip without a card (the kernels have no CPU mode);
the others check the wrappers' contracts on the CPU. Tolerances: bf16
within one bf16 ulp of the plain version (rtol 8e-3, atol 1e-2), f32
1e-5 (the kernel sums squares in another order); the f32 engines' greedy
streams (tiny width and 1B width) must be equal on the card and on the
CPU. Flash kernels against their plain twins (bf16): out, dq, dk, dv
within 1e-2 of the largest value (one bf16 ulp where sums in another
order round a value apart; dq's f32 atomics add in no fixed order), lse
within 2e-3 (f32 sums of the same bf16 p in another order).
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as att
from ray_tpu_torch.ops import norms

BF16_TOL = dict(rtol=8e-3, atol=1e-2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def test_rms_norm_rejects_what_the_kernel_does_not_take():
    x = torch.ones((4, 60))
    with pytest.raises(ValueError, match="multiple of 8"):
        norms.rms_norm(x, torch.ones(60))
    with pytest.raises(ValueError, match="weight shape"):
        norms.rms_norm(torch.ones((4, 64)), torch.ones(32))
    with pytest.raises(TypeError):
        norms.rms_norm(torch.ones((4, 64), dtype=torch.float64),
                       torch.ones(64, dtype=torch.float64))


def test_rms_norm_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    raises rather than computing the plain version."""
    x = torch.empty((8, 64), device="meta")
    w = torch.empty((64,), device="meta")
    before = norms.rms_norm.launches
    with pytest.raises(ValueError, match="CUDA"):
        norms.rms_norm(x, w)
    assert norms.rms_norm.launches == before


def test_rms_norm_cpu_path_counts_no_launch():
    before = norms.rms_norm.launches
    norms.rms_norm(torch.ones((3, 16)), torch.ones(16))
    assert norms.rms_norm.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rms_norm kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(1, 64), (8, 2048), (33, 4096),
                                    (4099, 2048)])
def test_rms_norm_kernel_matches_plain_on_card(cuda_device, rows, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = (torch.randn((rows, d), generator=g, device=cuda_device) * 3).to(dtype)
    w = torch.randn((d,), generator=g, device=cuda_device).to(dtype)
    before = norms.rms_norm.launches
    got = norms.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert norms.rms_norm.launches == before + 1
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got, norms.rms_norm_reference(x, w, 1e-5),
                               **tol)


@pytest.mark.cuda
def test_rms_norm_kernel_every_small_row_count_and_width_on_card(
        cuda_device):
    """Both kernel variants (warp per row, CTA per row) at every row count
    1..40 and at widths around the switch (32 vectors of 16 bytes)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for d in (8, 64, 128, 256, 264, 512):
        for rows in range(1, 41):
            x = torch.randn((rows, d), generator=g, device=cuda_device)
            w = torch.randn((d,), generator=g, device=cuda_device)
            torch.testing.assert_close(
                norms.rms_norm(x, w), norms.rms_norm_reference(x, w),
                **F32_TOL)


@pytest.mark.cuda
def test_rms_norm_kernel_takes_strided_and_mixed_inputs_on_card(
        cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    base = torch.randn((16, 4096), generator=g, device=cuda_device)
    x = base[:, 1:2049].to(torch.bfloat16)  # a copy: contiguous, aligned
    xs = base.to(torch.bfloat16)[:, 1:2049]  # a strided, misaligned view
    w = torch.randn((2048,), generator=g, device=cuda_device)  # f32 weight
    torch.testing.assert_close(norms.rms_norm(xs, w), norms.rms_norm(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(norms.rms_norm(x, w),
                               norms.rms_norm_reference(x, w), **BF16_TOL)
    x3 = x.view(4, 4, 2048)
    assert norms.rms_norm(x3, w).shape == (4, 4, 2048)


@pytest.mark.cuda
def test_tiny_engine_streams_equal_on_card_and_cpu(cuda_device):
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import init_params

    cfg = LLMConfig(model="tiny", max_num_seqs=2, max_seq_len=96,
                    decode_burst=8, prefill_chunk=16)
    params = init_params(cfg.model_config(), generator=3, device="cpu")
    prompts = ["hello", "a prompt longer than one chunk of 16", "hello"]
    streams = {}
    for dev in (cuda_device, "cpu"):
        eng = LLMEngine(cfg, params=params, device=dev)
        try:
            streams[str(dev)] = [
                eng.generate(p, SamplingParams(max_tokens=16)).token_ids
                for p in prompts]
        finally:
            eng.shutdown()
    assert streams["cuda"] == streams["cpu"]


@pytest.mark.cuda
def test_wide_engine_streams_equal_on_card_and_cpu(cuda_device):
    """At d=2048 the engine's norms run the CTA-per-row kernel variant (the
    one the 1B main path launches), not the warp-per-row one of tiny."""
    from dataclasses import replace

    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    model = replace(LlamaConfig.llama3_1b(), num_layers=1, vocab_size=512,
                    max_seq_len=96, dtype="float32")
    cfg = LLMConfig(model=model, max_num_seqs=2, max_seq_len=96,
                    decode_burst=8, prefill_chunk=16)
    params = init_params(cfg.model_config(), generator=3, device="cpu")
    prompts = ["hello", "a prompt longer than one chunk of 16"]
    streams = {}
    for dev in (cuda_device, "cpu"):
        eng = LLMEngine(cfg, params=params, device=dev)
        try:
            streams[str(dev)] = [
                eng.generate(p, SamplingParams(max_tokens=12)).token_ids
                for p in prompts]
        finally:
            eng.shutdown()
    assert streams["cuda"] == streams["cpu"]


FLASH_CASES = [(causal, rep, d, s) for causal in (True, False)
               for rep in (1, 4) for d in (64, 128) for s in (256, 200)]


def _flash_inputs(dev, rep, d, s, seed, b=2, h=8):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    return (rnd(b, h, s, d), rnd(b, h // rep, s, d), rnd(b, h // rep, s, d),
            rnd(b, h, s, d))


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("causal,rep,d,s", FLASH_CASES)
def test_flash_kernels_match_plain_twins_on_card(cuda_device, causal, rep,
                                                 d, s):
    q, k, v, do = _flash_inputs(cuda_device, rep, d, s, seed=rep * d + s)
    scale = d ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
    p_out, p_lse = att.flash_fwd_plain(q, k, v, causal, scale)
    grads = att.flash_bwd_cuda(q, k, v, p_out, p_lse, do, causal, scale)
    plain = att.flash_bwd_plain(q, k, v, p_out, p_lse, do, causal, scale)
    torch.cuda.synchronize()
    assert _rel(out, p_out) < 1e-2
    assert (lse - p_lse).abs().max().item() < 2e-3
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert _rel(got, want) < 1e-2, name


@pytest.mark.cuda
def test_flash_attention_autograd_launches_both_kernels_on_card(cuda_device):
    q, k, v, do = _flash_inputs(cuda_device, 4, 64, 384, seed=5)
    q, k, v = [t.requires_grad_() for t in (q, k, v)]
    before = (att.flash_fwd_cuda.launches, att.flash_bwd_cuda.launches)
    out = att.flash_attention(q, k, v, True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (att.flash_fwd_cuda.launches, att.flash_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = att.attention_reference(*ref, True)
    want.backward(do.float())
    assert _rel(out, want) < 2e-2
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        assert _rel(got, r.grad) < 2e-2


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take_on_card(cuda_device):
    q = torch.zeros((1, 2, 64, 96), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        att.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="bfloat16"):
        att.flash_attention(q[..., :64].float(), q[..., :64].float(),
                            q[..., :64].float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_on_card_keeps_the_gradient(cuda_device, dtype):
    """On a CUDA tensor that requires a gradient, rms_norm launches the
    kernel and gives the reference's gradient (not a detached output)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((64, 2048), generator=g, device=cuda_device).to(dtype)
    w = (1 + 0.1 * torch.randn((2048,), generator=g,
                               device=cuda_device)).to(dtype)
    dy = torch.randn((64, 2048), generator=g, device=cuda_device).to(dtype)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = norms.rms_norm.launches
    y = norms.rms_norm(x1, w1, 1e-5)
    assert norms.rms_norm.launches == before + 1
    assert y.requires_grad and y.grad_fn is not None
    y.backward(dy)
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    norms.rms_norm_reference(x2, w2, 1e-5).backward(dy)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(x1.grad, x2.grad, **tol)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=0, atol=0)
    with torch.no_grad():
        assert not norms.rms_norm(x1, w1).requires_grad


@pytest.mark.cuda
def test_bf16_train_steps_on_card_follow_the_cpu(cuda_device):
    """Three steps of a small bf16 trainer through K1-K3 on the card track
    the same steps through the plain twins on the CPU (losses within 1e-2
    relative: bf16 matmul outputs round apart where the devices sum in
    other orders), and the step launches every kernel of its path."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_seq_len=128, dtype="bfloat16")
    params = init_params(cfg, generator=11, device="cpu")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    targets = torch.roll(tokens, -1, dims=1)
    losses = {}
    for dev in (cuda_device, "cpu"):
        step, init, shard = make_llama_train_step(
            cfg, optimizer=adamw_lowmem(1e-3, weight_decay=0.1),
            remat="attn", device=dev)
        state = init(params)
        before = (norms.rms_norm.launches, att.flash_fwd_cuda.launches,
                  att.flash_bwd_cuda.launches)
        losses[str(dev)] = [step(state, shard(tokens), shard(targets))[1][
            "loss"].item() for _ in range(3)]
        after = (norms.rms_norm.launches, att.flash_fwd_cuda.launches,
                 att.flash_bwd_cuda.launches)
        if str(dev) == "cuda":
            # per step: 2 norms a layer + final, 2 recomputed a layer; one
            # flash forward and one backward a layer
            assert [a - b for a, b in zip(after, before)] == [27, 6, 6]
        else:
            assert after == before
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-2 * abs(b), losses
    assert losses["cuda"][-1] < losses["cuda"][0]
