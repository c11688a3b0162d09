"""ray_tpu_torch's CUDA kernels and their wrappers, without JAX.

The card machine has no JAX, and tests/conftest.py imports it, so this
file imports only torch and the port. On a card, from the repo root:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q

Tests marked ``cuda`` skip without a card (the kernels have no CPU mode);
the others check the wrappers' contracts on the CPU. Tolerances: bf16
within one bf16 ulp of the plain version (rtol 8e-3, atol 1e-2), f32
1e-5 (the kernel sums squares in another order); the f32 engines' greedy
streams (tiny width and 1B width) must be equal on the card and on the
CPU.
"""

import pytest
import torch

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
