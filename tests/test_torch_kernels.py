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
order round a value apart; K3 and K7 sum dq across CTAs in ascending
kv-tile order, not the twin's), and K3's and K7's dq, dk, dv the same
bits on a second launch; lse
within 2e-3 (f32 sums of the same bf16 p in another order); the chunk
kernels K6/K7 alike (K6's out is f32), and the split backward K4/K5
(dq, and dk/dv folded to the kv heads inside K5, against ``fold_heads``
of the per-head twin), which must also repeat bit for bit (no atomics). The ring's schedule on the card
against K2/K3 on the whole sequence: 3e-2 of the largest value (the
tolerance of tests/test_ops.py's ring checks: the ring rounds its f32
output to bf16 once, the chunks' p roundings differ from one pass's).
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as att
from ray_tpu_torch.ops import norms

BF16_TOL = dict(rtol=8e-3, atol=1e-2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def test_rms_norm_rejects_what_the_kernel_does_not_take():
    # The width limit is the kernel's (16-byte vectors): a tensor off the
    # CPU is refused before any launch; the plain path takes any width.
    x = torch.empty((4, 60), device="meta")
    with pytest.raises(ValueError, match="multiple of 8"):
        norms.rms_norm(x, torch.empty(60, device="meta"))
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
def test_rms_norm_cuda_refuses_last_dim_6(cuda_device):
    """On the card the kernel's 16-byte vectors still need d % 8 == 0 (the
    CPU path takes d 6: tests/test_torch_ops.py's
    test_rms_norm_cpu_any_last_dim)."""
    before = norms.rms_norm.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        norms.rms_norm(torch.ones((3, 6), device=cuda_device),
                       torch.ones(6, device=cuda_device))
    assert norms.rms_norm.launches == before


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


# K6/K7 cases: (Sq, Skv, qpos offset, kpos offset) of local q against one
# visiting chunk at global positions: the diagonal chunk, a wholly visible
# past chunk, a wholly masked future chunk, offsets that are no multiple of
# 64, and ragged lengths (partly visible, and wholly masked: the tail past
# Skv must add nothing to a row that sees no key).
CHUNK_POS = {"diagonal": (256, 256, 256, 256), "past": (256, 256, 256, 0),
             "future": (256, 256, 0, 256), "offset": (256, 256, 100, 37),
             "ragged": (200, 136, 60, 0), "ragged_future": (200, 136, 0, 300)}
CHUNK_CASES = [(causal, rep, d, where) for causal in (True, False)
               for rep in (1, 4) for d in (64, 128) for where in CHUNK_POS]


def _chunk_case(dev, rep, d, where, seed, h=8):
    sq, skv, q0, k0 = CHUNK_POS[where]
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    qpos = torch.arange(sq, dtype=torch.int32, device=dev) + q0
    kpos = torch.arange(skv, dtype=torch.int32, device=dev) + k0
    return (rnd(1, h, sq, d), rnd(1, h // rep, skv, d), rnd(1, h // rep, skv, d),
            qpos, kpos, rnd(1, h, sq, d, dtype=torch.float32),
            rnd(1, h, sq, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,rep,d,where", CHUNK_CASES)
def test_flash_chunk_kernels_match_plain_twins_on_card(cuda_device, causal,
                                                       rep, d, where):
    """K6 (out f32, lse) and K7 (dq, dk, dv with a nonzero lse cotangent)
    against their twins on the same inputs and residuals."""
    q, k, v, qpos, kpos, g_out, g_lse = _chunk_case(
        cuda_device, rep, d, where, seed=rep * d + len(where))
    scale = d ** -0.5
    before = (att.flash_chunk_fwd_cuda.launches,
              att.flash_chunk_bwd_cuda.launches)
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal, scale)
    p_out, p_lse = att.flash_chunk_fwd_plain(q, k, v, qpos, kpos, causal,
                                             scale)
    grads = att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, p_out, p_lse,
                                     g_out, g_lse, causal, scale)
    plain = att.flash_chunk_bwd_plain(q, k, v, qpos, kpos, p_out, p_lse,
                                      g_out, g_lse, causal, scale)
    torch.cuda.synchronize()
    assert (att.flash_chunk_fwd_cuda.launches,
            att.flash_chunk_bwd_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert out.dtype == lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel(out, p_out) < 1e-2
    assert (lse - p_lse).abs().max().item() < 2e-3
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, want) < 1e-2, name


# Tile-class cases of K6/K7 (positions in the kernels' own tiles: K6 skips
# 64-wide kv tiles for 64-row halves of its 128-row q tiles, K7 skips
# 64-row q tiles for its 128-row kv tiles): "mixed" puts rows that see no
# key (qpos 0.., kpos 30..) in tiles with rows that do; "shuffled" is a
# seeded permutation of the diagonal case's positions, so a tile's min and
# max are not its first and last; "long causal" is S 1024, 16 tiles a
# side, every class present.
TILE_CASES = [(where, d, rep, causal)
              for where in ("mixed", "shuffled", "long causal")
              for d in (64, 128) for rep in (1, 4) for causal in (True, False)]


def _tile_positions(dev, where):
    if where == "mixed":
        return (torch.arange(256, dtype=torch.int32, device=dev),
                torch.arange(256, dtype=torch.int32, device=dev) + 30)
    if where == "shuffled":
        g = torch.Generator().manual_seed(11)
        base = torch.arange(256, dtype=torch.int32) + 256
        return (base[torch.randperm(256, generator=g)].to(dev),
                base[torch.randperm(256, generator=g)].to(dev))
    pos = torch.arange(1024, dtype=torch.int32, device=dev)
    return pos, pos.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("where,d,rep,causal", TILE_CASES)
def test_flash_chunk_kernels_tile_classes_on_card(cuda_device, where, d, rep,
                                                  causal):
    """K6 and K7 against their twins where they skip, mask or take whole
    tiles, at the twins' tolerances; rows that see no key finite with lse
    < -1e29; K7's dq, dk and dv the same bits on a second launch (dq's
    turns count only the kv tiles that visit a q tile)."""
    qpos, kpos = _tile_positions(cuda_device, where)
    h, sq, skv = 8, qpos.numel(), kpos.numel()
    g = torch.Generator(device=cuda_device).manual_seed(d + rep)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(1, h, sq, d), rnd(1, h // rep, skv, d), rnd(1, h // rep,
                                                               skv, d)
    g_out, g_lse = rnd(1, h, sq, d, dtype=torch.float32), rnd(
        1, h, sq, dtype=torch.float32)
    scale = d ** -0.5
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal, scale)
    p_out, p_lse = att.flash_chunk_fwd_plain(q, k, v, qpos, kpos, causal,
                                             scale)
    grads = att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, p_out, p_lse,
                                     g_out, g_lse, causal, scale)
    again = att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, p_out, p_lse,
                                     g_out, g_lse, causal, scale)
    plain = att.flash_chunk_bwd_plain(q, k, v, qpos, kpos, p_out, p_lse,
                                      g_out, g_lse, causal, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel(out, p_out) < 1e-2
    assert (lse - p_lse).abs().max().item() < 2e-3
    nokey = (qpos < kpos.min()) if causal else torch.zeros_like(qpos).bool()
    assert bool(nokey.any()) == (causal and where == "mixed")
    assert (lse[..., nokey] < -1e29).all()
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, want) < 1e-2, name
    for got, rerun in zip(grads, again):
        assert torch.equal(got, rerun)


def test_pair_chunk_refuses_to_time_without_a_card(tmp_path):
    """The paired K6/K7 reading measures only on a card: exit 2 here."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script would time")
    from ray_tpu_torch.devbench import pair_chunk

    assert pair_chunk.main(["--other", str(tmp_path)]) == 2


def test_pair_split_refuses_to_time_without_a_card(tmp_path):
    """The paired K4/K5 reading measures only on a card: exit 2 here,
    before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script would time")
    from ray_tpu_torch.devbench import pair_split

    assert pair_split.main(["--other", str(tmp_path)]) == 2
    assert list(tmp_path.iterdir()) == []


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["mixed", "shuffled", "long causal"])
def test_chunk_tile_bounds_kernel_matches_plain_on_card(cuda_device, where):
    """The chunk kernels' pre-pass against chunk_tile_bounds_plain, one
    launch counted; also on ragged lengths."""
    qpos, kpos = _tile_positions(cuda_device, where)
    for qp, kp in ((qpos, kpos), (qpos[:200], kpos[:70])):
        before = att.chunk_tile_bounds_cuda.launches
        got = att.chunk_tile_bounds_cuda(qp, kp)
        torch.cuda.synchronize()
        assert att.chunk_tile_bounds_cuda.launches == before + 1
        assert torch.equal(got, att.chunk_tile_bounds_plain(qp, kp))


@pytest.mark.cuda
def test_simulated_ring_on_card_matches_flash_attention(cuda_device):
    """The flash ring's schedule over 4 virtual ranks (16 K6 and, through
    autograd, 16 K7 launches) against K2/K3 on the whole sequence: output
    and q/k/v gradients within 3e-2 of each tensor's largest value."""
    from ray_tpu_torch.ops.ring_attention import simulate_ring

    q, k, v, do = _flash_inputs(cuda_device, 4, 64, 1024, seed=7, b=1)
    q, k, v = [t.requires_grad_() for t in (q, k, v)]
    before = (att.flash_chunk_fwd_cuda.launches,
              att.flash_chunk_bwd_cuda.launches)
    out = simulate_ring(q, k, v, 4)
    out.backward(do)
    assert (att.flash_chunk_fwd_cuda.launches,
            att.flash_chunk_bwd_cuda.launches) == (before[0] + 16,
                                                   before[1] + 16)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = att.flash_attention(*ref, True)
    want.backward(do)
    assert _rel(out, want) < 3e-2
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        assert _rel(got, r.grad) < 3e-2


@pytest.mark.cuda
def test_one_rank_nccl_cp_loss_matches_no_sp_on_card(cuda_device):
    """forward_hidden with sp_axis = a one-rank NCCL group runs the ring
    (K6/K7, no point-to-point op) and gives sp_axis=None's loss (K2/K3):
    the same arithmetic, within 1e-3 relative."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_seq_len=512, dtype="bfloat16")
    params = init_params(cfg, generator=13, device=cuda_device)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g).to(
        cuda_device)
    targets = torch.roll(tokens, -1, dims=1)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        before = (att.flash_chunk_fwd_cuda.launches,
                  att.flash_fwd_cuda.launches)
        with torch.no_grad():
            cp = loss_fn(cfg, params, tokens, targets, remat="attn+",
                         sp_axis=dist.group.WORLD,
                         positions=torch.arange(512, device=cuda_device))
        assert (att.flash_chunk_fwd_cuda.launches,
                att.flash_fwd_cuda.launches) == (before[0] + 2, before[1])
        with torch.no_grad():
            plain = loss_fn(cfg, params, tokens, targets, remat="attn+")
    finally:
        dist.destroy_process_group()
    assert abs(cp.item() - plain.item()) <= 1e-3 * abs(plain.item())


# K4/K5 (the split backward) against their twins: causal/non-causal, GQA
# rep 1/4, head_dim 64/128, a 256 length, the ViT-B/16 token count (197)
# and a ragged 1000; then rep 2 and 8 (H 8, Hkv 1), and the kernels'
# 128-row tile edges (S 127, 128, 129, 257) and S 1. K4's dq and K5's dk/dv
# (folded inside the kernel, against fold_heads of the per-head twin),
# then the whole split backward, within 1e-2 of the largest value (one
# bf16 ulp where sums in another order round a value apart).
SPLIT_CASES = [(causal, rep, d, s) for causal in (True, False)
               for rep in (1, 4) for d in (64, 128) for s in (256, 197, 1000)]
SPLIT_CASES += [(causal, rep, d, 256) for causal in (True, False)
                for rep in (2, 8) for d in (64, 128)]
SPLIT_CASES += [(causal, 4, d, s) for causal in (True, False)
                for d in (64, 128) for s in (1, 127, 128, 129, 257)]


def _split_residuals(q, k, v, do, causal, scale):
    out, lse = att.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1)
    return out, lse, delta


@pytest.mark.cuda
@pytest.mark.parametrize("causal,rep,d,s", SPLIT_CASES)
def test_split_kernels_match_plain_twins_on_card(cuda_device, causal, rep,
                                                 d, s):
    q, k, v, do = _flash_inputs(cuda_device, rep, d, s, seed=rep * d + s + 1)
    scale = d ** -0.5
    out, lse, delta = _split_residuals(q, k, v, do, causal, scale)
    before = (att.flash_bwd_dq_cuda.launches, att.flash_bwd_dkv_cuda.launches)
    dq = att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert (att.flash_bwd_dq_cuda.launches,
            att.flash_bwd_dkv_cuda.launches) == (before[0] + 1, before[1] + 1)
    want_dq = att.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    want_dk, want_dv = (att.fold_heads(t, k.shape[1])
                        for t in att.flash_bwd_dkv_plain(
                            q, k, v, do, lse, delta, causal, scale))
    # At S 1 a row's softmax has one key: p = 1 and dp = delta, so dq and
    # dk vanish in exact arithmetic and both sides hold rounding noise
    # alone. There each output is held to 1e-2 of the twin's largest
    # gradient (dv = dO); elsewhere to its own largest value.
    floor = (max(w.float().abs().max().item()
                 for w in (want_dq, want_dk, want_dv)) if s == 1 else 0.0)

    def rel(got, want):
        err = (got.float() - want.float()).abs().max().item()
        return err / max(want.float().abs().max().item(), floor)

    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all(), name
        assert rel(got, want) < 1e-2, name
    grads = att.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, scale)
    plain = att.flash_bwd_split_plain(q, k, v, out, lse, do, causal, scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert got.shape == want.shape, name
        assert rel(got, want) < 1e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_split_kernels_repeat_bit_for_bit_on_card(cuda_device, causal):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v, do = _flash_inputs(cuda_device, 4, 64, 1024, seed=21)
    out, lse, delta = _split_residuals(q, k, v, do, causal, 0.125)
    first = att.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, 0.125)
    again = att.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, 0.125)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_split_kernels_repeat_bit_for_bit_at_d128_on_card(cuda_device,
                                                          causal):
    """The same at head_dim 128, where K5's fold goes through its f32
    scratch in device memory."""
    q, k, v, do = _flash_inputs(cuda_device, 4, 128, 1000, seed=22)
    out, lse, delta = _split_residuals(q, k, v, do, causal, 0.125)
    first = att.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, 0.125)
    again = att.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, 0.125)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_split_kernels_take_more_than_65535_heads_on_card(cuda_device):
    """B * H = 65544 (B 5462, H 12, S 8, D 64, non-causal): more
    (batch, head) pairs than a grid's y dimension holds; K4 and K5 keep
    them on a linear grid and match their twins."""
    q, k, v, do = _flash_inputs(cuda_device, 1, 64, 8, seed=23, b=5462,
                                h=12)
    scale = 64 ** -0.5
    out, lse, delta = _split_residuals(q, k, v, do, False, scale)
    dq = att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, False, scale)
    dk, dv = att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, False, scale)
    torch.cuda.synchronize()
    want_dq = att.flash_bwd_dq_plain(q, k, v, do, lse, delta, False, scale)
    want_dk, want_dv = att.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               False, scale)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.shape == want.shape, name
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, want) < 1e-2, name


@pytest.mark.cuda
def test_split_kernels_at_the_vit_b16_shape_on_card(cuda_device):
    """ViT-B/16's attention: 12 heads, 197 tokens, head_dim 64, non-causal
    (16 images of the trainer's 128)."""
    g = torch.Generator(device=cuda_device).manual_seed(197)
    q, k, v, do = (torch.randn((16, 12, 197, 64), generator=g,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    scale = 64 ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, False, scale)
    grads = att.flash_bwd_split_cuda(q, k, v, out, lse, do, False, scale)
    plain = att.flash_bwd_split_plain(q, k, v, out, lse, do, False, scale)
    fused = att.flash_bwd_cuda(q, k, v, out, lse, do, False, scale)
    torch.cuda.synchronize()
    for name, got, want, k3 in zip(("dq", "dk", "dv"), grads, plain, fused):
        assert _rel(got, want) < 1e-2, name
        assert _rel(got, k3) < 2e-2, name  # K3 rounds at other points


@pytest.mark.cuda
def test_flash_attention_split_backward_launches_k4_k5_on_card(cuda_device):
    q, k, v, do = _flash_inputs(cuda_device, 4, 64, 384, seed=6)
    q, k, v = [t.requires_grad_() for t in (q, k, v)]
    names = ("flash_fwd_cuda", "flash_bwd_cuda", "flash_bwd_dq_cuda",
             "flash_bwd_dkv_cuda")
    before = [getattr(att, n).launches for n in names]
    old = att.FUSED_BWD
    att.FUSED_BWD = False
    try:
        att.flash_attention(q, k, v, True).backward(do)
    finally:
        att.FUSED_BWD = old
    torch.cuda.synchronize()
    assert [getattr(att, n).launches - b for n, b in zip(names, before)] == \
        [1, 0, 1, 1]
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    att.attention_reference(*ref, True).backward(do.float())
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        assert got.shape == r.shape and _rel(got, r.grad) < 2e-2


# The head-packed forward kernels K8 (epi), K9 (inl) and K10 (masked):
# (kernel, causal, rep, D, pack, block_q, block_k), every tile each takes
# at some pack, at S 512 (B2 H8); at most 256 rows a CTA at D 64 (16
# warps) and 128 at D 128.
PACKED_CASES = [
    (kind, causal, rep, d, pack, bq, bk)
    for kind in ("masked", "epi", "inl") for causal in (True, False)
    for d in (64, 128)
    for rep, pack, bq, bk in ((1, 1, 64, 64), (4, 2, 128, 128),
                              (4, 4, 64, 128), (4, 1, 128, 64),
                              (4, 2, 64, 64), (4, 4, 64, 64),
                              (4, 2, 64, 128), (4, 1, 128, 128))
    if (kind != "inl" or bq == bk) and pack * bq <= (256 if d == 64 else 128)]


def _packed(kind):
    from ray_tpu_torch.devbench import prof_flash_pack as pfp

    return pfp.KERNELS[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,causal,rep,d,pack,bq,bk", PACKED_CASES)
def test_packed_kernels_match_plain_twins_on_card(cuda_device, kind, causal,
                                                  rep, d, pack, bq, bk):
    q, k, v, _ = _flash_inputs(cuda_device, rep, d, 512, seed=rep * d + bk)
    scale = d ** -0.5
    fn, twin = _packed(kind)
    before = fn.launches
    out, lse = fn(q, k, v, causal, scale, pack, bq, bk)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    p_out, p_lse = twin(q, k, v, causal, scale, pack, bq, bk)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _rel(out, p_out) < 1e-2
    assert (lse - p_lse).abs().max().item() < 2e-3


def _packed_tiles(kind, rep, d, s, block_k=None):
    """(pack, block_q, block_k) that kernel ``kind`` takes at GQA rep,
    head_dim d and length s (block_k alone when given)."""
    from ray_tpu_torch.devbench import prof_flash_pack as pfp

    return [(p, bq, bk) for p in pfp.PACKS if rep % p == 0
            for bq in pfp.BLOCKS for bk in pfp.BLOCKS
            if p * bq <= pfp.MAX_ROWS[d] and (kind != "inl" or bq == bk)
            and s % bq == 0 and s % bk == 0
            and block_k in (None, bk)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_packed_kernels_agree_with_k2_at_block_k_64_on_card(cuda_device, d,
                                                            causal):
    """The same arithmetic over the same 64-wide kv tiles as K2, on the
    same wgmma products: out and lse are K2's bits, for every pack and
    block_q each kernel takes."""
    q, k, v, _ = _flash_inputs(cuda_device, 4, d, 1024, seed=64 + d)
    scale = d ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
    for kind in ("masked", "epi", "inl"):
        for pack, bq, bk in _packed_tiles(kind, 4, d, 1024, block_k=64):
            got, got_lse = _packed(kind)[0](q, k, v, causal, scale, pack, bq,
                                            bk)
            torch.cuda.synchronize()
            assert torch.equal(got, out), (kind, pack, bq)
            assert torch.equal(got_lse, lse), (kind, pack, bq)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bk", [64, 128])
def test_packed_kernels_give_one_block_ks_bits_at_every_pack_on_card(
        cuda_device, bk, d, causal):
    """For one block_k, the three schedules at every pack and block_q give
    the same out and lse bits (they differ only in masks that hide nothing
    or tiles that add nothing), and a second launch repeats them."""
    q, k, v, _ = _flash_inputs(cuda_device, 4, d, 768, seed=70 + d + bk)
    scale = d ** -0.5
    first = None
    for kind in ("masked", "epi", "inl"):
        fn = _packed(kind)[0]
        for pack, bq, _ in _packed_tiles(kind, 4, d, 768, block_k=bk):
            got = fn(q, k, v, causal, scale, pack, bq, bk)
            again = fn(q, k, v, causal, scale, pack, bq, bk)
            torch.cuda.synchronize()
            assert torch.equal(got[0], again[0]), (kind, pack, bq)
            assert torch.equal(got[1], again[1]), (kind, pack, bq)
            if first is None:
                first = got
            assert torch.equal(got[0], first[0]), (kind, pack, bq)
            assert torch.equal(got[1], first[1]), (kind, pack, bq)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [64, 384, 640])
def test_packed_kernels_at_one_tile_and_odd_tile_counts_on_card(
        cuda_device, s, d, causal):
    """S 64 (one kv tile), and S 384 and 640: kv-tile counts (3, 5, 6 and
    10) that are no multiple of the ring's stages (3 at D 64, 2 at D 128)
    at some block_k. Every kernel at every tile it takes, against its
    twin; causal S 64's rows see few keys (FEW_KEYS_LSE_TOL)."""
    q, k, v, _ = _flash_inputs(cuda_device, 4, d, s, seed=s + d)
    scale = d ** -0.5
    lse_tol = FEW_KEYS_LSE_TOL if causal and s == 64 else 2e-3
    for kind in ("masked", "epi", "inl"):
        fn, twin = _packed(kind)
        for pack, bq, bk in _packed_tiles(kind, 4, d, s):
            out, lse = fn(q, k, v, causal, scale, pack, bq, bk)
            p_out, p_lse = twin(q, k, v, causal, scale, pack, bq, bk)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), (kind, pack, bq, bk)
            assert _rel(out, p_out) < 1e-2, (kind, pack, bq, bk)
            assert (lse - p_lse).abs().max().item() < lse_tol, (kind, pack,
                                                                bq, bk)


@pytest.mark.cuda
def test_packed_kernels_reject_what_they_do_not_take_on_card(cuda_device):
    q, k, v, _ = _flash_inputs(cuda_device, 2, 64, 256, seed=3)  # rep 2
    for kind in ("masked", "epi", "inl"):
        fn = _packed(kind)[0]
        before = fn.launches
        with pytest.raises(ValueError, match="divide"):
            fn(q, k, v, True, 0.125, 4, 64, 64)
        with pytest.raises(ValueError, match="ragged"):
            fn(q[:, :, :200], k[:, :, :200], v[:, :, :200], True, 0.125, 1,
               64, 64)
        with pytest.raises(TypeError, match="bfloat16"):
            fn(q.float(), k.float(), v.float(), True, 0.125, 1, 64, 64)
        assert fn.launches == before


# K2 and K3 (redesigned for Hopper: TMA rings, wgmma, 128-row tiles, dq
# summed across K3's CTAs by float4 reductions, delta made inside K3)
# against their twins at the lengths the main paths and their edges give:
# S 2048 (the 1.1B step), 1000 (a ragged tail), 197 (ViT-B/16's tokens)
# and 1, within 1e-2 of the largest value (lse 2e-3). At S 1 a row's
# softmax has one key: p = 1 and dp = delta, so dq and dk vanish in exact
# arithmetic and hold rounding noise alone; there each output is held to
# 1e-2 of the twin's largest gradient (dv = dO).
FLASH_LENGTH_CASES = [(causal, rep, d, s) for causal in (True, False)
                      for rep in (1, 4) for d in (64, 128)
                      for s in (2048, 1000, 197, 1)]


def _flash_errs(q, k, v, do, causal, scale):
    """K2 and K3 (on the twin's residuals) against their twins: out's and
    each gradient's max error over the largest value (at S 1 over the
    largest gradient), lse's max error."""
    out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
    p_out, p_lse = att.flash_fwd_plain(q, k, v, causal, scale)
    grads = att.flash_bwd_cuda(q, k, v, p_out, p_lse, do, causal, scale)
    plain = att.flash_bwd_plain(q, k, v, p_out, p_lse, do, causal, scale)
    torch.cuda.synchronize()
    floor = (max(w.float().abs().max().item() for w in plain)
             if q.shape[2] == 1 else 0.0)
    errs = {"out": _rel(out, p_out),
            "lse": (lse - p_lse).abs().max().item()}
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert got.shape == want.shape and got.dtype == torch.bfloat16, name
        assert torch.isfinite(got.float()).all(), name
        err = (got.float() - want.float()).abs().max().item()
        errs[name] = err / max(want.float().abs().max().item(), floor)
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("causal,rep,d,s", FLASH_LENGTH_CASES)
def test_flash_kernels_match_plain_twins_at_main_path_lengths_on_card(
        cuda_device, causal, rep, d, s):
    q, k, v, do = _flash_inputs(cuda_device, rep, d, s, seed=rep * d + s + 2)
    errs = _flash_errs(q, k, v, do, causal, d ** -0.5)
    assert errs.pop("lse") < 2e-3
    for name, e in errs.items():
        assert e < 1e-2, (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(256, 384), (384, 256), (100, 300),
                                    (197, 64)])
def test_flash_kernels_take_sq_unlike_skv_on_card(cuda_device, causal, d, sq,
                                                  skv):
    """Sq != Skv (positions 0..Sq-1 against 0..Skv-1), GQA rep 4."""
    g = torch.Generator(device=cuda_device).manual_seed(sq + skv + d)

    def rnd(*shape):
        return torch.randn(shape, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v, do = rnd(2, 8, sq, d), rnd(2, 2, skv, d), rnd(2, 2, skv, d), \
        rnd(2, 8, sq, d)
    errs = _flash_errs(q, k, v, do, causal, d ** -0.5)
    assert errs.pop("lse") < 2e-3
    for name, e in errs.items():
        assert e < 1e-2, (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_backward_repeats_dk_dv_bit_for_bit_on_card(cuda_device,
                                                          causal, d):
    """K3 sums dk/dv of a kv head in one CTA's registers and dq across
    CTAs in ascending kv-tile order: dq, dk and dv the same bits on every
    run."""
    q, k, v, do = _flash_inputs(cuda_device, 4, d, 1000, seed=31 + d)
    scale = d ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
    first = att.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    again = att.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    for got, rerun in zip(first, again):
        assert torch.equal(got, rerun)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,hkv,s", [(4, 32, 8, 2048), (8, 12, 12, 197)])
def test_fused_backward_repeats_dq_bit_for_bit_on_card(cuda_device, causal,
                                                       d, b, h, hkv, s):
    """K3 at the training shape's heads and at ViT-B/16's (non-causal S
    197: every kv tile takes a turn on every q tile): two launches, the
    same dq, dk and dv bits."""
    g = torch.Generator(device=cuda_device).manual_seed(s + d + causal)

    def rnd(*shape):
        return torch.randn(shape, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v, do = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)
    scale = d ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
    runs = [att.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    for got, rerun in zip(*runs):
        assert torch.equal(got, rerun)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["long causal", "mixed", "shuffled"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_chunk_backward_repeats_bit_for_bit_on_card(cuda_device, where,
                                                    causal, d):
    """K7 twice on one seeded input: the same dq, dk and dv bits, with
    skipped tiles (causal "long causal", "shuffled") and without
    (non-causal; "mixed", whose rows that see no key make every kv tile
    visit their q tiles), GQA rep 4."""
    qpos, kpos = _tile_positions(cuda_device, where)
    h, sq, skv = 8, qpos.numel(), kpos.numel()
    g = torch.Generator(device=cuda_device).manual_seed(d + sq + causal)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(1, h, sq, d), rnd(1, 2, skv, d), rnd(1, 2, skv, d)
    g_out, g_lse = rnd(1, h, sq, d, dtype=torch.float32), rnd(
        1, h, sq, dtype=torch.float32)
    scale = d ** -0.5
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal, scale)
    runs = [att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, out, lse, g_out,
                                     g_lse, causal, scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    for got, rerun in zip(*runs):
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, rerun)


@pytest.mark.cuda
def test_flash_wrappers_count_one_launch_a_call_on_card(cuda_device):
    """Each call of K2's and K3's wrappers adds one to its own count, and to
    no other kernel's; a refused call adds none."""
    q, k, v, do = _flash_inputs(cuda_device, 4, 64, 256, seed=41)
    names = ("flash_fwd_cuda", "flash_bwd_cuda", "flash_bwd_dq_cuda",
             "flash_bwd_dkv_cuda", "flash_chunk_fwd_cuda",
             "flash_chunk_bwd_cuda")
    before = [getattr(att, n).launches for n in names]
    out, lse = att.flash_fwd_cuda(q, k, v, True, 0.125)
    att.flash_fwd_cuda(q, k, v, False, 0.125)
    att.flash_bwd_cuda(q, k, v, out, lse, do, True, 0.125)
    with pytest.raises(RuntimeError, match="flash_fwd"):  # 3 % 2 heads
        att.flash_fwd_cuda(q[:, :3], k, v, True, 0.125)
    with pytest.raises(ValueError, match="q's shape"):  # K3 reads out whole
        att.flash_bwd_cuda(q, k, v, out[:, :, :128], lse, do, True, 0.125)
    torch.cuda.synchronize()
    assert [getattr(att, n).launches - b for n, b in zip(names, before)] == \
        [2, 1, 0, 0, 0, 0]


# lse of a row that sees few keys: one p in [0.5, 1) that rounds to the
# other side of a bf16 step in the kernel than in the twin (s summed in
# another order) moves l >= 1 by 2^-8, so lse by up to 2^-8. Causal S 64
# over 4M rows meets such a row (2.1e-3 read on an H100); rows that see 64
# keys (l >> 1) stay within 2e-3.
FEW_KEYS_LSE_TOL = 2 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_attention_kernels_take_a_batch_of_65536_on_card(cuda_device,
                                                         causal):
    """B 65536 (H 1, S 64, D 64): more batch rows than a grid's y or z
    dimension holds. K2, K3, K6 and K7 keep them on a linear grid and
    match their twins."""
    q, k, v, do = _flash_inputs(cuda_device, 1, 64, 64, seed=47, b=65536,
                                h=1)
    lse_tol = FEW_KEYS_LSE_TOL if causal else 2e-3
    errs = _flash_errs(q, k, v, do, causal, 0.125)
    assert errs.pop("lse") < lse_tol
    for name, e in errs.items():
        assert e < 1e-2, ("K2/K3", name, e)
    pos = torch.arange(64, dtype=torch.int32, device=cuda_device)
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, pos, pos, causal, 0.125)
    p_out, p_lse = att.flash_chunk_fwd_plain(q, k, v, pos, pos, causal,
                                             0.125)
    g_lse = torch.zeros_like(p_lse)
    grads = att.flash_chunk_bwd_cuda(q, k, v, pos, pos, p_out, p_lse,
                                     do.float(), g_lse, causal, 0.125)
    plain = att.flash_chunk_bwd_plain(q, k, v, pos, pos, p_out, p_lse,
                                      do.float(), g_lse, causal, 0.125)
    torch.cuda.synchronize()
    assert _rel(out, p_out) < 1e-2
    assert (lse - p_lse).abs().max().item() < lse_tol
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert _rel(got, want) < 1e-2, ("K7", name)


@pytest.mark.cuda
def test_packed_kernel_takes_more_than_65535_head_packs_on_card(cuda_device):
    """B * H / pack = 65536 (B 65536, H 2, Hkv 1, pack 2, S 64, D 64): more
    packs of heads than a grid's y dimension holds; K8, K9 and K10 keep
    them on a linear grid and match their twin."""
    q, k, v, _ = _flash_inputs(cuda_device, 2, 64, 64, seed=53, b=65536,
                               h=2)
    p_out, p_lse = _packed("masked")[1](q, k, v, True, 0.125, 2, 64, 64)
    for kind in ("masked", "epi", "inl"):
        out, lse = _packed(kind)[0](q, k, v, True, 0.125, 2, 64, 64)
        torch.cuda.synchronize()
        assert _rel(out, p_out) < 1e-2, kind
        assert (lse - p_lse).abs().max().item() < FEW_KEYS_LSE_TOL, kind


def test_pair_packed_refuses_to_time_without_a_card(tmp_path):
    """The paired K8-K10 reading measures only on a card: exit 2 here,
    before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script would time")
    from ray_tpu_torch.devbench import pair_packed

    assert pair_packed.main(["--other", str(tmp_path)]) == 2
    assert list(tmp_path.iterdir()) == []


def test_pair_flash_refuses_to_time_without_a_card(tmp_path):
    """The paired K2/K3 reading measures only on a card: exit 2 here,
    before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script would time")
    from ray_tpu_torch.devbench import pair_flash

    assert pair_flash.main(["--other", str(tmp_path)]) == 2
    assert list(tmp_path.iterdir()) == []
