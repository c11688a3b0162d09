"""ray_tpu_torch attention against the JAX package's, on the same inputs.

Inputs come from numpy with fixed seeds and go through both sides. The
JAX side runs its Pallas flash kernels as tests/test_ops.py runs them on
the CPU (interpret mode; ``attn_mod.INTERPRET`` with ``FUSED_BWD`` for the
backward); the port runs the kernels' plain twins, which is what
``flash_attention`` does with CPU tensors. Tolerances, f32: 2e-5 on the
forward (the twin walks 64-wide kv tiles, the Pallas kernel 256-wide: the
online-softmax sums differ in order only) and 1e-4 of the largest
gradient on the backward (five products summed in other orders); bf16
against the f32 reference: 2e-2 of the largest value (bf16 q.scale, p
and ds roundings, as in the kernels). bf16 against the Pallas kernels on
the same bf16 inputs: one bf16 ulp of each tensor's largest value (both
sides round at the same points; a rounding of p or ds that lands the other
way, or JAX's bf16 store of each packed head group's dk/dv before its f32
fold, moves an output by at most that), lse within 2e-4 (l sums bf16 p).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.ops.attention as attn_mod
from ray_tpu.ops.attention import attention_reference as jax_reference
from ray_tpu.ops.attention import blockwise_attention as jax_blockwise
from ray_tpu_torch.ops import attention as att


def _qkv(b, h, hkv, s, d, seed=0, skv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv or s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv or s, d)).astype(np.float32)
    return q, k, v


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _force_interpret_mode():
    import jax
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pltpu.force_tpu_interpret_mode unavailable on jax "
                    f"{jax.__version__}")
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_matches_pallas_interpret(causal):
    """K2's twin (out, lse) against _flash_fwd_pallas itself."""
    q, k, v = _qkv(1, 8, 2, 256, 64, seed=1)
    with _force_interpret_mode():
        want_o, want_lse = attn_mod._flash_fwd_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            sm_scale=0.125)
    out, lse = att.flash_fwd_plain(*_t(q, k, v), causal, 0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("h,hkv,causal", [(8, 2, True), (4, 4, True),
                                          (8, 1, False)])
def test_flash_attention_grads_match_pallas_fused_backward(h, hkv, causal):
    """flash_attention's gradients (K3's twin on the CPU) against JAX's
    flash_attention with the fused Pallas backward in interpret mode."""
    import jax

    q, k, v = _qkv(1, h, hkv, 256, 64, seed=h + hkv)
    w = np.linspace(0.5, 1.5, q.size).reshape(q.shape).astype(np.float32)
    old = attn_mod.INTERPRET, attn_mod.FUSED_BWD
    attn_mod.INTERPRET, attn_mod.FUSED_BWD = True, True
    try:
        want = jax.grad(
            lambda q, k, v: (attn_mod.flash_attention(
                q, k, v, causal, None, True) * w).sum(),
            argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        attn_mod.INTERPRET, attn_mod.FUSED_BWD = old
    tq, tk, tv = [t.requires_grad_() for t in _t(q, k, v)]
    (att.flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum() \
        .backward()
    for name, got, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                              want):
        ref = np.asarray(ref)
        assert got.shape == ref.shape, name
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_and_reference_match_jax(causal):
    q, k, v = _qkv(2, 4, 2, 96, 32, seed=3)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = _t(q, k, v)
    want = np.asarray(jax_reference(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(
        att.attention_reference(tq, tk, tv, causal).numpy(), want,
        rtol=1e-5, atol=1e-5)
    want_b = np.asarray(jax_blockwise(jq, jk, jv, causal=causal,
                                      kv_block=40))
    np.testing.assert_allclose(
        att.blockwise_attention(tq, tk, tv, causal, kv_block=40).numpy(),
        want_b, rtol=1e-5, atol=1e-5)


def test_repeat_kv_matches_jax():
    _, k, _ = _qkv(1, 8, 2, 16, 8, seed=4)
    want = np.asarray(attn_mod._repeat_kv(jnp.asarray(k), 8))
    np.testing.assert_array_equal(
        att._repeat_kv(torch.from_numpy(k), 8).numpy(), want)


@pytest.mark.parametrize("s,skv", [(200, 200), (64, 64), (100, 150)])
@pytest.mark.parametrize("causal", [True, False])
def test_twins_handle_ragged_lengths(s, skv, causal):
    """The kernels mask the ragged tail instead of asserting S % block ==
    0; their twins do the same and agree with the reference (f32)."""
    q, k, v = _qkv(1, 4, 2, s, 64, seed=s + skv, skv=skv)
    tq, tk, tv = [t.requires_grad_() for t in _t(q, k, v)]
    out = att.flash_attention(tq, tk, tv, causal)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (out * g).sum().backward()
    rq, rk, rv = [t.detach().clone().requires_grad_() for t in (tq, tk, tv)]
    ref = att.attention_reference(rq, rk, rv, causal)
    (ref * g).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for got, want in ((tq.grad, rq.grad), (tk.grad, rk.grad),
                      (tv.grad, rv.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_twins_stay_within_bf16_of_the_f32_reference(d):
    """The twins' bf16 roundings (q.scale, p, ds) cost no more than bf16
    precision: out and grads within 2e-2 of the largest f32 value."""
    q, k, v = _qkv(1, 8, 2, 192, d, seed=d)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    bq, bk, bv, bg = _t(q, k, v, g, dtype=torch.bfloat16)
    out, lse = att.flash_fwd_plain(bq, bk, bv, True, d ** -0.5)
    dq, dk, dv = att.flash_bwd_plain(bq, bk, bv, out, lse, bg, True,
                                     d ** -0.5)
    assert out.dtype == dq.dtype == dk.dtype == torch.bfloat16
    fq, fk, fv = [t.float().requires_grad_() for t in (bq, bk, bv)]
    ref = att.attention_reference(fq, fk, fv, True)
    (ref * bg.float()).sum().backward()
    for got, want in ((out, ref), (dq, fq.grad), (dk, fk.grad),
                      (dv, fv.grad)):
        err = (got.float() - want.detach()).abs().max() / want.abs().max()
        assert err < 2e-2, err


def _bf16_ulp_err(got: torch.Tensor, want) -> float:
    """Max abs error in bf16 ulps of the reference's largest value."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.float().numpy() - want).max() / ulp)


_BF16_CASES = [(8, 2, True, 64), (4, 4, True, 64), (8, 1, False, 64),
               (8, 2, True, 128)]


def _bf16_inputs(h, hkv, d):
    q, k, v = _qkv(1, h, hkv, 256, d, seed=h + hkv + d)
    g = np.random.default_rng(d).standard_normal(q.shape).astype(np.float32)
    return (_t(q, k, v, g, dtype=torch.bfloat16),
            [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)])


@pytest.mark.parametrize("h,hkv,causal,d", _BF16_CASES)
def test_bf16_flash_fwd_plain_matches_pallas_interpret(h, hkv, causal, d):
    """K2's twin against _flash_fwd_pallas on the same bf16 inputs, with
    the Pallas kernel's kv blocks at the twin's 64 so both walk the same
    online-softmax tiles: the bf16 roundings (qs, p) are the kernel's."""
    (bq, bk, bv, _), (jq, jk, jv, _) = _bf16_inputs(h, hkv, d)
    with _force_interpret_mode():
        want_o, want_lse = attn_mod._flash_fwd_pallas(
            jq, jk, jv, causal=causal, sm_scale=d ** -0.5, block_q=64,
            block_k=64)
    out, lse = att.flash_fwd_plain(bq, bk, bv, causal, d ** -0.5)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _bf16_ulp_err(out, want_o) <= 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("h,hkv,causal,d", _BF16_CASES)
def test_bf16_flash_grads_match_pallas_fused_backward(h, hkv, causal, d):
    """K3's twin against _flash_bwd_fused_pallas on the same bf16 inputs
    and residuals (q, k, v, out, lse, dO), then flash_attention's
    gradients end to end against JAX's flash_attention with the fused
    Pallas backward, both in interpret mode."""
    import jax

    (bq, bk, bv, bg), (jq, jk, jv, jg) = _bf16_inputs(h, hkv, d)
    out, lse = att.flash_fwd_plain(bq, bk, bv, causal, d ** -0.5)
    got = att.flash_bwd_plain(bq, bk, bv, out, lse, bg, causal, d ** -0.5)
    old = attn_mod.INTERPRET, attn_mod.FUSED_BWD
    attn_mod.INTERPRET, attn_mod.FUSED_BWD = True, True
    try:
        want = attn_mod._flash_bwd_fused_pallas(
            jq, jk, jv, jnp.asarray(out.float().numpy(), jnp.bfloat16),
            jnp.asarray(lse.numpy()), jg, causal, d ** -0.5)
        want_e2e = jax.grad(
            lambda q, k, v: (attn_mod.flash_attention(q, k, v, causal)
                             .astype(jnp.float32)
                             * jg.astype(jnp.float32)).sum(),
            argnums=(0, 1, 2))(jq, jk, jv)
    finally:
        attn_mod.INTERPRET, attn_mod.FUSED_BWD = old
    tq, tk, tv = [t.clone().requires_grad_() for t in (bq, bk, bv)]
    (att.flash_attention(tq, tk, tv, causal).float() * bg.float()).sum() \
        .backward()
    for name, a, w, e, we in zip(("dq", "dk", "dv"), got, want,
                                 (tq.grad, tk.grad, tv.grad), want_e2e):
        assert a.dtype == e.dtype == torch.bfloat16, name
        assert _bf16_ulp_err(a, w) <= 1.0, (name, "same residuals")
        assert _bf16_ulp_err(e, we) <= 1.0, (name, "end to end")


def test_flash_attention_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    raises rather than computing the plain twin."""
    q = torch.empty((1, 4, 64, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 2, 64, 64), device="meta", dtype=torch.bfloat16)
    before = att.flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_attention(q, k, k)
    assert att.flash_fwd_cuda.launches == before


def test_flash_attention_rejects_bad_shapes_and_counts_no_cpu_launch():
    q, k, v = _t(*_qkv(1, 6, 4, 32, 16))
    with pytest.raises(ValueError, match="GQA"):
        att.flash_attention(q, k, v)
    before = (att.flash_fwd_cuda.launches, att.flash_bwd_cuda.launches)
    q, k, v = [t.requires_grad_() for t in _t(*_qkv(1, 4, 2, 32, 16))]
    att.flash_attention(q, k, v).sum().backward()
    assert (att.flash_fwd_cuda.launches,
            att.flash_bwd_cuda.launches) == before
