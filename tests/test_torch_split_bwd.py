"""The port's split flash backward (K4 dq, K5 dk/dv, the GQA fold) against
the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds, in bf16. Both sides take the same
residuals: out and lse from the port's forward twin, dO, and delta =
rowsum(dO*O) in f32. The JAX side runs ``_flash_bwd_pallas`` (its dq and
dk/dv Pallas kernels) in interpret mode and folds dk/dv as its wrapper does
(ray_tpu/ops/attention.py:1063-1069); the port runs K4's and K5's plain
twins and ``fold_heads``. Tolerance: dq/dk/dv within one bf16 ulp of each
tensor's largest value. Both sides round at the same points (qs, ds, p,
the per-head dk/dv, the fold); their f32 sums run in other orders (the
twin contracts all of a row's keys in one product, the kernels block by
block), so a value near a rounding boundary may land one ulp apart.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.ops.attention as attn_mod
from ray_tpu_torch.ops import attention as att


def _inputs(h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, h, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]


def _jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _bf16_ulp_err(got: torch.Tensor, want) -> float:
    """Max abs error in bf16 ulps of the reference's largest value."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.float().numpy() - want).max() / ulp)


def _jax_split(q, k, v, out, lse, do, causal, scale, block):
    """JAX's split backward on the same residuals: the two Pallas kernels
    in interpret mode, then its wrapper's fold."""
    old = attn_mod.INTERPRET
    attn_mod.INTERPRET = True
    try:
        dq, dk, dv = attn_mod._flash_bwd_pallas(
            _jax(q), _jax(k), _jax(v), _jax(out), jnp.asarray(lse.numpy()),
            _jax(do), causal, scale, block_q=block, block_k=block)
    finally:
        attn_mod.INTERPRET = old
    h, hkv = q.shape[1], k.shape[1]
    per_head = dk, dv
    if hkv != h:
        b, _, skv, d = dk.shape
        dk, dv = (t.astype(jnp.float32).reshape(b, hkv, h // hkv, skv, d)
                  .sum(2).astype(jnp.bfloat16) for t in (dk, dv))
    return (dq, dk, dv), per_head


# The (h, hkv, causal) grid of tests/test_ops.py's split-backward test, at
# S 256 with 128-row blocks (two blocks a side), plus a non-causal
# ViT-like length (65 tokens: 64 patches and the class token).
SPLIT_CASES = [(2, 2, True, 256), (4, 2, True, 256), (2, 2, False, 256),
               (8, 2, True, 256), (8, 1, False, 256), (4, 4, False, 65)]


# At head_dim 128, the CUDA kernels' 128-row tile edge (S 129: one q row
# and one kv row past a tile; the Pallas side takes it as one block) and
# the widest GQA group (rep 8: H 8, Hkv 1).
SPLIT_EDGE_CASES = [(8, 2, True, 129), (8, 2, False, 129), (8, 1, True, 256),
                    (8, 1, False, 129)]


def _check_split_twins(h, hkv, causal, s, d):
    scale = d ** -0.5
    q, k, v, do = _inputs(h, hkv, s, d, seed=h * 10 + hkv + s)
    out, lse = att.flash_fwd_plain(q, k, v, causal, scale)
    block = 128 if s % 128 == 0 else s  # a block must divide S
    (wdq, wdk, wdv), (wdk_h, wdv_h) = _jax_split(q, k, v, out, lse, do,
                                                 causal, scale, block)
    got = att.flash_bwd_split_plain(q, k, v, out, lse, do, causal, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, (wdq, wdk, wdv)):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        assert _bf16_ulp_err(a, w) <= 1.0, name
    # K5's twin alone, before the fold: per q head, as the Pallas kernel.
    delta = (do.float() * out.float()).sum(-1)
    dk_h, dv_h = att.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                         scale)
    assert dk_h.shape == (1, h, s, d)
    assert _bf16_ulp_err(dk_h, wdk_h) <= 1.0
    assert _bf16_ulp_err(dv_h, wdv_h) <= 1.0


@pytest.mark.parametrize("h,hkv,causal,s", SPLIT_CASES)
def test_split_twins_match_pallas_split_backward(h, hkv, causal, s):
    _check_split_twins(h, hkv, causal, s, 64)


@pytest.mark.parametrize("h,hkv,causal,s", SPLIT_EDGE_CASES)
def test_split_twins_match_pallas_at_tile_edges_d128(h, hkv, causal, s):
    _check_split_twins(h, hkv, causal, s, 128)


def test_fold_heads_sums_the_rep_groups_in_f32_and_rounds_once():
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.standard_normal((2, 8, 5, 4)).astype(
        np.float32)).to(torch.bfloat16)
    want = t.float().reshape(2, 2, 4, 5, 4).sum(2).to(torch.bfloat16)
    assert torch.equal(att.fold_heads(t, 2), want)
    assert att.fold_heads(t, 8) is t


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_split_switch_on_the_cpu(causal):
    """With FUSED_BWD false, flash_attention's gradients are the split
    twin's bit for bit; flipped back, K3's twin's again."""
    q, k, v, do = _inputs(8, 2, 192, 64, seed=5)
    scale = 0.1  # not a power of two: scaling ds or k rounds apart
    out, lse = att.flash_fwd_plain(q, k, v, causal, scale)
    want = {True: att.flash_bwd_plain(q, k, v, out, lse, do, causal, scale),
            False: att.flash_bwd_split_plain(q, k, v, out, lse, do, causal,
                                             scale)}
    for a, b in zip(want[True], want[False]):  # other roundings
        assert not torch.equal(a, b)
    old = att.FUSED_BWD
    try:
        for fused in (False, True):
            att.FUSED_BWD = fused
            tq, tk, tv = [t.clone().requires_grad_() for t in (q, k, v)]
            att.flash_attention(tq, tk, tv, causal, scale).backward(do)
            for got, w in zip((tq.grad, tk.grad, tv.grad), want[fused]):
                assert torch.equal(got, w)
    finally:
        att.FUSED_BWD = old


def test_split_twins_follow_the_f32_reference():
    """In f32 the split twins are exact attention gradients (no roundings):
    within 1e-4 of the reference's largest value, ragged S included."""
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 100, 32)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 100, 32)).astype(
        np.float32)) for _ in range(2))
    for causal in (True, False):
        out, lse = att.flash_fwd_plain(q, k, v, causal, 32 ** -0.5)
        got = att.flash_bwd_split_plain(q, k, v, out, lse, do, causal,
                                        32 ** -0.5)
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        att.attention_reference(*ref, causal).backward(do)
        for a, r in zip(got, ref):
            err = (a - r.grad).abs().max() / r.grad.abs().max()
            assert err < 1e-4, err


def test_split_path_counts_no_cuda_launch_on_the_cpu():
    q, k, v, do = _inputs(4, 2, 64, 64, seed=9)
    before = (att.flash_bwd_dq_cuda.launches, att.flash_bwd_dkv_cuda.launches,
              att.flash_bwd_cuda.launches)
    old = att.FUSED_BWD
    att.FUSED_BWD = False
    try:
        tq = q.clone().requires_grad_()
        att.flash_attention(tq, k, v, True).backward(do)
    finally:
        att.FUSED_BWD = old
    assert (att.flash_bwd_dq_cuda.launches, att.flash_bwd_dkv_cuda.launches,
            att.flash_bwd_cuda.launches) == before


def test_split_wrappers_never_fall_back_off_the_cpu():
    q = torch.empty((1, 4, 64, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 2, 64, 64), device="meta", dtype=torch.bfloat16)
    rows = torch.empty((1, 4, 64), device="meta")
    for fn in (att.flash_bwd_dq_cuda, att.flash_bwd_dkv_cuda):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, k, q, rows, rows, True, 0.125)
        assert fn.launches == before


@pytest.mark.parametrize("env,want", [(None, True), ("1", True),
                                      ("0", False)])
def test_fused_bwd_reads_its_env_var_at_import(env, want):
    import os

    environ = {k: v for k, v in os.environ.items()
               if k != "RTPU_FLASH_FUSED_BWD"}
    if env is not None:
        environ["RTPU_FLASH_FUSED_BWD"] = env
    code = ("import ray_tpu_torch.ops.attention as a; "
            f"assert a.FUSED_BWD is {want}, a.FUSED_BWD")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=environ)
