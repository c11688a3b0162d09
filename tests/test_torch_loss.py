"""ray_tpu_torch's loss and norm gradients against the JAX package's.

Inputs come from numpy with fixed seeds and go through both sides, in f32
unless a test says otherwise. Tolerances: f32 values 1e-5 and gradients
1e-5 (sums in another order); bf16 within one bf16 ulp (rtol 8e-3, atol
1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.loss import fused_cross_entropy as jax_fused_ce
from ray_tpu.ops.norms import rms_norm_reference as jax_rms_reference
from ray_tpu_torch.ops import norms
from ray_tpu_torch.ops.loss import fused_cross_entropy


def _ce_inputs(b, s, h, v, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) / np.sqrt(h)).astype(np.float32)
    t = rng.integers(0, v, (b, s)).astype(np.int32)
    m = (rng.random((b, s)) > 0.3).astype(np.float32) if masked else None
    return x, w, t, m


@pytest.mark.parametrize("s,chunk,masked", [(128, 32, True),
                                            (96, 64, True),  # 96 % 64: one chunk
                                            (64, 512, False)])
def test_fused_cross_entropy_value_and_grads_match_jax(s, chunk, masked):
    x, w, t, m = _ce_inputs(2, s, 32, 160, seed=s, masked=masked)
    jm = None if m is None else jnp.asarray(m)
    want, (wdx, wdw) = jax.value_and_grad(
        lambda x, w: jax_fused_ce(x, w, jnp.asarray(t), jm, chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tm = None if m is None else torch.from_numpy(m)
    got = fused_cross_entropy(tx, tw, torch.from_numpy(t), tm, chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(wdw), rtol=1e-5,
                               atol=1e-5)


def test_fused_cross_entropy_equals_the_unfused_loss():
    x, w, t, m = _ce_inputs(2, 64, 16, 50, seed=5)
    tx, tw, tt, tm = (torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(t).long(), torch.from_numpy(m))
    logp = torch.log_softmax(tx @ tw, dim=-1)
    nll = -logp.gather(-1, tt[..., None])[..., 0]
    want = (nll * tm).sum() / tm.sum()
    torch.testing.assert_close(fused_cross_entropy(tx, tw, tt, tm, 16), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_grads_match_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 64)) * 2 + 0.3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((6, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw, jg = (jnp.asarray(a, jdt) for a in (x, w, g))
    _, vjp = jax.vjp(lambda x, w: jax_rms_reference(x, w, 1e-5), jx, jw)
    wdx, wdw = vjp(jg)
    tdt = getattr(torch, dtype)

    def tt(a):  # bf16 -> f32 -> bf16 is exact
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(tdt)

    tx, tw = tt(jx).requires_grad_(), tt(jw).requires_grad_()
    norms.rms_norm(tx, tw, 1e-5).backward(tt(jg))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=8e-3, atol=1e-2)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(wdx).astype(np.float32), **tol)
    # dw sums over rows: allow the bf16 sum one more ulp of its magnitude.
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               np.asarray(wdw).astype(np.float32),
                               **(tol if dtype == "float32" else
                                  dict(rtol=2e-2, atol=5e-2)))


def test_rms_norm_autograd_function_backward_is_the_reference_vjp():
    """The CUDA-path Function's backward (called directly here: the
    forward needs a card) is the VJP of the plain reference."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    w = torch.from_numpy((1 + rng.standard_normal(32) * 0.1).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))

    class Ctx:
        saved_tensors = (x, w)
        needs_input_grad = (True, True, False)
        eps = 1e-5

    dx, dw, none = norms._RmsNormFn.backward(Ctx, g)
    rx, rw = x.clone().requires_grad_(), w.clone().requires_grad_()
    norms.rms_norm_reference(rx, rw, 1e-5).backward(g)
    assert none is None
    torch.testing.assert_close(dx, rx.grad, rtol=0, atol=0)
    torch.testing.assert_close(dw, rw.grad, rtol=0, atol=0)
