"""ray_tpu_torch ops against the JAX package's ops on the same inputs.

Inputs come from numpy with fixed seeds and go through both sides; the
JAX side runs as its own tests run it on the CPU (the reference, and the
Pallas kernel in interpret mode). Tolerances: f32 atol 1e-5 (sum order
differs); bf16 within one bf16 ulp at these magnitudes (rtol 8e-3,
atol 1e-2: the two sides may round the last bit apart). The CUDA kernel
itself runs only on a card: tests/test_torch_kernels.py holds its tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.norms import rms_norm as jax_rms_norm
from ray_tpu.ops.norms import rms_norm_pallas
from ray_tpu.ops.norms import rms_norm_reference as jax_rms_norm_reference
from ray_tpu.ops.rope import apply_rope as jax_apply_rope
from ray_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from ray_tpu_torch.ops import norms
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=8e-3, atol=1e-2)
LLAMA3_SCALING = {"factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position": 8192}


def _force_interpret_mode():
    """Pallas TPU interpret mode on the CPU (as tests/test_ops.py runs
    the kernels); skips with the reason on jax releases without it."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pltpu.force_tpu_interpret_mode unavailable on jax "
                    f"{jax.__version__}")
    return pltpu.force_tpu_interpret_mode()


def _rms_inputs(rows, d, dtype, seed=0):
    """(jax x, jax w, torch x, torch w) holding identical values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 3 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = getattr(torch, dtype)

    def to_torch(a):  # bf16 -> f32 -> bf16 is exact
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(tdt)

    return jx, jw, to_torch(jx), to_torch(jw)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 64), (8, 2048), (33, 128),
                                    (256, 128)])
def test_rms_norm_reference_matches_jax(rows, d, dtype):
    jx, jw, tx, tw = _rms_inputs(rows, d, dtype, seed=rows)
    want = np.asarray(jax_rms_norm_reference(jx, jw, 1e-5)).astype(np.float32)
    got = norms.rms_norm_reference(tx, tw, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [256, 512])
def test_rms_norm_matches_jax_pallas_interpret(rows, dtype):
    """The wrapper's CPU path against the Pallas kernel itself."""
    jx, jw, tx, tw = _rms_inputs(rows, 128, dtype, seed=1)
    with _force_interpret_mode():
        want = rms_norm_pallas(jx, jw)
    got = norms.rms_norm(tx, tw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **_tol(dtype))


def test_rms_norm_cpu_path_is_the_reference_on_any_row_count():
    """The port has no row-count fallback: every row count is one path
    (the JAX wrapper falls back to its reference when rows % 256 != 0)."""
    for rows in (1, 3, 257, 300):
        _, _, tx, tw = _rms_inputs(rows, 64, "float32", seed=rows)
        torch.testing.assert_close(norms.rms_norm(tx.view(rows, 1, 64), tw),
                                   norms.rms_norm_reference(
                                       tx.view(rows, 1, 64), tw),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("d", [6, 12, 100])
def test_rms_norm_cpu_any_last_dim(d):
    """The plain path takes a last dim that is no multiple of 8, as the
    JAX package's rms_norm does (only the kernel needs the multiple; its
    refusal of d 6 on the card is tests/test_torch_kernels.py's
    test_rms_norm_cuda_refuses_last_dim_6)."""
    jx, jw, tx, tw = _rms_inputs(3, d, "float32", seed=d)
    want = np.asarray(jax_rms_norm(jx, jw)).astype(np.float32)
    got = norms.rms_norm(tx, tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_rope_frequencies_match_jax(head_dim, scaling):
    want = np.asarray(jax_rope_frequencies(head_dim, 500000.0, scaling))
    got = rope_frequencies(head_dim, 500000.0, scaling).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_matches_jax(scaling, batched_positions):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 16, 64)).astype(np.float32)
    if batched_positions:
        pos = rng.integers(0, 200, (2, 16)).astype(np.int32)
    else:
        pos = np.arange(16, dtype=np.int32) + 5
    inv_j = jax_rope_frequencies(64, 500000.0, scaling)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), inv_j))
    inv_t = rope_frequencies(64, 500000.0, scaling)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv_t)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_apply_rope_casts_back_to_bf16():
    x = torch.randn((1, 2, 8, 16), generator=torch.Generator().manual_seed(0))
    out = apply_rope(x.to(torch.bfloat16), torch.arange(8),
                     rope_frequencies(16))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(), apply_rope(x.to(torch.bfloat16).float(), torch.arange(8),
                                rope_frequencies(16)).to(torch.bfloat16).float())
