"""The port's head-packed flash forward (K8, K9, K10) against the JAX
package's, on the CPU.

The JAX kernels live in devbench/prof_flash_pack.py, which is not a
package: the file is loaded by path and its three functions run under
``pltpu.force_tpu_interpret_mode()``. Inputs come from numpy with fixed
seeds, through float32 into bf16, and both sides take the same bf16
values. The port runs its wrappers on CPU tensors, which is its plain
twins, at the JAX kernel's own (pack, block_q, block_k). Tolerances: out
within 4e-3 absolute and lse within 2.5e-4: about 4x the gaps measured
between the JAX kernels and the twins at matching kv tiles (9.8e-4 and
6.3e-5 at B1 H8 Hkv2 S256 D64). Both sides round qs, p and out at the same
points; their f32 sums run in other orders. The twins walk their kernel's
block_k tiles, since the tile width moves where p is rounded.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.devbench import prof_flash_pack as pfp
from ray_tpu_torch.ops import attention as att

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL = 4e-3
LSE_TOL = 2.5e-4


@pytest.fixture(scope="module")
def jax_pack():
    spec = importlib.util.spec_from_file_location(
        "jax_prof_flash_pack",
        os.path.join(_ROOT, "devbench", "prof_flash_pack.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _force_interpret_mode():
    import jax
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("pltpu.force_tpu_interpret_mode unavailable on jax "
                    f"{jax.__version__}")
    return pltpu.force_tpu_interpret_mode()


def _inputs(h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, h, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]


def _jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


PORT = {kind: fns[0] for kind, fns in pfp.KERNELS.items()}
TWIN = {kind: fns[1] for kind, fns in pfp.KERNELS.items()}

# (kernel, causal, Hkv of H8, pack, D, block_q, block_k) at S 256: causal
# and not, rep 4 (pack 1/2/4) and rep 1, D 64/128, block_k 64/128; at most
# 256 rows a CTA at D 64 and 128 at D 128.
JAX_CASES = [
    ("masked", True, 2, 4, 64, 64, 64),
    ("masked", True, 2, 2, 64, 128, 64),
    ("masked", False, 2, 2, 128, 64, 128),
    ("masked", True, 8, 1, 128, 128, 128),
    ("epi", True, 2, 4, 64, 64, 128),
    ("epi", True, 2, 2, 128, 64, 64),
    ("epi", False, 2, 1, 64, 64, 64),
    ("epi", True, 8, 1, 64, 128, 128),
    ("inl", True, 2, 4, 64, 64, 64),
    ("inl", True, 2, 2, 64, 128, 128),
    ("inl", True, 2, 1, 128, 128, 128),
    ("inl", False, 2, 1, 64, 64, 64),
    ("inl", True, 8, 1, 128, 64, 64),
]


@pytest.mark.parametrize("kind,causal,hkv,pack,d,bq,bk", JAX_CASES)
def test_port_matches_the_jax_kernel(jax_pack, kind, causal, hkv, pack, d,
                                     bq, bk):
    q, k, v = _inputs(8, hkv, 256, d, seed=hkv * 100 + pack * 10 + d + bk)
    scale = d ** -0.5
    jq, jk, jv = _jax(q), _jax(k), _jax(v)
    with _force_interpret_mode():
        if kind == "inl":
            want = jax_pack.packed_fwd_inl(jq, jk, jv, causal, scale,
                                           pack=pack, block_q=bq)
        else:
            fn = (jax_pack.packed_fwd if kind == "masked"
                  else jax_pack.packed_fwd_epi)
            want = fn(jq, jk, jv, causal, scale, pack=pack, block_q=bq,
                      block_k=bk)
    before = PORT[kind].launches
    out, lse = PORT[kind](q, k, v, causal, scale, pack, bq, bk)
    assert PORT[kind].launches == before  # the CPU path counts no launch
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    want_o, want_lse = (np.asarray(jnp.asarray(w, jnp.float32))
                        for w in want)
    assert np.abs(out.float().numpy() - want_o).max() <= OUT_TOL
    assert np.abs(lse.numpy() - want_lse).max() <= LSE_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_twins_are_bit_identical_and_k2s_at_block_k_64(causal, d):
    """The schedules differ only in which tiles they mask, so for one
    block_k the three twins give the same bits at every (pack, block_q);
    at block_k 64 they are K2's twin, at 128 they are not."""
    q, k, v = _inputs(8, 2, 256, d, seed=d + int(causal))
    scale = d ** -0.5
    k2 = att.flash_fwd_plain(q, k, v, causal, scale)
    tiles = ((1, 64), (2, 128), (4, 64)) if d == 64 else \
        ((1, 64), (2, 64), (1, 128))
    for bk in (64, 128):
        runs = [TWIN[kind](q, k, v, causal, scale, pack, bq, bk)
                for kind in ("masked", "epi") for pack, bq in tiles]
        runs += [pfp.packed_fwd_inl_plain(q, k, v, causal, scale, pack, bk)
                 for pack in (1, 2) if pack * bk <= pfp.MAX_ROWS[d]]
        for out, lse in runs:
            assert torch.equal(out, runs[0][0])
            assert torch.equal(lse, runs[0][1])
        same_as_k2 = (torch.equal(runs[0][0], k2[0])
                      and torch.equal(runs[0][1], k2[1]))
        assert same_as_k2 == (bk == 64)


def test_the_schedules_follow_the_jax_loops():
    # K10 masks every tile to the bound; K8 only from m0 // block_k on;
    # K9 runs [0, qi) mask-free and the diagonal under its local mask.
    assert pfp.schedule("masked", 1, 128, 64, 4, True) == [
        (0, "global"), (1, "global"), (2, "global"), (3, "global")]
    assert pfp.schedule("epi", 1, 128, 64, 4, True) == [
        (0, None), (1, None), (2, "global"), (3, "global")]
    assert pfp.schedule("epi", 1, 64, 128, 2, True) == [(0, "global")]
    assert pfp.schedule("epi", 2, 64, 128, 2, True) == [
        (0, None), (1, "global")]
    assert pfp.schedule("inl", 2, 64, 64, 4, True) == [
        (0, None), (1, None), (2, "local")]
    for kind in ("masked", "epi", "inl"):
        assert pfp.schedule(kind, 0, 64, 64, 3, False) == [
            (0, None), (1, None), (2, None)]


@pytest.mark.parametrize("kind", ["masked", "epi", "inl"])
def test_wrappers_and_twins_reject_what_the_kernels_do_not_take(kind):
    q, k, v = _inputs(8, 4, 256, 64, seed=1)  # rep 2
    for fn in (PORT[kind], TWIN[kind]):
        with pytest.raises(ValueError, match="divide"):
            fn(q, k, v, True, 0.125, 4, 64, 64)  # pack 4 on rep 2
        with pytest.raises(ValueError, match="64 or 128"):
            fn(q, k, v, True, 0.125, 1, 32, 32)
        qr, kr, vr = _inputs(4, 2, 200, 64, seed=2)  # S 200
        with pytest.raises(ValueError, match="ragged"):
            fn(qr, kr, vr, True, 0.125, 1, 64, 64)
        q4, k4, v4 = _inputs(8, 2, 256, 64, seed=3)  # rep 4
        with pytest.raises(ValueError, match="more than 256"):
            fn(q4, k4, v4, True, 0.125, 4, 128, 128)  # 512 rows a CTA
        q8, k8, v8 = _inputs(8, 2, 256, 128, seed=5)
        with pytest.raises(ValueError, match="more than 128"):
            fn(q8, k8, v8, True, 0.125, 2, 128, 128)  # 256 rows at D 128
        with pytest.raises(ValueError, match="one length"):
            fn(q4, k4[:, :, :128], v4[:, :, :128], True, 0.125, 1, 64, 64)


def test_inline_kernel_needs_square_tiles():
    q, k, v = _inputs(8, 2, 256, 64, seed=4)
    for fn in (pfp.packed_fwd_inl, pfp.packed_fwd_inl_plain):
        with pytest.raises(ValueError, match="block_q == block_k"):
            fn(q, k, v, True, 0.125, 2, 64, 128)
    # block_k defaults to block_q
    out, _ = pfp.packed_fwd_inl(q, k, v, True, 0.125, 2, 128)
    want, _ = pfp.packed_fwd_inl_plain(q, k, v, True, 0.125, 2, 128, 128)
    assert torch.equal(out, want)


def test_wrappers_never_fall_back_off_the_cpu():
    q = torch.empty((1, 4, 64, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 2, 64, 64), device="meta", dtype=torch.bfloat16)
    for fn in PORT.values():
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, k, True, 0.125, 2, 64, 64)
        assert fn.launches == before


def test_variants_are_every_schedule_pack_and_tile_the_kernels_take():
    names = list(pfp.variants())
    assert names[0] == "prod" and len(names) == 1 + 10 + 10 + 5
    for name in ("pack4_bq64_bk128", "epi_pack2_bq128_bk64",
                 "pack1_bq128_bk128", "inl_pack4_bq64", "inl_pack2_bq128"):
        assert name in names
    for name in ("pack4_bq128_bk64", "inl_pack4_bq128", "inl_pack1_bq64_bk64"):
        assert name not in names


def test_timed_slope_chain_feeds_each_output_to_the_next_call():
    calls = []

    def step(c):
        calls.append(float(c[0]))
        return c + 1

    sec = pfp.timed_slope_chain(step, torch.zeros(3), reps=3)
    chain = pfp.L1 + pfp.L2
    assert len(calls) == (1 + 3) * chain and sec == sec  # finite
    assert calls[:pfp.L1] == [float(i) for i in range(pfp.L1)]


def test_main_check_runs_on_the_cpu(capsys):
    before = [fn.launches for fn in PORT.values()]
    assert pfp.main(["--check", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "inl_pack4_bq64" in printed and "prod" in printed
    assert [fn.launches for fn in PORT.values()] == before
    # Timing needs the card: on the CPU the sweep refuses to run.
    assert pfp.main(["--device", "cpu"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pfp.main(["--check"])


def test_prof_flash_pack_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; import ray_tpu_torch.devbench.prof_flash_pack; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ray_tpu.')) or m == 'ray_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=_ROOT)
