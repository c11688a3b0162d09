"""ray_tpu_torch's ViT and its training step against the JAX package's, on
the CPU.

One JAX ``init_params`` tree, converted with ``params_from_jax``, drives
both sides; images and labels come from numpy. The JAX side runs
``attn_impl="flash"`` with ``INTERPRET`` set, so its Pallas flash kernels
run (forward, and the fused or split backward as ``FUSED_BWD`` says); the
port runs the kernels' plain twins. Configs: a head_dim-64 ViT (image 32,
patch 4, hidden 128, 2 heads, MLP 256, 2 layers, 10 classes: 65 tokens,
the kernels' head_dim) and ``ViTConfig.tiny()`` (head_dim 16, 17 tokens).

Tolerances. f32: logits and loss 1e-5, every gradient 1e-4 of its leaf's
largest value (exact attention on both sides; sums in other orders); the
5-step trajectory (losses and grad norms) 1e-4 under adamw_lowmem and
5e-4 under the default adamw, whose first moment is stored in bf16: a
moment near a rounding boundary rounds apart on the two sides, and the
grad norm read 1.6e-4 apart by the third step. bf16: logits within 2e-2
of their largest value (every matmul output and gelu round to bf16 on
both sides, at points XLA and PyTorch may round apart by one ulp, and 2
layers carry it).
"""

import contextlib
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.ops.attention as attn_mod
from ray_tpu.models import vit as jax_vit
from ray_tpu.train import optim as jax_optim
from ray_tpu_torch._device import tree_map
from ray_tpu_torch.accelerators import flops
from ray_tpu_torch.models import vit
from ray_tpu_torch.ops import attention as att
from ray_tpu_torch.train import adamw_lowmem, make_vit_train_step
from test_torch_param_shard import _jax_init

D64 = dict(image_size=32, patch_size=4, hidden_size=128, intermediate_size=256,
           num_layers=2, num_heads=2, num_classes=10)
CONFIGS = {"d64": (vit.ViTConfig(**D64), jax_vit.ViTConfig(**D64)),
           "tiny": (vit.ViTConfig.tiny(), jax_vit.ViTConfig.tiny())}


def _batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, cfg.image_size, cfg.image_size,
                                cfg.num_channels)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, b).astype(np.int32)
    return images, labels


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(jnp.asarray(tree, jnp.float32))}


@contextlib.contextmanager
def _interpret(fused: bool = True):
    """The JAX flash path through its Pallas kernels in interpret mode,
    with the backward choice ``fused``; restores both attributes."""
    old = attn_mod.INTERPRET, attn_mod.FUSED_BWD
    attn_mod.INTERPRET, attn_mod.FUSED_BWD = True, fused
    try:
        yield
    finally:
        attn_mod.INTERPRET, attn_mod.FUSED_BWD = old


@contextlib.contextmanager
def _port_bwd(fused: bool):
    """The port's backward choice ``fused``, restored on exit."""
    old = att.FUSED_BWD
    att.FUSED_BWD = fused
    try:
        yield
    finally:
        att.FUSED_BWD = old


def test_patchify_equals_jax_bit_for_bit():
    cfg, jcfg = CONFIGS["d64"]
    images, _ = _batch(cfg, b=3)
    want = np.asarray(jax_vit.patchify(jcfg, jnp.asarray(images)))
    got = vit.patchify(cfg, torch.from_numpy(images)).numpy()
    assert got.shape == (3, 64, 48)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_jax_round_trips_the_tree(name):
    cfg, jcfg = CONFIGS[name]
    jp = jax_vit.init_params(replace(jcfg, dtype="bfloat16"),
                             jax.random.PRNGKey(0))
    tp = vit.params_from_jax(jp, "cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    want, got = _flat(jp), _flat(tree_map(lambda t: t.float().numpy(), tp))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    own = vit.init_params(cfg, generator=0, device="cpu")
    assert {k: v.shape for k, v in _flat(tree_map(
        lambda t: t.numpy(), own)).items()} == {k: v.shape
                                                for k, v in want.items()}
    n = sum(a.size for a in _flat(tree_map(lambda t: t.numpy(),
                                           own)).values())
    assert n == cfg.num_params() == jcfg.num_params()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(name, dtype):
    cfg, jcfg = (replace(c, dtype=dtype) for c in CONFIGS[name])
    jp = jax_vit.init_params(jcfg, jax.random.PRNGKey(1))
    images, _ = _batch(cfg, seed=1)
    with _interpret():
        want = np.asarray(jax_vit.forward(jcfg, jp, jnp.asarray(images),
                                          attn_impl="flash"))
    got = vit.forward(cfg, vit.params_from_jax(jp, "cpu"),
                      torch.from_numpy(images), attn_impl="flash")
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 2e-2, err


def _grads(cfg, params, images, labels, **kw):
    leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = vit.loss_fn(cfg, leaves, torch.from_numpy(images),
                       torch.from_numpy(labels), **kw)
    loss.backward()
    return loss.item(), _flat(tree_map(lambda t: t.grad.numpy(), leaves))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_grads_match_jax_under_both_backwards(name, fused):
    cfg, jcfg = CONFIGS[name]
    jp = jax_vit.init_params(jcfg, jax.random.PRNGKey(2))
    images, labels = _batch(cfg, b=3, seed=2)
    with _interpret(fused):
        want, wgrads = jax.value_and_grad(
            lambda p: jax_vit.loss_fn(jcfg, p, jnp.asarray(images),
                                      jnp.asarray(labels),
                                      attn_impl="flash"))(jp)
    with _port_bwd(fused):
        got, grads = _grads(cfg, vit.params_from_jax(jp, "cpu"), images,
                            labels, attn_impl="flash")
    np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=1e-5)
    wgrads = _flat(wgrads)
    assert wgrads.keys() == grads.keys()
    for k, w in wgrads.items():
        err = np.abs(grads[k] - w).max() / max(np.abs(w).max(), 1e-12)
        assert err < 1e-4, (k, err)


def test_blockwise_impl_gives_the_flash_grads():
    cfg, _ = CONFIGS["d64"]
    params = vit.init_params(cfg, generator=3, device="cpu")
    images, labels = _batch(cfg, seed=3)
    loss0, g0 = _grads(cfg, params, images, labels, attn_impl="flash")
    loss1, g1 = _grads(cfg, params, images, labels, attn_impl="xla")
    assert abs(loss0 - loss1) < 1e-5
    for k, w in g0.items():
        np.testing.assert_allclose(g1[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("opt", ["default", "lowmem"])
def test_five_step_trajectory_matches_jax_train_step(opt):
    """make_vit_train_step on the head_dim-64 config, f32, from one
    JAX-initialised tree: losses and grad norms over 5 steps against JAX's
    step on a one-device CPU mesh, Pallas kernels in interpret mode."""
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.train.spmd import make_vit_train_step as jax_make

    cfg, jcfg = CONFIGS["d64"]
    mesh = build_mesh(MeshSpec(dp=1), jax.devices("cpu")[:1])
    jtx = jax_optim.adamw_lowmem(1e-3, weight_decay=0.1) \
        if opt == "lowmem" else None
    ttx = adamw_lowmem(1e-3, weight_decay=0.1) if opt == "lowmem" else None
    images, labels = _batch(cfg, b=4, seed=10)  # one batch, repeated
    want, got = [], []
    with _interpret():
        jstep, jinit, jshard = jax_make(jcfg, mesh, optimizer=jtx,
                                        attn_impl="flash")
        jstate = _jax_init(jinit, mesh)
        tstep, tinit, tshard = make_vit_train_step(
            cfg, optimizer=ttx, attn_impl="flash", device="cpu")
        tstate = tinit(vit.params_from_jax(jstate.params, "cpu"))
        for _ in range(5):
            jstate, jm = jstep(jstate, jshard(images), jshard(labels))
            tstate, tm = tstep(tstate, tshard(images), tshard(labels))
            want.append((float(jm["loss"]), float(jm["grad_norm"])))
            got.append((tm["loss"].item(), tm["grad_norm"].item()))
    tol = 1e-4 if opt == "lowmem" else 5e-4  # see the module docstring
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=tol,
                               atol=1e-4)
    assert int(tstate.step) == 5
    assert got[-1][0] < got[0][0]


def test_gelu_is_the_tanh_form_of_jax():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x),
                                   approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4  # the erf form would not pass


@pytest.mark.parametrize("remat", [True, "full", "attn", "attn+", "dots",
                                   "dots+"])
def test_every_remat_policy_gives_the_grads_of_none(remat):
    cfg, _ = CONFIGS["d64"]
    params = vit.init_params(cfg, generator=5, device="cpu")
    images, labels = _batch(cfg, seed=5)
    loss0, g0 = _grads(cfg, params, images, labels, remat="none")
    loss1, g1 = _grads(cfg, params, images, labels, remat=remat)
    assert loss1 == loss0
    for k, w in g0.items():
        np.testing.assert_array_equal(g1[k], w, err_msg=k)


def test_vit_step_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_vit_train_step(vit.ViTConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vit.init_params(vit.ViTConfig.tiny())
    step, init, shard = make_vit_train_step(vit.ViTConfig.tiny(),
                                            device="cpu")
    state = init()
    images, labels = _batch(vit.ViTConfig.tiny(), seed=7)
    state, m = step(state, shard(images), shard(labels))
    assert np.isfinite(m["loss"].item()) and int(state.step) == 1


def test_vit_and_train_modules_import_no_jax():
    code = ("import sys; import ray_tpu_torch.models.vit, "
            "ray_tpu_torch.train; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ray_tpu.')) or m == 'ray_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_vit_train_flops_counts_each_product_over_its_tokens():
    cfg = vit.ViTConfig.base16()
    assert cfg.num_params() == 86463744
    h, i, n = 768, 3072, 196
    want = 6 * 128 * (768 * h * n + 12 * (4 * h * h + 2 * h * i) * (n + 1)
                      + h * 1000)
    want += 3 * 12 * 4 * 128 * 12 * 197 * 197 * 64  # non-causal attention
    got = flops.vit_train_flops(cfg, 128)
    assert abs(got - want) / want < 1e-12
    assert abs(got - 13.489e12) < 0.001e12
