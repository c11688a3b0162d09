"""ray_tpu_torch's training slice against the JAX package's, on the CPU.

One JAX ``init_params`` tree, converted with ``params_from_jax``, drives
both sides; tokens come from numpy. JAX's flash attention runs its
blockwise path on the CPU, the port its kernels' plain twins; both are
exact f32 attention, so the sides differ by summation order only.
Tolerances (f32, tiny config): loss 1e-5, gradients 1e-4 of each leaf's
largest value, one optimizer update 1e-6; the 5-step loss trajectory
1e-4 (the default adamw stores mu in bf16 on both sides, so a mu value
near a rounding boundary may round apart).
"""

import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.train import optim as jax_optim
from ray_tpu_torch._device import tree_leaves
from ray_tpu_torch.accelerators import flops
from ray_tpu_torch.models import llama
from ray_tpu_torch.train import optim, spmd

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()


def _jax_params(seed=0):
    return jax_llama.init_params(JCFG, jax.random.PRNGKey(seed))


def _tokens(b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def _port_grads(params, tokens, targets, **kw):
    leaves = llama.tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = llama.loss_fn(CFG, leaves, torch.from_numpy(tokens),
                         torch.from_numpy(targets), **kw)
    loss.backward()
    return loss.item(), llama.tree_map(lambda t: t.grad, leaves)


@pytest.mark.parametrize("fused_ce", [True, False])
def test_loss_fn_and_grads_match_jax_on_tiny(fused_ce):
    jp = _jax_params()
    tokens, targets = _tokens()
    want, wgrads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(JCFG, p, jnp.asarray(tokens),
                                    jnp.asarray(targets), fused_ce=fused_ce,
                                    attn_impl="flash", remat="attn"))(jp)
    got, grads = _port_grads(llama.params_from_jax(jp, "cpu"), tokens,
                             targets, fused_ce=fused_ce, attn_impl="flash",
                             remat="attn")
    np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=1e-5)
    want_g, got_g = _flat(wgrads), _flat(llama.tree_map(
        lambda t: t.numpy(), grads))
    assert want_g.keys() == got_g.keys()
    for name, w in want_g.items():
        err = np.abs(got_g[name] - w).max() / max(np.abs(w).max(), 1e-12)
        assert err < 1e-4, (name, err)


REMATS = [False, True, "none", "full", "attn", "attn+", ("attn", "attn+"),
          "full:1,attn+:1", "dots", "dots+", "dots:1,attn:1",
          ("dots+", "attn+")]


@pytest.mark.parametrize("remat", REMATS)
def test_every_remat_policy_gives_the_grads_of_none(remat):
    params = llama.init_params(CFG, generator=1, device="cpu")
    tokens, targets = _tokens(seed=2)
    loss0, g0 = _port_grads(params, tokens, targets, remat="none")
    loss1, g1 = _port_grads(params, tokens, targets, remat=remat)
    assert loss1 == loss0
    for name, w in _flat(llama.tree_map(lambda t: t.numpy(), g0)).items():
        got = _flat(llama.tree_map(lambda t: t.numpy(), g1))[name]
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_unported_remat_raises():
    """Every policy runs; what the port refuses is a per-layer spec whose
    length is not the layer count (JAX's ``ValueError``)."""
    for spec in (("attn",), "dots:1", "attn:1,dots:2"):
        with pytest.raises(ValueError, match="entries"):
            llama.normalize_remat(spec, CFG.num_layers)


def test_normalize_remat_and_runs_match_jax():
    for spec in ("attn:1,full:1", ("attn", "attn"), "attn+", True):
        assert llama.normalize_remat(spec, 2) == \
            jax_llama.normalize_remat(spec, 2)
    spec = ("attn", "attn", "full", "attn+")
    assert llama._remat_runs(spec) == jax_llama._remat_runs(spec)


def _one_update(port_tx, jax_tx):
    rng = np.random.default_rng(7)
    p = {"a": rng.standard_normal((4, 8)).astype(np.float32),
         "b": {"c": rng.standard_normal(16).astype(np.float32)}}
    g = {"a": rng.standard_normal((4, 8)).astype(np.float32),
         "b": {"c": rng.standard_normal(16).astype(np.float32)}}
    jp, jg = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g)
    js = jax_tx.init(jp)
    for _ in range(2):  # the second update reads the stored moments
        ju, js = jax_tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, ju)
    tp = llama.tree_map(torch.from_numpy, p)
    tg = llama.tree_map(torch.from_numpy, g)
    ts = port_tx.init(tp)
    for _ in range(2):
        tu, ts = port_tx.update(tg, ts, tp)
        optim.apply_updates(tp, tu)
    for name, w in _flat(jp).items():
        got = _flat(llama.tree_map(lambda t: t.numpy(), tp))[name]
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert int(ts[0].count) == 2


def test_adamw_lowmem_update_matches_jax():
    _one_update(optim.adamw_lowmem(1e-2, weight_decay=0.1),
                jax_optim.adamw_lowmem(1e-2, weight_decay=0.1))


def test_adamw_update_matches_optax():
    _one_update(optim.adamw(1e-2, weight_decay=0.1, mu_dtype=torch.bfloat16),
                optax.adamw(1e-2, weight_decay=0.1, mu_dtype=jnp.bfloat16))


def test_optimizer_state_bytes_match_jax():
    jp = _jax_params()
    tp = llama.params_from_jax(jp, "cpu")
    for port_tx, jax_tx in (
            (optim.adamw_lowmem(), jax_optim.adamw_lowmem()),
            (optim.adamw(mu_dtype=torch.bfloat16),
             optax.adamw(3e-4, mu_dtype=jnp.bfloat16))):
        assert optim.optimizer_state_bytes(port_tx, tp) == \
            jax_optim.optimizer_state_bytes(jax_tx, jp)


@pytest.mark.parametrize("opt", ["default", "lowmem"])
def test_five_step_trajectory_matches_jax_train_step(opt):
    """make_llama_train_step on tiny() f32 from one JAX-initialised tree:
    the port's losses and grad norms over 5 steps against JAX's step on a
    one-device CPU mesh."""
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.train.spmd import make_llama_train_step as jax_make

    mesh = build_mesh(MeshSpec(dp=1), jax.devices("cpu")[:1])
    jtx = jax_optim.adamw_lowmem(1e-3, weight_decay=0.1) \
        if opt == "lowmem" else None
    ttx = optim.adamw_lowmem(1e-3, weight_decay=0.1) \
        if opt == "lowmem" else None
    jstep, jinit, jshard = jax_make(JCFG, mesh, optimizer=jtx,
                                    attn_impl="flash", remat="attn+")
    jstate = jinit()
    tparams = llama.params_from_jax(jstate.params, "cpu")
    tstep, tinit, tshard = spmd.make_llama_train_step(
        CFG, optimizer=ttx, attn_impl="flash", remat="attn+", device="cpu")
    tstate = tinit(tparams)
    want, got = [], []
    tokens, targets = _tokens(2, 64, seed=10)  # one batch, as bench.py
    for _ in range(5):
        jstate, jm = jstep(jstate, jshard(tokens), jshard(targets))
        tstate, tm = tstep(tstate, tshard(tokens), tshard(targets))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((tm["loss"].item(), tm["grad_norm"].item()))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4,
                               atol=1e-4)
    assert int(tstate.step) == 5
    assert got[-1][0] < got[0][0]
    for name, w in _flat(jax.device_get(jstate.params)).items():
        g = _flat(llama.tree_map(lambda t: t.detach().numpy(),
                                 tstate.params))[name]
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4, err_msg=name)


def test_init_state_copies_the_given_tree_and_steps_in_place():
    params = llama.init_params(CFG, generator=3, device="cpu")
    before = params["layers"]["wq"].clone()
    step, init, shard = spmd.make_llama_train_step(CFG, device="cpu",
                                                   remat="none")
    state = init(params)
    wq = state.params["layers"]["wq"]
    tokens, targets = _tokens(seed=4)
    state2, metrics = step(state, shard(tokens), shard(targets))
    assert state2 is state and state.params["layers"]["wq"] is wq
    assert not torch.equal(wq.detach(), before)
    assert torch.equal(params["layers"]["wq"], before)  # caller's tree
    assert all(p.grad is None for p in tree_leaves(state.params))
    assert metrics["loss"].dim() == 0 and metrics["grad_norm"].item() > 0


def test_training_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmd.make_llama_train_step(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmd.make_train_step(loss=None, init_fn=None)
    spmd.make_llama_train_step(CFG, device="cpu")


def _layout_mesh(**sizes):
    """A DeviceMesh of these axis sizes that needs no process group: the
    factory's checks read only its names and sizes."""
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.parallel.mesh import AXIS_ORDER

    shape = [sizes.get(a, 1) for a in AXIS_ORDER]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
        shape), mesh_dim_names=AXIS_ORDER, _init_backend=False, _rank=0)


_DDP = dict(vocab=None, embed=None, mlp=None, heads=None, kv_heads=None)
STILL_RAISE = {
    # The JAX factory's ValueErrors (tests compare the message with it).
    "dcn_not_in_mesh": (dict(dp=2), _DDP, {"dcn_axes": ("dcn",)},
                        ValueError),
    "dcn_not_a_batch_axis": (dict(dp=2), _DDP, {"dcn_axes": ("tp",)},
                             ValueError),
    "quant_without_dcn": (dict(dp=2), _DDP, {"dcn_quant": "int8"},
                          ValueError),
    "unknown_quant": (dict(dp=2), _DDP, {"dcn_axes": ("dp",),
                                         "dcn_quant": "fp8"}, ValueError),
}


@pytest.mark.parametrize("case", list(STILL_RAISE))
def test_multi_device_options_raise(case):
    """What still raises: the JAX factory's ValueErrors, on the same
    inputs and with its messages (every rule table trains:
    tests/test_torch_param_shard.py and tests/test_torch_layouts.py)."""
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.parallel.sharding import ShardingRules as JaxRules
    from ray_tpu.train.spmd import make_llama_train_step as jax_make
    from ray_tpu_torch.parallel.sharding import ShardingRules

    sizes, over, opts, exc = STILL_RAISE[case]
    with pytest.raises(exc) as got:
        spmd.make_llama_train_step(CFG, _layout_mesh(**sizes),
                                   rules=ShardingRules().override(**over),
                                   device="cpu", **opts)
    n = int(np.prod(list(sizes.values())))
    with pytest.raises(ValueError) as want:
        jax_make(JCFG, build_mesh(MeshSpec(**sizes), jax.devices("cpu")[:n]),
                 rules=JaxRules().override(**over), **opts)
    assert str(got.value) == str(want.value)


def test_grad_accum_batch_error_matches_jax():
    """mesh=None: a batch that grad_accum does not divide raises JAX's
    ValueError at the step; a divisible one trains."""
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.train.spmd import make_llama_train_step as jax_make

    tokens, targets = _tokens(b=4, s=16)
    jstep, jinit, jshard = jax_make(
        JCFG, build_mesh(MeshSpec(), jax.devices("cpu")[:1]), grad_accum=3,
        attn_impl="blockwise", remat=False)
    with pytest.raises(ValueError) as want:
        jstep(jinit(), jshard(tokens), jshard(targets))
    step, init, shard = spmd.make_llama_train_step(
        CFG, device="cpu", grad_accum=3, attn_impl="blockwise", remat=False)
    with pytest.raises(ValueError) as got:
        step(init(), shard(tokens), shard(targets))
    assert str(got.value) == str(want.value)


def test_train_package_imports_no_jax():
    code = ("import sys; import ray_tpu_torch.train, "
            "ray_tpu_torch.accelerators.flops, ray_tpu_torch.ops.loss, "
            "ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding, "
            "ray_tpu_torch.collective.quant, ray_tpu_torch.train.backend, "
            "ray_tpu_torch.train.checkpoint; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ray_tpu.')) or m == 'ray_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_flops_table_and_bench_counts():
    assert flops.peak_flops("h100") == 989e12
    assert flops.peak_flops("H100", "fp8") == 1979e12
    assert flops.peak_flops("a100") == 0.0
    assert flops.generation_of("NVIDIA H100 80GB HBM3") == "h100"
    # K2's work at the bench shape: 68.7 GFLOP (B4 H32 S2048 D64 causal).
    assert abs(flops.attention_flops(4, 32, 2048, 64) - 68.72e9) < 0.01e9
    bench = replace(CFG, vocab_size=32128, hidden_size=2048,
                    intermediate_size=8192, num_layers=16, num_heads=32,
                    num_kv_heads=8, head_dim=64, tie_embeddings=True)
    want = 6 * bench.num_params() * 4 * 2048 + 3 * 16 * 68.72e9
    assert abs(flops.llama_train_flops(bench, 4, 2048) - want) / want < 1e-3
