"""ray_tpu_torch's Mixtral (``models.mixtral``) and its training step
(``train.spmd.make_mixtral_train_step``) against the JAX package's, on
the CPU.

One process: ``compute_routing`` on seeded logits (with drops),
``moe_block``, ``forward`` (logits and aux) and ``loss_fn`` on
``MixtralConfig.tiny()`` through the blockwise attention, within 1e-5
(rtol and atol) of JAX's on the same ``init_params`` tree; the step with
``mesh=None`` against JAX's on one device. Over 4 gloo ranks (one group
for the module, ``ray_tpu_torch._spawn.run_ranks``; each rank checks
that no JAX module was loaded), against JAX on a mesh of 4 CPU devices:
the ep4 forward (JAX's ``test_expert_parallel_matches_single_device``),
and the step under the default rules on dp2 x ep2, ep2 x tp2, dp2 x
fsdp2, dp2 x fsdp2 with ``grad_accum=2``, dp2 x ep2 under ``zero1``,
and dp2 x ep2 at capacity factor 0.5, where routing each rank's tokens apart drops other claims
(a test shows its loss is not JAX's), so only the global routing
agrees.

Steps: f32, ``adamw(1e-2, eps=1e-3)`` (eps as in
tests/test_torch_param_shard.py: it bounds adam's gain near g = 0),
remat off, 3 steps on a [8, 16] batch. Losses and grad norms within 1e-5,
and the params after step 3, gathered, within 1e-5 on every element.
Random f32 router logits hold no ties, so ``torch.topk`` and
``lax.top_k`` pick the same experts (a test checks the logits it uses).
"""

import json
import os
import sys
import tempfile
from dataclasses import replace

import numpy as np
import pytest
import torch

from ray_tpu_torch._spawn import run_ranks
from test_torch_param_shard import _flat, _jax_init, _load_tree, _save_tree

RANK_TIMEOUT_S = 150
F32_TOL = 1e-5
ADAM_EPS = 1e-3
LR = 1e-2
STEPS = 3
# A capacity under which routing each rank's tokens apart visibly moves
# the loss (its distance from JAX's must exceed this).
LOCAL_ROUTING_GAP = 1e-3

# name -> (mesh axes, capacity factor (None: tiny's 1.25), step options)
CASES = {
    "dp2ep2": (dict(dp=2, ep=2), None, {}),
    "ep2tp2": (dict(ep=2, tp=2), None, {}),
    "dp2fsdp2": (dict(dp=2, fsdp=2), None, {}),
    "dp2fsdp2_accum": (dict(dp=2, fsdp=2), None, {"grad_accum": 2}),
    "dp2ep2_cap05": (dict(dp=2, ep=2), 0.5, {}),
    "dp2ep2_zero1": (dict(dp=2, ep=2), None, {"zero1": True}),
}


def _cfg(capacity=None, jax_side=False):
    if jax_side:
        from ray_tpu.models.mixtral import MixtralConfig
    else:
        from ray_tpu_torch.models.mixtral import MixtralConfig
    cfg = MixtralConfig.tiny()
    return cfg if capacity is None else replace(cfg, capacity_factor=capacity)


def _batch():
    tokens = np.random.default_rng(0).integers(0, 256, (8, 16),
                                               dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)








def _run(step, state, shard, steps=STEPS):
    x, y = _batch()
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, shard(x), shard(y))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


@pytest.fixture(scope="module")
def jax_tree():
    import jax

    from ray_tpu.models.mixtral import init_params

    return init_params(_cfg(jax_side=True), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_tree(jax_tree):
    from ray_tpu_torch.models.mixtral import params_from_jax

    return params_from_jax(jax_tree, "cpu")


# -- one process ------------------------------------------------------------

@pytest.mark.parametrize("t,capacity", [(16, 16), (16, 3), (64, 5),
                                        (33, 1)])
def test_compute_routing_matches_jax(t, capacity):
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    from ray_tpu_torch.models import mixtral as tm

    logits = np.random.default_rng(t + capacity).normal(
        size=(t, 4)).astype(np.float32)
    d, c, a = jm.compute_routing(_cfg(jax_side=True), jnp.asarray(logits),
                                 capacity)
    d2, c2, a2 = tm.compute_routing(_cfg(), torch.from_numpy(logits),
                                    capacity)
    assert np.array_equal(np.asarray(d), d2.numpy())
    np.testing.assert_allclose(c2.numpy(), np.asarray(c), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(a2), float(a), rtol=F32_TOL,
                               atol=F32_TOL)
    if capacity < t * 2 / 4:  # the case drops claims
        assert d2.sum() < 2 * t


def test_seeded_router_logits_hold_no_ties():
    """topk's order on ties is the one thing lax.top_k may do otherwise;
    the logits these tests route have none."""
    for t, capacity in [(16, 16), (16, 3), (64, 5), (33, 1)]:
        logits = np.random.default_rng(t + capacity).normal(size=(t, 4))
        assert all(len(set(row)) == 4 for row in logits)


def _x(cfg):
    return np.random.default_rng(1).normal(
        size=(2, 8, cfg.hidden_size)).astype(np.float32)


def test_moe_block_matches_jax(jax_tree, torch_tree):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    from ray_tpu_torch.models import mixtral as tm

    cfg = _cfg()
    lp_j = jax.tree.map(lambda a: a[0], jax_tree["layers"])
    lp_t = {k: v[0] for k, v in torch_tree["layers"].items()}
    y, aux = jm.moe_block(_cfg(jax_side=True), jnp.asarray(_x(cfg)), lp_j)
    y2, aux2 = tm.moe_block(cfg, torch.from_numpy(_x(cfg)), lp_t)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(aux2), float(aux), rtol=F32_TOL,
                               atol=F32_TOL)


def _tokens():
    return np.random.default_rng(2).integers(0, 256, (2, 16),
                                             dtype=np.int32)


def test_forward_logits_and_aux_match_jax(jax_tree, torch_tree):
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    from ray_tpu_torch.models import mixtral as tm

    logits, aux = jm.forward(_cfg(jax_side=True), jax_tree,
                             jnp.asarray(_tokens()), attn_impl="blockwise",
                             remat=False)
    logits2, aux2 = tm.forward(_cfg(), torch_tree,
                               torch.from_numpy(_tokens()).long(),
                               attn_impl="blockwise", remat=False)
    np.testing.assert_allclose(logits2.detach().numpy(), np.asarray(logits),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(aux2), float(aux), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("remat", [True, False, "attn", "dots", "dots+"])
def test_loss_matches_jax(jax_tree, torch_tree, remat):
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    from ray_tpu_torch.models import mixtral as tm

    tok = _tokens()
    tgt = np.roll(tok, -1, axis=1)
    want = jm.loss_fn(_cfg(jax_side=True), jax_tree, jnp.asarray(tok),
                      jnp.asarray(tgt), attn_impl="blockwise", remat=False)
    got = tm.loss_fn(_cfg(), torch_tree, torch.from_numpy(tok).long(),
                     torch.from_numpy(tgt).long(), attn_impl="blockwise",
                     remat=remat)
    np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL,
                               atol=F32_TOL)


def _jax_step(mesh, cfg, **kw):
    import optax

    from ray_tpu.train.spmd import make_mixtral_train_step

    return make_mixtral_train_step(
        cfg, mesh, optimizer=optax.adamw(LR, eps=ADAM_EPS),
        attn_impl="blockwise", remat=False, **kw)


def _torch_step(mesh, cfg, **kw):
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.spmd import make_mixtral_train_step

    return make_mixtral_train_step(
        cfg, mesh, optimizer=adamw(LR, eps=ADAM_EPS), attn_impl="blockwise",
        remat=False, device="cpu", **kw)


def test_one_device_step_matches_jax(torch_tree):
    import jax

    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    step, init, shard = _jax_step(
        build_mesh(MeshSpec(), jax.devices("cpu")[:1]), _cfg(jax_side=True))
    state, want_l, want_n = _run(step, init(), shard)
    step2, init2, shard2 = _torch_step(None, _cfg())
    state2, got_l, got_n = _run(step2, init2(torch_tree), shard2)
    np.testing.assert_allclose(got_l, want_l, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_n, want_n, rtol=F32_TOL, atol=F32_TOL)
    assert got_l[-1] < got_l[0]
    want_p = _flat(state.params)
    for k, v in _flat(state2.params).items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want_p[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


# -- four ranks -------------------------------------------------------------

def _rank_four(rank, world, store, tmp, port):
    import torch.distributed as dist

    from ray_tpu_torch.models import mixtral as tm
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.param_shard import ParamShard
    from ray_tpu_torch.parallel.sharding import (
        ShardingRules,
        gather_params,
        shard_params,
    )
    from ray_tpu_torch.train.backend import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    tree = _load_tree(os.path.join(tmp, "init.npz"))
    logical = tm.param_logical_axes(_cfg())
    res = {"rank": rank, "cases": {}}
    # The ep4 forward: each rank runs its own experts on every token.
    mesh = build_mesh(MeshSpec(ep=4))
    ps = ParamShard(mesh, logical, ShardingRules(), ("dp", "fsdp", "sp"))
    local = shard_params(tm.params_from_jax(tree, "cpu"), mesh, logical)
    with torch.no_grad():
        logits, aux = tm.forward(_cfg(), local,
                                 torch.from_numpy(_tokens()).long(),
                                 attn_impl="blockwise", remat=False,
                                 param_shard=ps)
    res["ep4_shapes"] = {k: list(v.shape) for k, v in _flat(local).items()}
    res["ep4_aux"] = float(aux)
    if rank == 0:
        np.save(os.path.join(tmp, "ep4_logits.npy"), logits.numpy())
    for name, (axes, capacity, kw) in CASES.items():
        mesh = build_mesh(MeshSpec(**axes))
        step, init_state, shard = _torch_step(mesh, _cfg(capacity), **kw)
        state, losses, norms = _run(
            step, init_state(tm.params_from_jax(tree, "cpu")), shard)
        full = gather_params(state.params, mesh, logical)
        if rank == 0:
            _save_tree(os.path.join(tmp, f"params_{name}.npz"), full)
        res["cases"][name] = {
            "losses": losses, "norms": norms,
            "shapes": {k: list(v.shape)
                       for k, v in _flat(state.params).items()}}
    res["jax_loaded"] = [m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")]
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(os.path.join(tmp, "four.json"), "w") as f:
            json.dump(gathered, f)
    dist.destroy_process_group()


def _jax_references(jax_tree) -> dict:
    """JAX's ep4 forward and its step in every case on 4 CPU devices."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.parallel.sharding import ShardingRules, tree_shardings

    devs = jax.devices("cpu")[:4]
    cfg = _cfg(jax_side=True)
    mesh = build_mesh(MeshSpec(ep=4), devs)
    sh = tree_shardings(mesh, jm.param_logical_axes(cfg), ShardingRules())
    logits, aux = jax.jit(lambda p, t: jm.forward(
        cfg, p, t, attn_impl="blockwise", remat=False))(
        jax.tree.map(jax.device_put, jax_tree, sh), jnp.asarray(_tokens()))
    out = {"ep4": {"logits": np.asarray(logits), "aux": float(aux)}}
    for name, (axes, capacity, kw) in CASES.items():
        mesh = build_mesh(MeshSpec(**axes), devs)
        step, init, shard = _jax_step(mesh, _cfg(capacity, jax_side=True),
                                      **kw)
        state = _jax_init(init, mesh)
        shapes = {}
        for k, v in _flat(state.params).items():
            for s in v.addressable_shards:
                shapes.setdefault(s.device.id, {})[k] = list(s.data.shape)
        state, losses, norms = _run(step, state, shard)
        out[name] = {"losses": losses, "norms": norms, "shapes": shapes,
                     "params": {k: np.asarray(v) for k, v in
                                _flat(state.params).items()}}
    return out


@pytest.fixture(scope="module")
def runs(jax_tree):
    from ray_tpu_torch.train.backend import free_port

    want = _jax_references(jax_tree)
    with tempfile.TemporaryDirectory() as tmp:
        _save_tree(os.path.join(tmp, "init.npz"), jax_tree)
        sub = os.path.join(tmp, "four")
        os.makedirs(sub)
        run_ranks(_rank_four, 4, sub, (tmp, free_port()), RANK_TIMEOUT_S)
        with open(os.path.join(tmp, "four.json")) as f:
            four = json.load(f)
        params = {n: _flat(_load_tree(os.path.join(tmp, f"params_{n}.npz")))
                  for n in CASES}
        ep4_logits = np.load(os.path.join(tmp, "ep4_logits.npy"))
    return {"want": want, "four": four, "params": params,
            "ep4_logits": ep4_logits}


def test_ranks_import_no_jax(runs):
    assert all(r["jax_loaded"] == [] for r in runs["four"])


def test_expert_parallel_forward_matches_jax(runs):
    want = runs["want"]["ep4"]
    np.testing.assert_allclose(runs["ep4_logits"], want["logits"],
                               rtol=F32_TOL, atol=F32_TOL)
    for r in runs["four"]:
        np.testing.assert_allclose(r["ep4_aux"], want["aux"], rtol=F32_TOL,
                                   atol=F32_TOL)
        # each rank holds one of the 4 experts (tiny has 4)
        assert r["ep4_shapes"]["layers/we_gate"] == [2, 1, 64, 128]


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax_on_the_same_mesh(runs, name):
    got, want = runs["four"][0]["cases"][name], runs["want"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=F32_TOL,
                               atol=F32_TOL)
    for r in runs["four"][1:]:
        assert r["cases"][name]["losses"] == got["losses"]
        assert r["cases"][name]["norms"] == got["norms"]


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_params_after_three_steps_match_jax(runs, name):
    got, want = runs["params"][name], runs["want"][name]["params"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_jaxs_addressable_shard_shapes(runs, name):
    for r in runs["four"]:
        assert r["cases"][name]["shapes"] == \
            runs["want"][name]["shapes"][r["rank"]], r["rank"]


def test_expert_leaves_split_over_ep_fsdp_and_tp(runs):
    """we_gate [L, E, H, I] is P(None, ep, fsdp, tp): tiny's 4 experts,
    hidden 64 and MLP 128 halve on their axes."""
    assert runs["four"][0]["cases"]["ep2tp2"]["shapes"][
        "layers/we_gate"] == [2, 2, 64, 64]
    assert runs["four"][0]["cases"]["dp2fsdp2"]["shapes"][
        "layers/we_down"] == [2, 4, 128, 32]


def test_routing_each_ranks_tokens_apart_is_not_jaxs_loss(runs,
                                                          torch_tree):
    """At capacity factor 0.5 the dp2 ranks' own capacity, slots and aux
    statistics give another loss than JAX's global routing (which the
    port's step matches, above): the mean of the two halves' one-device
    losses is far from JAX's first loss."""
    from ray_tpu_torch.models import mixtral as tm

    tok, tgt = _batch()
    halves = [float(tm.loss_fn(
        _cfg(0.5), torch_tree, torch.from_numpy(tok[r]).long(),
        torch.from_numpy(tgt[r]).long(), attn_impl="blockwise", remat=False))
        for r in (slice(0, 4), slice(4, 8))]
    want = runs["want"]["dp2ep2_cap05"]["losses"][0]
    assert abs(np.mean(halves) - want) > LOCAL_ROUTING_GAP
    got = runs["four"][0]["cases"]["dp2ep2_cap05"]["losses"][0]
    assert abs(got - want) <= F32_TOL


@pytest.mark.cuda
def test_small_d128_mixtral_step_on_the_card_launches_the_kernels():
    """A small Mixtral with 128-wide heads (bf16) on the card: two steps
    through K1, K2 and K3, the loss finite and falling; the first loss
    (before any update) within 5e-3 and the first grad norm within 5e-2
    (relative) of the same step on the CPU (the kernels' plain twins).
    Later losses are not compared: adam's first update is about lr times
    the sign of each gradient element, so a bf16 gradient near zero that
    rounds the other way on one side moves that element by 2 lr."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.models.mixtral import MixtralConfig, init_params
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops import norms
    from ray_tpu_torch.train.spmd import make_mixtral_train_step

    cfg = MixtralConfig(vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=2,
                        num_kv_heads=1, head_dim=128, num_experts=4,
                        dtype="bfloat16")
    tok = np.random.default_rng(0).integers(0, 512, (2, 128), dtype=np.int32)
    params = init_params(cfg, 0, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        counters = (norms.rms_norm, att.flash_fwd_cuda, att.flash_bwd_cuda)
        for c in counters:
            c.launches = 0
        step, init, shard = make_mixtral_train_step(cfg, device=dev)
        state = init(params)
        out = []
        for _ in range(2):
            state, m = step(state, shard(tok), shard(np.roll(tok, -1, 1)))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = out
        if dev == "cuda":
            assert all(c.launches > 0 for c in counters)
    (l1, n1), (l2, _) = runs["cuda"]
    assert np.isfinite([l1, l2]).all() and l2 < l1
    np.testing.assert_allclose(l1, runs["cpu"][0][0], atol=5e-3)
    np.testing.assert_allclose(n1, runs["cpu"][0][1], rtol=5e-2)
