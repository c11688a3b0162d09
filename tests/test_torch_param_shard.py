"""ray_tpu_torch's training step with FSDP and tensor-parallel param
sharding (the default rule table) over 4 gloo ranks, against the JAX
package's step over a mesh of 4 devices, on the CPU.

The port's ranks are processes (``ray_tpu_torch._spawn.run_ranks``, spawn
start method) that meet in a gloo group on a ``free_port()``; they import
torch and the port alone (each checks that no JAX module was loaded). JAX
runs the references in the test process on its virtual CPU devices. One
JAX ``init_params`` tree per model, written to a file, starts both
sides; tokens and images come from numpy.

One group of 4 ranks runs once for the module (a fixture), every case in
it, within ``RANK_TIMEOUT_S``: Llama tiny f32 with the default rules and
``adamw(1e-2, eps=1e-3)``, 3 steps, on dp2 x fsdp2 (flat, zero1, zero1 +
grad_accum 2), on the two-slice hybrid dp2 x fsdp2 (dcn dp, int8), on
fsdp2 x tp2 (also under remat attn+, whose recompute gathers again) and
on dp2 x tp2; ViT tiny on dp2 x fsdp2 and dp2 x tp2. The
fsdp2 x tp2 run saves a checkpoint after its first step, which a group
of 2 ranks restores at dp=2 and the test process at ``mesh=None``, each
stepping once.

Tolerances (f32): losses and grad norms 1e-5 (rtol and atol), the sums
being reorderings of JAX's; int8 within 1e-4 of JAX's int8 step. Params
after step 3, gathered, against JAX's: within 1e-5 on every element
(rtol and atol). Adam's eps is 1e-3, not optax's 1e-8: with a tiny eps
g / sqrt(v) is about +-1 for any gradient near 0, so a last-bit
difference in such a gradient (a reordered sum) flips a whole step of
lr, and the params would hold the optimizer's sensitivity rather than the
step's sums; eps bounds that gain by 1 / eps.
Each rank's blocks have the shapes of JAX's addressable shards on the
device of the same index. A restored step within 1e-6 (rtol and atol)
of the uninterrupted fsdp2 x tp2 step, loss and every param.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from ray_tpu_torch._spawn import run_ranks

RANK_TIMEOUT_S = 150
F32_TOL = 1e-5
QUANT_JAX_TOL = 1e-4
PARAM_TOL = 1e-5
ADAM_EPS = 1e-3  # see the module docstring
RESTORE_TOL = 1e-6
STEPS = 3

# name -> (model, mesh axes, hybrid (dcn dp), step options)
CASES = {
    "dp2fsdp2": ("llama", dict(dp=2, fsdp=2), False, {}),
    "dp2fsdp2_zero1": ("llama", dict(dp=2, fsdp=2), False, {"zero1": True}),
    "dp2fsdp2_accum": ("llama", dict(dp=2, fsdp=2), False,
                       {"zero1": True, "grad_accum": 2}),
    "dp2fsdp2_dcn_int8": ("llama", dict(dp=2, fsdp=2), True,
                          {"dcn_axes": ("dp",), "dcn_quant": "int8"}),
    "fsdp2tp2": ("llama", dict(fsdp=2, tp=2), False, {}),
    # The gathers inside remat segments, run again by the recompute.
    "fsdp2tp2_remat": ("llama", dict(fsdp=2, tp=2), False,
                       {"remat": "attn+"}),
    "dp2tp2": ("llama", dict(dp=2, tp=2), False, {}),
    "vit_dp2fsdp2": ("vit", dict(dp=2, fsdp=2), False, {}),
    "vit_dp2tp2": ("vit", dict(dp=2, tp=2), False, {}),
}
DDP = dict(vocab=None, embed=None, mlp=None, heads=None, kv_heads=None)


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (16, 16), dtype=np.int32)
    images = rng.uniform(0, 1, (8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    return tokens, images, labels


def _batch(model):
    tokens, images, labels = _inputs()
    if model == "llama":
        return tokens, np.roll(tokens, -1, axis=1)
    return images, labels


def _save_tree(path, tree):
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            elif isinstance(v, torch.Tensor):
                flat[prefix + k] = v.detach().float().numpy()
            else:
                flat[prefix + k] = np.asarray(v, dtype=np.float32)

    walk(tree, "")
    np.savez(path, **flat)


def _load_tree(path):
    z = np.load(path)
    out: dict = {}
    for k in z.files:
        node = out
        *head, last = k.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = z[k]
    return out


def _flat(tree) -> dict:
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out[prefix + k] = v
    walk(tree, "")
    return out


def _jax_init(init, mesh):
    """JAX's ``init()`` with its step counter replicated over ``mesh``, as
    the step returns it: init leaves it on one device, so the second
    step would compile the step again for the returned placement."""
    import dataclasses

    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    state = init()
    return dataclasses.replace(state, step=jax.device_put(
        state.step, NamedSharding(mesh, PartitionSpec())))


def _run(step, state, shard, x, y, steps=STEPS):
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, shard(x), shard(y))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _factory(model, mesh, rules=None, **kw):
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.spmd import (
        make_llama_train_step,
        make_vit_train_step,
    )

    if model == "llama":
        kw.setdefault("remat", False)
        return make_llama_train_step(
            LlamaConfig.tiny(), mesh, rules=rules,
            optimizer=optim.adamw(1e-2, eps=ADAM_EPS), attn_impl="blockwise",
            device="cpu", **kw)
    return make_vit_train_step(vit.ViTConfig.tiny(), mesh, rules=rules,
                               optimizer=optim.adamw(1e-2, eps=ADAM_EPS),
                               attn_impl="xla",
                               device="cpu", **kw)


def _logical(model):
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.models.llama import LlamaConfig, param_logical_axes

    if model == "llama":
        return param_logical_axes(LlamaConfig.tiny())
    return vit.param_logical_axes(vit.ViTConfig.tiny())


def _mesh(axes, hybrid):
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh

    if hybrid:
        return hybrid_mesh(MeshSpec(**axes, dcn_axes=("dp",)), 2, 2)
    return build_mesh(MeshSpec(**axes))


def _rank_four(rank, world, store, tmp, port):
    """Every case on 4 ranks; the fsdp2 x tp2 run checkpoints after its
    first step and tries the write-behind writer."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.parallel.sharding import ShardingRules, gather_params
    from ray_tpu_torch.train.backend import init_distributed
    from ray_tpu_torch.train.checkpoint import (
        AsyncCheckpointWriter,
        save_pytree,
    )

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    init = {m: _load_tree(os.path.join(tmp, f"{m}.npz"))
            for m in ("llama", "vit")}
    res = {"cases": {}}
    for name, (model, axes, hybrid, kw) in CASES.items():
        mesh = _mesh(axes, hybrid)
        step, init_state, shard = _factory(model, mesh, **kw)
        state = init_state(params_from_jax(init[model], "cpu"))
        x, y = _batch(model)
        if name == "fsdp2tp2":
            state, l1, n1 = _run(step, state, shard, x, y, 1)
            save_pytree(state.checkpoint_tree(), os.path.join(tmp, "ckpt"),
                        step=1)
            try:
                AsyncCheckpointWriter().save(state.checkpoint_tree(),
                                             os.path.join(tmp, "async"))
                res["async_refused"] = None
            except RuntimeError as e:
                res["async_refused"] = str(e)
            state, l2, n2 = _run(step, state, shard, x, y, 1)
            full = gather_params(state.params, mesh, _logical(model))
            if rank == 0:
                _save_tree(os.path.join(tmp, "after2.npz"), full)
            state, l3, n3 = _run(step, state, shard, x, y, 1)
            losses, norms = l1 + l2 + l3, n1 + n2 + n3
        else:
            state, losses, norms = _run(step, state, shard, x, y)
        full = gather_params(state.params, mesh, _logical(model))
        if rank == 0:
            _save_tree(os.path.join(tmp, f"params_{name}.npz"), full)
        res["cases"][name] = {
            "losses": losses, "norms": norms,
            "shapes": {k: list(v.shape)
                       for k, v in _flat(state.params).items()}}
    # The data-parallel path with replicated params (rules that shard
    # nothing), for its distance from JAX's params.
    step, init_state, shard = _factory(
        "llama", _mesh(dict(dp=4), False),
        rules=ShardingRules().override(**DDP))
    state, res["ddp_losses"], _ = _run(
        step, init_state(params_from_jax(init["llama"], "cpu")), shard,
        *_batch("llama"))
    if rank == 0:
        _save_tree(os.path.join(tmp, "params_ddp.npz"), state.params)
    res["rank"] = rank
    res["jax_loaded"] = [m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")]
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(os.path.join(tmp, "four.json"), "w") as f:
            json.dump(gathered, f)
    dist.destroy_process_group()


def _rank_two(rank, world, store, tmp, port):
    """The fsdp2 x tp2 checkpoint restored at dp=2 (default rules), one
    step."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.parallel.sharding import gather_params
    from ray_tpu_torch.train.backend import init_distributed
    from ray_tpu_torch.train.checkpoint import restore_pytree

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = _mesh(dict(dp=2), False)
    step, init_state, shard = _factory("llama", mesh)
    state = init_state(params_from_jax(
        _load_tree(os.path.join(tmp, "llama.npz")), "cpu"))
    restore_pytree(os.path.join(tmp, "ckpt"), state.checkpoint_tree())
    state, losses, _ = _run(step, state, shard, *_batch("llama"), 1)
    full = gather_params(state.params, mesh, _logical("llama"))
    if rank == 0:
        _save_tree(os.path.join(tmp, "restored2.npz"), full)
        with open(os.path.join(tmp, "two.json"), "w") as f:
            json.dump({"losses": losses, "step": int(state.step),
                       "jax_loaded": [m for m in sys.modules
                                      if m == "jax" or m.startswith("jax.")]},
                      f)
    dist.destroy_process_group()


def _jax_references(tmp) -> dict:
    """JAX's step in every case; writes the init trees for the ranks and
    JAX's params after step 3 and addressable shard shapes."""
    import jax
    import optax

    from ray_tpu.models import vit as jax_vit
    from ray_tpu.models.llama import LlamaConfig
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh
    from ray_tpu.train.spmd import make_llama_train_step, make_vit_train_step

    devs = jax.devices("cpu")[:4]
    out = {}
    for name, (model, axes, hybrid, kw) in CASES.items():
        mesh = (hybrid_mesh(MeshSpec(**axes, dcn_axes=("dp",)), 2, 2,
                            devices=devs) if hybrid
                else build_mesh(MeshSpec(**axes), devs))
        if model == "llama":
            step, init, shard = make_llama_train_step(
                LlamaConfig.tiny(), mesh,
                optimizer=optax.adamw(1e-2, eps=ADAM_EPS),
                attn_impl="blockwise", **{"remat": False, **kw})
        else:
            step, init, shard = make_vit_train_step(
                jax_vit.ViTConfig.tiny(), mesh,
                optimizer=optax.adamw(1e-2, eps=ADAM_EPS), attn_impl="xla",
                **kw)
        state = _jax_init(init, mesh)
        if not os.path.exists(os.path.join(tmp, f"{model}.npz")):
            _save_tree(os.path.join(tmp, f"{model}.npz"), state.params)
        shapes = {}
        for k, v in _flat(state.params).items():
            for sh in v.addressable_shards:
                shapes.setdefault(str(sh.device.id), {})[k] = list(
                    sh.data.shape)
        x, y = _batch(model)
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, shard(x), shard(y))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms, "shapes": shapes,
                     "params": {k: np.asarray(v) for k, v in
                                _flat(state.params).items()}}
    return out


def _restore_at_one(tmp) -> dict:
    """The fsdp2 x tp2 checkpoint restored with mesh=None, one step."""
    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.train.checkpoint import restore_pytree

    step, init_state, shard = _factory("llama", None)
    state = init_state(params_from_jax(
        _load_tree(os.path.join(tmp, "llama.npz")), "cpu"))
    restore_pytree(os.path.join(tmp, "ckpt"), state.checkpoint_tree())
    state, losses, _ = _run(step, state, shard, *_batch("llama"), 1)
    return {"losses": losses, "step": int(state.step),
            "params": {k: v.detach().numpy()
                       for k, v in _flat(state.params).items()}}


@pytest.fixture(scope="module")
def runs():
    from ray_tpu_torch.train.backend import free_port

    with tempfile.TemporaryDirectory() as tmp:
        want = _jax_references(tmp)
        for sub in ("four", "two"):
            os.makedirs(os.path.join(tmp, sub))
        run_ranks(_rank_four, 4, os.path.join(tmp, "four"),
                  (tmp, free_port()), RANK_TIMEOUT_S)
        run_ranks(_rank_two, 2, os.path.join(tmp, "two"),
                  (tmp, free_port()), RANK_TIMEOUT_S)
        with open(os.path.join(tmp, "four.json")) as f:
            four = json.load(f)
        with open(os.path.join(tmp, "two.json")) as f:
            two = json.load(f)
        params = {name: _flat(_load_tree(os.path.join(
            tmp, f"params_{name}.npz"))) for name in (*CASES, "ddp")}
        one = _restore_at_one(tmp)
        after2 = _flat(_load_tree(os.path.join(tmp, "after2.npz")))
        restored2 = _flat(_load_tree(os.path.join(tmp, "restored2.npz")))
    return {"want": want, "four": four, "two": two, "one": one,
            "params": params, "after2": after2, "restored2": restored2}


def test_ranks_import_no_jax(runs):
    assert all(r["jax_loaded"] == [] for r in runs["four"])
    assert runs["two"]["jax_loaded"] == []


F32_CASES = [n for n in CASES if "int8" not in n]


@pytest.mark.parametrize("name", F32_CASES)
def test_losses_and_norms_match_jax_on_the_same_mesh(runs, name):
    got, want = runs["four"][0]["cases"][name], runs["want"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=F32_TOL,
                               atol=F32_TOL)
    for r in runs["four"][1:]:  # every rank reports the same numbers
        assert r["cases"][name]["losses"] == got["losses"]
        assert r["cases"][name]["norms"] == got["norms"]


def test_int8_dcn_stage_matches_jax_int8(runs):
    name = "dp2fsdp2_dcn_int8"
    got, want = runs["four"][0]["cases"][name], runs["want"][name]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=QUANT_JAX_TOL, atol=QUANT_JAX_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"],
                               rtol=QUANT_JAX_TOL, atol=QUANT_JAX_TOL)
    flat = runs["four"][0]["cases"]["dp2fsdp2"]["losses"]
    assert got["losses"][1] != flat[1]  # visibly quantized


def _assert_params_match(got: dict, want: dict) -> None:
    """Every leaf within PARAM_TOL (rtol and atol) of JAX's."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", F32_CASES)
def test_gathered_params_after_three_steps_match_jax(runs, name):
    _assert_params_match(runs["params"][name], runs["want"][name]["params"])


def test_replicated_params_show_the_same_adam_gap_from_jax(runs):
    """The path with no param sharding is held to the same limits: its
    losses and its params after step 3 within 1e-5 of JAX's."""
    want = runs["want"]["dp2fsdp2"]
    np.testing.assert_allclose(runs["four"][0]["ddp_losses"],
                               want["losses"], rtol=F32_TOL, atol=F32_TOL)
    _assert_params_match(runs["params"]["ddp"], want["params"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_jaxs_addressable_shard_shapes(runs, name):
    for r in runs["four"]:
        assert r["cases"][name]["shapes"] == \
            runs["want"][name]["shapes"][str(r["rank"])], r["rank"]


def test_fsdp_tp_blocks_are_the_rule_tables(runs):
    """wq [L, embed, heads] is P(None, fsdp, tp); embed_tokens P(tp,
    fsdp); lm_head P(fsdp, tp) (Llama tiny: hidden 64, heads 4 x 16,
    vocab 256)."""
    shapes = runs["four"][0]["cases"]["fsdp2tp2"]["shapes"]
    assert shapes["layers/wq"] == [2, 32, 32]
    assert shapes["embed_tokens"] == [128, 32]
    assert shapes["lm_head"] == [32, 128]


def test_write_behind_refuses_a_param_sharded_state(runs):
    msg = runs["four"][0]["async_refused"] or ""
    assert "pieces" in msg and "save_pytree" in msg


@pytest.mark.parametrize("where", ["dp2", "one"])
def test_fsdp_tp_checkpoint_resumes_at_another_mesh(runs, where):
    want_loss = runs["four"][0]["cases"]["fsdp2tp2"]["losses"][1]
    if where == "dp2":
        loss, params, step = (runs["two"]["losses"][0], runs["restored2"],
                              runs["two"]["step"])
    else:
        loss, params, step = (runs["one"]["losses"][0],
                              runs["one"]["params"], runs["one"]["step"])
    assert step == 2
    np.testing.assert_allclose(loss, want_loss, rtol=RESTORE_TOL,
                               atol=RESTORE_TOL)
    for k, v in runs["after2"].items():
        np.testing.assert_allclose(params[k], v, rtol=RESTORE_TOL,
                                   atol=RESTORE_TOL, err_msg=k)


def _layout_mesh(**sizes):
    """A DeviceMesh of these axis sizes with no process group: the
    factory's checks read only its names and sizes."""
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.parallel.mesh import AXIS_ORDER

    shape = [sizes.get(a, 1) for a in AXIS_ORDER]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
        shape), mesh_dim_names=AXIS_ORDER, _init_backend=False, _rank=0)


def test_a_loss_on_whole_params_refuses_param_sharding_rules():
    from ray_tpu_torch.models.llama import LlamaConfig, param_logical_axes
    from ray_tpu_torch.train.spmd import make_train_step

    with pytest.raises(NotImplementedError, match="takes whole params"):
        make_train_step(_layout_mesh(fsdp=2), loss=lambda *a: None,
                        init_fn=lambda seed: None,
                        logical_axes=param_logical_axes(LlamaConfig.tiny()),
                        device="cpu")


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shard_params_cuts_jaxs_device_put_blocks(coords):
    """Each (fsdp, tp) rank's blocks of Llama tiny are the data of JAX's
    addressable shard on the device of that mesh position."""
    import jax

    from ray_tpu.models.llama import LlamaConfig as JaxConfig
    from ray_tpu.models.llama import init_params as jax_init
    from ray_tpu.models.llama import param_logical_axes as jax_axes
    from ray_tpu.parallel.mesh import MeshSpec as JaxSpec
    from ray_tpu.parallel.mesh import build_mesh as jax_mesh
    from ray_tpu.parallel.sharding import shard_params as jax_shard
    from ray_tpu_torch.models.llama import LlamaConfig, param_logical_axes
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    from ray_tpu_torch.parallel.sharding import shard_params

    mesh = jax_mesh(JaxSpec(fsdp=2, tp=2), jax.devices("cpu")[:4])
    tree = jax_init(JaxConfig.tiny(), jax.random.PRNGKey(0))
    sharded = _flat(jax_shard(tree, mesh, jax_axes(JaxConfig.tiny())))
    sizes = {a: {"fsdp": 2, "tp": 2}.get(a, 1) for a in AXIS_ORDER}
    pos = {a: 0 for a in AXIS_ORDER} | dict(zip(("fsdp", "tp"), coords))
    device = mesh.devices[tuple(pos[a] for a in mesh.axis_names)]
    mine = _flat(shard_params(_as_torch(tree), (sizes, pos),
                              param_logical_axes(LlamaConfig.tiny())))
    for k, v in sharded.items():
        want = next(s.data for s in v.addressable_shards
                    if s.device == device)
        assert torch.equal(mine[k], torch.from_numpy(np.asarray(want))), k


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_shard_params_refuses_a_dim_its_axes_do_not_divide_as_jax_does():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from ray_tpu.parallel.mesh import MeshSpec as JaxSpec
    from ray_tpu.parallel.mesh import build_mesh as jax_mesh
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    from ray_tpu_torch.parallel.sharding import shard_params

    mesh = jax_mesh(JaxSpec(fsdp=2), jax.devices("cpu")[:2])
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(np.zeros((3, 4), np.float32),
                       NamedSharding(mesh, PartitionSpec("fsdp")))
    sizes = {a: 2 if a == "fsdp" else 1 for a in AXIS_ORDER}
    pos = dict.fromkeys(AXIS_ORDER, 0)
    with pytest.raises(ValueError, match="w: .* does not divide 3"):
        shard_params({"w": torch.zeros(3, 4)}, (sizes, pos), {"w": ("embed",
                                                                    None)})


def _rank_one(rank, world, store, out_path, port):
    """Llama tiny's loss and gradients on a one-rank mesh under the
    default rules (every collective on a one-rank group) and with whole
    params on no mesh."""
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        loss_fn,
        param_logical_axes,
    )
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.param_shard import ParamShard
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_params
    from ray_tpu_torch.train.backend import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
    cfg = LlamaConfig.tiny()
    mesh = build_mesh(MeshSpec())
    logical = param_logical_axes(cfg)
    ps = ParamShard(mesh, logical, ShardingRules(), ("dp", "fsdp", "sp"))
    tokens = torch.from_numpy(_inputs()[0]).long()
    targets = tokens.roll(-1, 1)
    out = {}
    for name, shard in (("whole", None), ("one_rank", ps)):
        params = init_params(cfg, generator=0, device="cpu")
        if shard is not None:
            params = shard_params(params, mesh, logical)
        params = {k: (v.requires_grad_() if not isinstance(v, dict) else
                      {kk: vv.requires_grad_() for kk, vv in v.items()})
                  for k, v in params.items()}
        loss = loss_fn(cfg, params, tokens, targets, attn_impl="blockwise",
                       remat="attn+", param_shard=shard)
        loss.backward()
        out[name] = [loss.item()] + [p.grad.flatten().tolist()
                                     for p in tree_leaves(params)]
    with open(out_path, "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def test_one_rank_mesh_gives_the_whole_params_bits():
    """The FSDP gathers, tp conjugates, vocabulary-parallel embedding and
    loss on one-rank groups change no bit of the loss or of any gradient
    (phase 13's (f) and (g) on the card rely on it)."""
    from ray_tpu_torch.train.backend import free_port

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "one.json")
        run_ranks(_rank_one, 1, tmp, (out, free_port()), RANK_TIMEOUT_S)
        with open(out) as f:
            got = json.load(f)
    assert got["one_rank"] == got["whole"]
