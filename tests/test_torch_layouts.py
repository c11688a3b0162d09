"""ray_tpu_torch's training step on the mesh layouts beyond the default
rule table, against the JAX package's step on the same mesh, rules and
batch, on the CPU.

The port's ranks are processes (``ray_tpu_torch._spawn.run_ranks``) in a
gloo group on a ``free_port()``; they import torch and the port alone.
JAX runs the references in the test process on 4 of its 8 virtual CPU
devices. One JAX ``init_params`` tree per model starts both sides;
tokens and images come from numpy (``test_torch_param_shard._inputs``,
Mixtral's ``test_torch_moe._batch``).

One group of 4 ranks runs once for the module (a fixture), every case in
it, each 3 steps of the tiny f32 models with ``adamw(1e-2, eps=1e-3)``:

- Llama: context parallelism under FSDP and TP (fsdp2 x sp2, tp2 x sp2)
  and under the default rules on dp2 x sp2 (JAX runs each with the work
  replicated over sp, the port runs the ring over it); ``embed`` over
  (fsdp, tp) on fsdp2 x tp2 (tp then leaves wq's heads and w_gate's mlp
  to embed: those units are gathered and computed whole); the stacked
  ``layers`` dim over pp (an axis whose ranks hold the same rows) in a
  step that is not a pipeline, and over fsdp (a batch axis: the first
  checkpoint's run below); the
  unfused loss (``loss_fn(fused_ce=False)``, the logits gathered over
  tp) on fsdp2 x tp2; the two-slice hybrid (dcn dp, f32 and int8) with
  ``embed`` over (dp, fsdp), across the slices;
- ViT: ``classes`` over tp on dp2 x tp2;
- Mixtral: dp2 x ep2 with the batch over (dp, ep) (each ep rank routes
  its own tokens: the all-to-all dispatch), sp2 x ep2 (the ring, the
  routing in JAX's token order), the two-slice hybrid dp2 x fsdp2 (dcn
  dp: each slice routes its own tokens), and ``forward``'s logits on
  ep2 x tp2 (gathered over tp);
- checkpoints: an FSDP + ZeRO-1 state (dp2 x fsdp2, ``layers`` over
  fsdp) saved after step 1, held against JAX as the cases are, and
  restored into a ZeRO-1 state with replicated params (the DDP rules
  on dp4), by 2 ranks at dp=2 and in the test process with
  ``mesh=None``; a replicated-params ZeRO-1 save (dp4, DDP rules: flat
  moments) restored into fsdp2 x tp2 under ZeRO-1. Each restored
  state steps once, and that step is held against the uninterrupted
  run's second step.

A one-rank group writes an FSDP + ZeRO-1 state through
``AsyncCheckpointWriter`` and steps on from it.

Tolerances as tests/test_torch_param_shard.py states them: losses and
grad norms 1e-5 (rtol and atol), every param leaf after step 3 within
1e-5, int8 losses and grad norms within 1e-4 of JAX's int8 step (its
params are not compared, as in that file: a last-bit difference in a
gradient flips an int8 rounding now and then, and adam turns the flip
into a visible step of a few elements; the f32 run of the same layout
holds every leaf), a restored step within 1e-6 of the uninterrupted one
(loss and every param).
"""

import json
import os
import sys
import tempfile
import threading
from functools import partial

import numpy as np
import pytest
import torch

from ray_tpu_torch._spawn import run_ranks
from test_torch_moe import _batch as _moe_batch
from test_torch_moe import _tokens as _moe_tokens
from test_torch_param_shard import (
    _flat,
    _inputs,
    _jax_init,
    _layout_mesh,
    _load_tree,
    _run,
    _save_tree,
)

RANK_TIMEOUT_S = 300  # ~25 s alone; the ranks share the CPU with JAX
F32_TOL = 1e-5
QUANT_JAX_TOL = 1e-4
RESTORE_TOL = 1e-6
ADAM_EPS = 1e-3
LR = 1e-2
STEPS = 3
DDP = dict(vocab=None, embed=None, mlp=None, heads=None, kv_heads=None)

# name -> (model, mesh axes, hybrid (dcn dp), rule overrides, options)
CASES = {
    "fsdp2sp2": ("llama", dict(fsdp=2, sp=2), False, {}, {}),
    "tp2sp2": ("llama", dict(tp=2, sp=2), False, {}, {}),
    "dp2sp2": ("llama", dict(dp=2, sp=2), False, {}, {}),
    "embed_fsdp_tp": ("llama", dict(fsdp=2, tp=2), False,
                      {"embed": ("fsdp", "tp")}, {}),
    "layers_pp": ("llama", dict(pp=2, fsdp=2), False, {"layers": "pp"}, {}),
    "unfused_fsdp2tp2": ("llama_unfused", dict(fsdp=2, tp=2), False, {}, {}),
    "dcn_embed": ("llama", dict(dp=2, fsdp=2), True,
                  {"embed": ("dp", "fsdp")}, {"dcn_axes": ("dp",)}),
    "dcn_embed_int8": ("llama", dict(dp=2, fsdp=2), True,
                       {"embed": ("dp", "fsdp")},
                       {"dcn_axes": ("dp",), "dcn_quant": "int8"}),
    "vit_classes_tp": ("vit", dict(dp=2, tp=2), False, {"classes": "tp"},
                       {}),
    "moe_batch_ep": ("mixtral", dict(dp=2, ep=2), False,
                     {"batch": ("dp", "ep")}, {}),
    "moe_sp2ep2": ("mixtral", dict(sp=2, ep=2), False, {}, {}),
    "moe_dcn": ("mixtral", dict(dp=2, fsdp=2), True, {},
                {"dcn_axes": ("dp",)}),
}
# The FSDP + ZeRO-1 run that saves after step 1 (also the parity case of
# the stacked ``layers`` dim over fsdp, a batch axis).
SAVE_A = ("llama", dict(dp=2, fsdp=2), False, {"layers": "fsdp"},
          {"zero1": True})
# The replicated-params ZeRO-1 run (flat moments) that saves.
SAVE_B = ("llama", dict(dp=4), False, DDP, {"zero1": True})


def _model_batch(model):
    if model == "mixtral":
        return _moe_batch()
    tokens, images, labels = _inputs()
    if model == "vit":
        return images, labels
    return tokens, np.roll(tokens, -1, axis=1)


def _port_unfused_loss(cfg, p, tokens, targets, param_shard=None):
    from ray_tpu_torch.models.llama import loss_fn

    return loss_fn(cfg, p, tokens, targets, fused_ce=False,
                   attn_impl="blockwise", remat=False,
                   param_shard=param_shard)


def _port_step(model, mesh, over, **kw):
    from ray_tpu_torch.models import mixtral, vit
    from ray_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        param_logical_axes,
    )
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.spmd import (
        make_llama_train_step,
        make_mixtral_train_step,
        make_train_step,
        make_vit_train_step,
    )

    rules = ShardingRules().override(**over)
    opt = optim.adamw(LR, eps=ADAM_EPS)
    if model == "llama":
        return make_llama_train_step(
            LlamaConfig.tiny(), mesh, rules=rules, optimizer=opt,
            attn_impl="blockwise", device="cpu", **{"remat": False, **kw})
    if model == "llama_unfused":
        cfg = LlamaConfig.tiny()
        return make_train_step(
            mesh, loss=partial(_port_unfused_loss, cfg),
            init_fn=partial(init_params, cfg, device="cpu"),
            logical_axes=param_logical_axes(cfg), rules=rules,
            optimizer=opt, device="cpu", **kw)
    if model == "vit":
        return make_vit_train_step(vit.ViTConfig.tiny(), mesh, rules=rules,
                                   optimizer=opt, attn_impl="xla",
                                   device="cpu", **kw)
    return make_mixtral_train_step(
        mixtral.MixtralConfig.tiny(), mesh, rules=rules, optimizer=opt,
        attn_impl="blockwise", remat=False, device="cpu", **kw)


def _logical(model):
    from ray_tpu_torch.models import mixtral, vit
    from ray_tpu_torch.models.llama import LlamaConfig, param_logical_axes

    if model == "vit":
        return vit.param_logical_axes(vit.ViTConfig.tiny())
    if model == "mixtral":
        return mixtral.param_logical_axes(mixtral.MixtralConfig.tiny())
    return param_logical_axes(LlamaConfig.tiny())


def _tree_name(model):
    return "llama" if model.startswith("llama") else model


def _mesh(axes, hybrid):
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh

    if hybrid:
        return hybrid_mesh(MeshSpec(**axes, dcn_axes=("dp",)), 2, 2)
    return build_mesh(MeshSpec(**axes))


def _fresh(case, init):
    """A case's (step, state, shard, mesh) from the init tree."""
    from ray_tpu_torch.models.llama import params_from_jax

    model, axes, hybrid, over, kw = case
    mesh = _mesh(axes, hybrid)
    step, init_state, shard = _port_step(model, mesh, over, **kw)
    return step, init_state(params_from_jax(init[_tree_name(model)],
                                            "cpu")), shard, mesh


def _save_params(tmp, name, params, mesh, case, rank):
    """Rank 0 writes ``case``'s params gathered whole."""
    from ray_tpu_torch.parallel.sharding import ShardingRules, gather_params

    full = gather_params(params, mesh, _logical(case[0]),
                         ShardingRules().override(**case[3]))
    if rank == 0:
        _save_tree(os.path.join(tmp, f"params_{name}.npz"), full)


def _saving_run(tmp, case, init, tag, rank):
    """Step 1, save, steps 2 and 3; the losses, and the params after
    step 2 for the restores."""
    from ray_tpu_torch.train.checkpoint import save_pytree

    step, state, shard, mesh = _fresh(case, init)
    x, y = _model_batch(case[0])
    state, l1, n1 = _run(step, state, shard, x, y, 1)
    save_pytree(state.checkpoint_tree(), os.path.join(tmp, f"ckpt_{tag}"),
                step=1)
    state, l2, n2 = _run(step, state, shard, x, y, 1)
    _save_params(tmp, f"after2_{tag}", state.params, mesh, case, rank)
    state, l3, n3 = _run(step, state, shard, x, y, 1)
    _save_params(tmp, f"save_{tag}", state.params, mesh, case, rank)
    return {"losses": l1 + l2 + l3, "norms": n1 + n2 + n3}


def _restored_step(tmp, case, init, tag, name, rank):
    """``case``'s state restored from checkpoint ``tag``, one step."""
    from ray_tpu_torch.train.checkpoint import restore_pytree

    step, state, shard, mesh = _fresh(case, init)
    restore_pytree(os.path.join(tmp, f"ckpt_{tag}"), state.checkpoint_tree())
    state, losses, _ = _run(step, state, shard, *_model_batch(case[0]), 1)
    _save_params(tmp, name, state.params, mesh, case, rank)
    return {"loss": losses[0], "step": int(state.step)}


def _jax_free():
    return [m for m in sys.modules if m == "jax" or m.startswith("jax.")]


def _inits(tmp):
    return {m: _load_tree(os.path.join(tmp, f"{m}.npz"))
            for m in ("llama", "vit", "mixtral")}


def _rank_four(rank, world, store, tmp, port):
    import torch.distributed as dist

    from ray_tpu_torch.models import mixtral as tm
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.param_shard import ParamShard
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_params
    from ray_tpu_torch.train.backend import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    init = _inits(tmp)
    res = {"rank": rank, "cases": {}}
    for name, case in CASES.items():
        step, state, shard, mesh = _fresh(case, init)
        state, losses, norms = _run(step, state, shard,
                                      *_model_batch(case[0]), STEPS)
        _save_params(tmp, name, state.params, mesh, case, rank)
        res["cases"][name] = {"losses": losses, "norms": norms}
    res["save_a"] = _saving_run(tmp, SAVE_A, init, "a", rank)
    res["save_b"] = _saving_run(tmp, SAVE_B, init, "b", rank)
    # across formats: the sharded save into replicated ZeRO-1, and the
    # replicated ZeRO-1 save into fsdp2 x tp2 under ZeRO-1
    res["a_into_ddp"] = _restored_step(tmp, SAVE_B, init, "a",
                                       "a_into_ddp", rank)
    res["b_into_fsdp_tp"] = _restored_step(
        tmp, ("llama", dict(fsdp=2, tp=2), False, {}, {"zero1": True}),
        init, "b", "b_into_fsdp_tp", rank)
    # Mixtral's forward logits under tp (ep2 x tp2, the default rules)
    cfg = tm.MixtralConfig.tiny()
    mesh = build_mesh(MeshSpec(ep=2, tp=2))
    ps = ParamShard(mesh, _logical("mixtral"), ShardingRules(),
                    ("dp", "fsdp", "sp"))
    local = shard_params(tm.params_from_jax(init["mixtral"], "cpu"), mesh,
                         _logical("mixtral"))
    with torch.no_grad():
        logits, aux = tm.forward(cfg, local,
                                 torch.from_numpy(_moe_tokens()).long(),
                                 attn_impl="blockwise", remat=False,
                                 param_shard=ps)
    res["tp_aux"] = float(aux)
    if rank == 0:
        np.save(os.path.join(tmp, "tp_logits.npy"), logits.numpy())
    res["jax_loaded"] = _jax_free()
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(os.path.join(tmp, "four.json"), "w") as f:
            json.dump(gathered, f)
    dist.destroy_process_group()


def _rank_two(rank, world, store, tmp, port):
    """Checkpoint a restored at dp=2 (default rules, ZeRO-1), one step."""
    import torch.distributed as dist

    from ray_tpu_torch.train.backend import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    out = _restored_step(tmp, ("llama", dict(dp=2), False, {},
                               {"zero1": True}), _inits(tmp), "a",
                         "a_at_dp2", rank)
    if rank == 0:
        with open(os.path.join(tmp, "two.json"), "w") as f:
            json.dump({**out, "jax_loaded": _jax_free()}, f)
    dist.destroy_process_group()


def _rank_one(rank, world, store, tmp, port):
    """A one-rank FSDP + ZeRO-1 state through the write-behind writer:
    step 1, write, step 2; then a fresh state restored from the write,
    step 2 again."""
    import torch.distributed as dist

    from ray_tpu_torch.train.backend import init_distributed
    from ray_tpu_torch.train.checkpoint import (
        AsyncCheckpointWriter,
        restore_pytree,
    )

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    case = ("llama", dict(fsdp=1), False, {}, {"zero1": True})
    init = _inits(tmp)
    step, state, shard, _ = _fresh(case, init)
    x, y = _model_batch("llama")
    state, _, _ = _run(step, state, shard, x, y, 1)
    writer = AsyncCheckpointWriter()
    writer.save(state.checkpoint_tree(), os.path.join(tmp, "async"), step=1)
    writer.wait()
    state, want, _ = _run(step, state, shard, x, y, 1)
    step, state2, shard, _ = _fresh(case, init)
    restore_pytree(os.path.join(tmp, "async"), state2.checkpoint_tree())
    state2, got, _ = _run(step, state2, shard, x, y, 1)
    same = all(torch.equal(a, b) for a, b in zip(
        _flat(state.params).values(), _flat(state2.params).values()))
    with open(os.path.join(tmp, "one.json"), "w") as f:
        json.dump({"want": want, "got": got, "params_equal": same,
                   "completed": writer.completed()}, f)
    dist.destroy_process_group()


def _jax_step(model, mesh, over, kw):
    import optax

    from ray_tpu.models import llama as jl
    from ray_tpu.models import vit as jv
    from ray_tpu.parallel.sharding import ShardingRules
    from ray_tpu.train.spmd import (
        make_llama_train_step,
        make_mixtral_train_step,
        make_train_step,
        make_vit_train_step,
    )

    rules = ShardingRules().override(**over)
    opt = optax.adamw(LR, eps=ADAM_EPS)
    if model == "llama":
        return make_llama_train_step(
            jl.LlamaConfig.tiny(), mesh, rules=rules, optimizer=opt,
            attn_impl="blockwise", **{"remat": False, **kw})
    if model == "llama_unfused":
        cfg = jl.LlamaConfig.tiny()
        return make_train_step(
            mesh, loss=lambda p, t, y: jl.loss_fn(
                cfg, p, t, y, fused_ce=False, attn_impl="blockwise",
                remat=False),
            init_fn=partial(jl.init_params, cfg),
            logical_axes=jl.param_logical_axes(cfg), rules=rules,
            optimizer=opt, **kw)
    if model == "vit":
        return make_vit_train_step(jv.ViTConfig.tiny(), mesh, rules=rules,
                                   optimizer=opt, attn_impl="xla", **kw)
    from ray_tpu.models.mixtral import MixtralConfig

    return make_mixtral_train_step(MixtralConfig.tiny(), mesh, rules=rules,
                                   optimizer=opt, attn_impl="blockwise",
                                   remat=False, **kw)


def _jax_mesh(axes, hybrid):
    import jax

    from ray_tpu.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh

    devs = jax.devices("cpu")[:4]
    if hybrid:
        return hybrid_mesh(MeshSpec(**axes, dcn_axes=("dp",)), 2, 2,
                           devices=devs)
    return build_mesh(MeshSpec(**axes), devs)


def _write_inits(tmp) -> None:
    """Each model's JAX ``init_params`` tree at seed 0, which both sides
    start from: the bits of every step factory's ``init()`` on any mesh
    (its init is the same function under a sharded jit)."""
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu.models import mixtral as jm
    from ray_tpu.models import vit as jv

    for name, (mod, cfg) in {"llama": (jl, jl.LlamaConfig.tiny()),
                             "vit": (jv, jv.ViTConfig.tiny()),
                             "mixtral": (jm, jm.MixtralConfig.tiny())}.items():
        _save_tree(os.path.join(tmp, f"{name}.npz"), jax.jit(
            partial(mod.init_params, cfg))(jax.random.PRNGKey(0)))


def _jax_references(tmp) -> dict:
    """JAX's step in every case (3 steps), from the trees
    ``_write_inits`` wrote (its init gives the same tree on every mesh);
    JAX's Mixtral forward logits on ep2 x tp2."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.parallel.sharding import ShardingRules, tree_shardings

    devs = jax.devices("cpu")[:4]
    out = {}
    for name, (model, axes, hybrid, over, kw) in {**CASES,
                                                  "save_a": SAVE_A}.items():
        mesh = _jax_mesh(axes, hybrid)
        step, init, shard = _jax_step(model, mesh, over, kw)
        state = _jax_init(init, mesh)  # one compile of the step a case
        x, y = _model_batch(model)
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, shard(x), shard(y))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms,
                     "params": {k: np.asarray(v) for k, v in
                                _flat(state.params).items()}}
    cfg = jm.MixtralConfig.tiny()
    mesh = build_mesh(MeshSpec(ep=2, tp=2), devs)
    tree = _load_tree(os.path.join(tmp, "mixtral.npz"))
    sh = tree_shardings(mesh, jm.param_logical_axes(cfg), ShardingRules())
    logits, aux = jax.jit(lambda p, t: jm.forward(
        cfg, p, t, attn_impl="blockwise", remat=False))(
        jax.tree.map(jax.device_put, tree, sh), jnp.asarray(_moe_tokens()))
    out["tp_forward"] = {"logits": np.asarray(logits), "aux": float(aux)}
    return out


def _restore_at_one(tmp) -> dict:
    """Checkpoint a restored with mesh=None, one step."""
    from ray_tpu_torch.train.checkpoint import restore_pytree

    step, init_state, shard = _port_step("llama", None, {})
    from ray_tpu_torch.models.llama import params_from_jax

    state = init_state(params_from_jax(_inits(tmp)["llama"], "cpu"))
    restore_pytree(os.path.join(tmp, "ckpt_a"), state.checkpoint_tree())
    state, losses, _ = _run(step, state, shard, *_model_batch("llama"), 1)
    return {"loss": losses[0], "step": int(state.step),
            "params": {k: v.detach().numpy()
                       for k, v in _flat(state.params).items()}}


def _port_runs(tmp, errors: list) -> None:
    """The groups of 4, 2 and 1 ranks, in turn (a thread's body)."""
    from ray_tpu_torch.train.backend import free_port

    try:
        for target, world, sub in ((_rank_four, 4, "four"),
                                   (_rank_two, 2, "two"),
                                   (_rank_one, 1, "one")):
            os.makedirs(os.path.join(tmp, sub))
            run_ranks(target, world, os.path.join(tmp, sub),
                      (tmp, free_port()), RANK_TIMEOUT_S)
    except BaseException as e:  # noqa: BLE001 - re-raised by the fixture
        errors.append(e)


@pytest.fixture(scope="module")
def runs():
    """The port's ranks run in a thread while JAX computes its references
    in this process, from the same init trees."""
    with tempfile.TemporaryDirectory() as tmp:
        _write_inits(tmp)
        errors: list = []
        ranks = threading.Thread(target=_port_runs, args=(tmp, errors))
        ranks.start()
        try:
            want = _jax_references(tmp)
        finally:
            ranks.join()
        if errors:
            raise errors[0]
        got = {}
        for sub in ("four", "two", "one"):
            with open(os.path.join(tmp, f"{sub}.json")) as f:
                got[sub] = json.load(f)
        names = (*CASES, "save_a", "after2_a", "save_b", "after2_b",
                 "a_into_ddp", "b_into_fsdp_tp", "a_at_dp2")
        params = {n: _flat(_load_tree(os.path.join(tmp, f"params_{n}.npz")))
                  for n in names}
        one = _restore_at_one(tmp)
        tp_logits = np.load(os.path.join(tmp, "tp_logits.npy"))
    return {"want": want, **got, "params": params, "mesh_none": one,
            "tp_logits": tp_logits}


def test_ranks_import_no_jax(runs):
    assert all(r["jax_loaded"] == [] for r in runs["four"])
    assert runs["two"]["jax_loaded"] == []


F32_CASES = [n for n in CASES if "int8" not in n]


def _got(runs, name):
    return (runs["four"][0]["save_a"] if name == "save_a"
            else runs["four"][0]["cases"][name])


@pytest.mark.parametrize("name", F32_CASES + ["save_a"])
def test_losses_and_norms_match_jax_on_the_same_mesh(runs, name):
    got, want = _got(runs, name), runs["want"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=F32_TOL,
                               atol=F32_TOL)
    for r in runs["four"][1:]:  # every rank reports the same numbers
        mine = r["save_a"] if name == "save_a" else r["cases"][name]
        assert mine["losses"] == got["losses"]
        assert mine["norms"] == got["norms"]


def _assert_params(got: dict, want: dict, tol: float) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", F32_CASES + ["save_a"])
def test_gathered_params_after_three_steps_match_jax(runs, name):
    _assert_params(runs["params"][name], runs["want"][name]["params"],
                   F32_TOL)


def test_int8_dcn_stage_with_params_over_the_dcn_axis_matches_jax(runs):
    name = "dcn_embed_int8"
    got, want = runs["four"][0]["cases"][name], runs["want"][name]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=QUANT_JAX_TOL, atol=QUANT_JAX_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"],
                               rtol=QUANT_JAX_TOL, atol=QUANT_JAX_TOL)
    flat = runs["four"][0]["cases"]["dcn_embed"]["losses"]
    assert got["losses"][1] != flat[1]  # visibly quantized


def test_mixtral_forward_logits_under_tp_match_jax(runs):
    want = runs["want"]["tp_forward"]
    np.testing.assert_allclose(runs["tp_logits"], want["logits"],
                               rtol=F32_TOL, atol=F32_TOL)
    for r in runs["four"]:
        np.testing.assert_allclose(r["tp_aux"], want["aux"], rtol=F32_TOL,
                                   atol=F32_TOL)


def _restored(runs, where):
    if where == "dp2":
        return runs["two"]["loss"], runs["two"]["step"], \
            runs["params"]["a_at_dp2"]
    if where == "mesh_none":
        one = runs["mesh_none"]
        return one["loss"], one["step"], one["params"]
    r = runs["four"][0][where]
    return r["loss"], r["step"], runs["params"][where]


@pytest.mark.parametrize("where,saved", [
    ("dp2", "a"), ("mesh_none", "a"), ("a_into_ddp", "a"),
    ("b_into_fsdp_tp", "b")])
def test_restored_state_steps_as_the_uninterrupted_run(runs, where, saved):
    """An FSDP + ZeRO-1 save restored at dp=2, with no mesh and into
    replicated ZeRO-1; a replicated ZeRO-1 save into fsdp2 x tp2 ZeRO-1:
    the step after each restore is the uninterrupted run's second."""
    loss, step, params = _restored(runs, where)
    assert step == 2
    np.testing.assert_allclose(
        loss, runs["four"][0][f"save_{saved}"]["losses"][1],
        rtol=RESTORE_TOL, atol=RESTORE_TOL)
    _assert_params(params, runs["params"][f"after2_{saved}"], RESTORE_TOL)


def test_write_behind_takes_a_one_rank_fsdp_zero1_state(runs):
    one = runs["one"]
    assert one["completed"] and one["got"] == one["want"]
    assert one["params_equal"]


def test_check_layout_raises_only_where_jax_does():
    """Every rule table trains; a spec naming an axis the mesh lacks is
    the ValueError left (JAX's NamedSharding refuses it too)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from ray_tpu.parallel.mesh import MeshSpec as JaxSpec
    from ray_tpu.parallel.mesh import build_mesh as jax_mesh
    from ray_tpu_torch.models.llama import LlamaConfig, param_logical_axes
    from ray_tpu_torch.parallel.param_shard import check_layout
    from ray_tpu_torch.parallel.sharding import ShardingRules, axis_sizes

    sizes = axis_sizes(_layout_mesh(tp=2, pp=2, ep=2))
    logical = param_logical_axes(LlamaConfig.tiny())
    for over in ({"embed": "tp"}, {"layers": "pp"}, {"mlp": "ep"},
                 {"heads": ("tp", "ep")}, {"batch": ("dp", "ep")}):
        check_layout(sizes, logical, ShardingRules().override(**over))
    with pytest.raises(ValueError):
        NamedSharding(jax_mesh(JaxSpec(), jax.devices("cpu")[:1]),
                      PartitionSpec("xp"))
    with pytest.raises(ValueError, match="not in the mesh"):
        check_layout(sizes, logical, ShardingRules().override(embed="xp"))


@pytest.mark.parametrize("over,units", [
    ({}, ({"attn": True, "mlp": True, "vocab": True}, True)),
    ({"embed": ("fsdp", "tp")},
     ({"attn": False, "mlp": False, "vocab": False}, True)),
    ({"batch": ("dp", "tp")},
     ({"attn": False, "mlp": False, "vocab": False}, True)),
    ({"expert": None, "mlp": "ep"},
     ({"attn": True, "mlp": False, "vocab": True}, False))])
def test_local_units_follow_the_rules(over, units):
    """A unit is computed locally only where the rules split each dim it
    names over its axis alone (Mixtral tiny's table)."""
    from ray_tpu_torch.models.mixtral import param_logical_axes
    from ray_tpu_torch.models.mixtral import MixtralConfig
    from ray_tpu_torch.parallel.param_shard import check_layout, local_units
    from ray_tpu_torch.parallel.sharding import (
        ShardingRules,
        axis_sizes,
        batch_axes,
    )

    rules = ShardingRules().override(**over)
    logical = param_logical_axes(MixtralConfig.tiny())
    layout = check_layout(axis_sizes(_layout_mesh(tp=2, ep=2)), logical,
                          rules)
    assert local_units(layout, logical, batch_axes(rules) + ("sp",)) == \
        units


# -- on the card ------------------------------------------------------------

def _cuda_rank(rank, world, store, out, port, path):
    """One new path on a one-rank NCCL mesh against mesh=None on the
    card: the first loss bit-equal (one-rank collectives add zeros)."""
    from ray_tpu_torch.train.backend import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.models.mixtral import MixtralConfig
    from ray_tpu_torch.models.mixtral import init_params as moe_init
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.train.checkpoint import restore_pytree, save_pytree

    kw = dict(attn_impl="flash", remat="attn+", device="cuda")
    rng = np.random.default_rng(0)
    if path == "mixtral_batch_ep":
        cfg = MixtralConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=2, num_kv_heads=1, head_dim=128,
                            num_experts=4, dtype="bfloat16")
        params = moe_init(cfg, 0, device="cuda")
        make = partial(spmd.make_mixtral_train_step, cfg, **kw)
        rules = ShardingRules().override(batch=("dp", "ep"))
    else:
        cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=4,
                          num_kv_heads=2, head_dim=64, dtype="bfloat16")
        params = init_params(cfg, 0, device="cuda")
        make = partial(spmd.make_llama_train_step, cfg, **kw)
        rules = ShardingRules().override(
            **({"embed": "tp", "layers": "pp"} if path == "gathers"
               else {}))
    tok = rng.integers(0, cfg.vocab_size, (2, 256), dtype=np.int32)
    tgt = np.roll(tok, -1, 1)
    step, init, shard = make()
    base = float(step(init(params), shard(tok), shard(tgt))[1]["loss"])
    mesh = build_mesh(MeshSpec())
    opts = {"zero1": True} if path == "zero1_ckpt" else {}
    step, init, shard = make(mesh, rules=rules, **opts)
    state, m = step(init(params), shard(tok), shard(tgt))
    got = float(m["loss"])
    resumed = None
    if path == "zero1_ckpt":
        save_pytree(state.checkpoint_tree(), os.path.join(out, "ckpt"))
        want = float(step(state, shard(tok), shard(tgt))[1]["loss"])
        state = init(params)
        restore_pytree(os.path.join(out, "ckpt"), state.checkpoint_tree())
        resumed = [want, float(step(state, shard(tok), shard(tgt))[1]
                               ["loss"])]
    with open(os.path.join(out, "out.json"), "w") as f:
        json.dump({"base": base, "got": got, "resumed": resumed}, f)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["gathers", "zero1_ckpt",
                                  "mixtral_batch_ep"])
def test_one_rank_layout_on_the_card_is_mesh_none_bits(path):
    """Item 1's gathers (embed on tp, layers on pp), FSDP + ZeRO-1 saved
    and resumed, and Mixtral with the batch over ep, each on a one-rank
    NCCL mesh through the card's kernels: the first loss bit-equal to
    mesh=None's; the resumed step bit-equal to the uninterrupted one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.train.backend import free_port

    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(_cuda_rank, 1, tmp, (tmp, free_port(), path),
                  RANK_TIMEOUT_S)
        with open(os.path.join(tmp, "out.json")) as f:
            got = json.load(f)
    assert got["got"] == got["base"]
    if got["resumed"] is not None:
        assert got["resumed"][0] == got["resumed"][1]
