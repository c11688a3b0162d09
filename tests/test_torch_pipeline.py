"""ray_tpu_torch's GPipe step (``parallel.pipeline.make_pp_train_step``)
over gloo ranks, against the JAX package's ``make_pp_train_step`` on a
mesh of as many CPU devices, and against the one-device step.

The port's ranks are processes (``ray_tpu_torch._spawn.run_ranks``) that
meet on a ``free_port()`` and import torch and the port alone (each
checks that no JAX module was loaded). One group of 4 ranks runs the
4-rank cases, one group of 2 the pp2 case, once for the module (a
fixture). JAX's ``init_params`` tree of each case, written to a file,
starts both sides; tokens come from numpy.

Cases (f32, ``sgd(0.1)`` as JAX's own pipeline tests use, blockwise
attention, 3 steps): Llama tiny (2 layers) with tied embeddings (the
lookup's gradient on stage 0, the head's on the last) on pp2 x dp2 with
2 microbatches and on pp2 with 4; tiny's own untied head at 4 layers on
pp4 with 2; the tied model on pp2 x {fsdp2, tp2, sp2, ep2} with 2 (JAX's
shard_map replicates the pipeline over the other axis: each coordinate
of it is a replica pipeline, and the ranks along it must agree bit for
bit).
Losses, grad norms and the params after step 3 (each stage's rows
gathered over pp) within 1e-5 (rtol and atol) of JAX's; the losses
within 1e-5 of the port's one-device step (``make_llama_train_step``,
``mesh=None``, the same optimizer). Each rank's layer rows are JAX's
addressable shard on the device of its mesh position. The pp2 x dp2
state, saved after step 1, restores at ``mesh=None`` and steps on to
the pipeline's step-2 loss within 1e-6.
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
from test_torch_param_shard import (
    _flat,
    _jax_init,
    _layout_mesh,
    _load_tree,
    _save_tree,
)

RANK_TIMEOUT_S = 120
F32_TOL = 1e-5
RESTORE_TOL = 1e-6
STEPS = 3
LR = 0.1

# name -> (config variant, mesh axes, microbatches, world)
CASES = {
    "pp2dp2_m2": ("tied", dict(pp=2, dp=2), 2, 4),
    "pp2_m4": ("tied", dict(pp=2), 4, 2),
    "pp4_untied_m2": ("untied4", dict(pp=4), 2, 4),
    **{f"pp2{a}2_m2": ("tied", {"pp": 2, a: 2}, 2, 4)
       for a in ("fsdp", "tp", "sp", "ep")},
}


def _cfg(variant, jax_side=False):
    if jax_side:
        from ray_tpu.models.llama import LlamaConfig
    else:
        from ray_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.tiny()  # untied
    if variant == "tied":
        return replace(cfg, tie_embeddings=True)
    return replace(cfg, num_layers=4)


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


def _gather_stages(params, mesh):
    """Every stage's layer rows, all-gathered over pp in stage order."""
    import torch.distributed as dist

    group = mesh.get_group("pp")
    n = dist.get_world_size(group)

    def whole(t):
        out = t.new_empty((n * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t.detach().contiguous(),
                                    group=group)
        return out

    return {k: ({n_: whole(v_) for n_, v_ in v.items()} if k == "layers"
                else v.detach()) for k, v in params.items()}


def _rank_main(rank, world, store, tmp, port, names):
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step
    from ray_tpu_torch.train.backend import init_distributed
    from ray_tpu_torch.train.checkpoint import save_pytree
    from ray_tpu_torch.train.optim import sgd

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {"rank": rank, "cases": {}}
    for name in names:
        variant, axes, m, _ = CASES[name]
        mesh = build_mesh(MeshSpec(**axes))
        step, init_state, shard = make_pp_train_step(
            _cfg(variant), mesh, m, optimizer=sgd(LR), device="cpu")
        state = init_state(params_from_jax(
            _load_tree(os.path.join(tmp, f"{name}.npz")), "cpu"))
        _save_tree(os.path.join(tmp, f"rows_{name}_{rank}.npz"),
                   state.params)
        if name == "pp2dp2_m2":  # save after step 1, then go on
            state, l1, n1 = _run(step, state, shard, 1)
            save_pytree(state.checkpoint_tree(), os.path.join(tmp, "ckpt"),
                        step=1)
            state, l2, n2 = _run(step, state, shard, STEPS - 1)
            losses, norms = l1 + l2, n1 + n2
        else:
            state, losses, norms = _run(step, state, shard)
        _save_tree(os.path.join(tmp, f"after_{name}_{rank}.npz"),
                   state.params)
        full = _gather_stages(state.params, mesh)
        if rank == 0:
            _save_tree(os.path.join(tmp, f"params_{name}.npz"), full)
        res["cases"][name] = {"losses": losses, "norms": norms}
    res["jax_loaded"] = [m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")]
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(os.path.join(tmp, f"ranks{world}.json"), "w") as f:
            json.dump(gathered, f)
    dist.destroy_process_group()


def _jax_references(tmp) -> dict:
    """JAX's pipeline step in every case on a mesh of the case's CPU
    devices; writes each case's init tree and returns the losses, norms,
    params after step 3 and each device's layer rows at init."""
    import jax
    import optax

    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.parallel.pipeline import make_pp_train_step

    out = {}
    for name, (variant, axes, m, world) in CASES.items():
        mesh = build_mesh(MeshSpec(**axes), jax.devices("cpu")[:world])
        step, init, shard = make_pp_train_step(
            _cfg(variant, jax_side=True), mesh, m, optimizer=optax.sgd(LR),
            attn_impl="blockwise")
        state = _jax_init(init, mesh)
        _save_tree(os.path.join(tmp, f"{name}.npz"), state.params)
        rows = {}
        for k, v in _flat(state.params).items():
            for sh in v.addressable_shards:
                rows.setdefault(sh.device.id, {})[k] = np.asarray(sh.data)
        pos = {d.id: dict(zip(mesh.axis_names, idx))
               for idx, d in np.ndenumerate(mesh.devices)}
        x, y = _batch()
        losses, norms = [], []
        for _ in range(STEPS):
            state, met = step(state, shard(x), shard(y))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms, "rows": rows,
                     "pos": pos, "params": {k: np.asarray(v) for k, v in
                                            _flat(state.params).items()}}
    return out


def _one_device(tmp) -> dict:
    """The port's one-device step from each case's init tree: losses."""
    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.train.optim import sgd
    from ray_tpu_torch.train.spmd import make_llama_train_step

    out = {}
    for name, (variant, _, _, _) in CASES.items():
        step, init_state, shard = make_llama_train_step(
            _cfg(variant), None, optimizer=sgd(LR), attn_impl="blockwise",
            remat=False, device="cpu")
        state = init_state(params_from_jax(
            _load_tree(os.path.join(tmp, f"{name}.npz")), "cpu"))
        out[name] = _run(step, state, shard)[1]
    return out


def _restore_at_one(tmp) -> float:
    """The pp2 x dp2 checkpoint restored with mesh=None: step 2's loss."""
    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.train.checkpoint import restore_pytree
    from ray_tpu_torch.train.optim import sgd
    from ray_tpu_torch.train.spmd import make_llama_train_step

    step, init_state, shard = make_llama_train_step(
        _cfg("tied"), None, optimizer=sgd(LR), attn_impl="blockwise",
        remat=False, device="cpu")
    state = init_state(params_from_jax(
        _load_tree(os.path.join(tmp, "pp2dp2_m2.npz")), "cpu"))
    restore_pytree(os.path.join(tmp, "ckpt"), state.checkpoint_tree())
    assert int(state.step) == 1
    return _run(step, state, shard, 1)[1][0]


@pytest.fixture(scope="module")
def runs():
    from ray_tpu_torch.train.backend import free_port

    with tempfile.TemporaryDirectory() as tmp:
        want = _jax_references(tmp)
        got = {}
        for world in (4, 2):
            names = [n for n, c in CASES.items() if c[3] == world]
            sub = os.path.join(tmp, f"w{world}")
            os.makedirs(sub)
            run_ranks(_rank_main, world, sub, (tmp, free_port(), names),
                      RANK_TIMEOUT_S)
            with open(os.path.join(tmp, f"ranks{world}.json")) as f:
                got[world] = json.load(f)
        params = {n: _flat(_load_tree(os.path.join(tmp, f"params_{n}.npz")))
                  for n in CASES}
        rows = {n: {r: _flat(_load_tree(os.path.join(
            tmp, f"rows_{n}_{r}.npz"))) for r in range(c[3])}
            for n, c in CASES.items()}
        after = {n: {r: _flat(_load_tree(os.path.join(
            tmp, f"after_{n}_{r}.npz"))) for r in range(c[3])}
            for n, c in CASES.items()}
        one = _one_device(tmp)
        restored = _restore_at_one(tmp)
    return {"want": want, "got": got, "params": params, "rows": rows,
            "after": after, "one": one, "restored": restored}


def test_ranks_import_no_jax(runs):
    assert all(r["jax_loaded"] == [] for g in runs["got"].values()
               for r in g)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_and_norms_match_jax_on_the_same_mesh(runs, name):
    ranks = runs["got"][CASES[name][3]]
    got, want = ranks[0]["cases"][name], runs["want"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=F32_TOL,
                               atol=F32_TOL)
    for r in ranks[1:]:  # every rank reports the same numbers
        assert r["cases"][name] == got
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_params_after_three_steps_match_jax(runs, name):
    got, want = runs["params"][name], runs["want"][name]["params"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_the_one_device_step(runs, name):
    got = runs["got"][CASES[name][3]][0]["cases"][name]["losses"]
    np.testing.assert_allclose(got, runs["one"][name], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_jaxs_stage_rows(runs, name):
    """Rank r's layer rows (and whole shared leaves) are the data of
    JAX's addressable shard on the device at r's mesh position."""
    want = runs["want"][name]
    axes = CASES[name][1]
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER

    for r, mine in runs["rows"][name].items():
        pos = dict(zip(AXIS_ORDER, np.unravel_index(
            r, [axes.get(a, 1) for a in AXIS_ORDER])))
        dev = next(d for d, p in want["pos"].items()
                   if all(p[a] == pos.get(a, 0) for a in p))
        assert sorted(mine) == sorted(want["rows"][dev])
        for k, v in want["rows"][dev].items():
            assert np.array_equal(mine[k], v), (r, k)


def test_pipeline_checkpoint_resumes_at_mesh_none(runs):
    want = runs["got"][4][0]["cases"]["pp2dp2_m2"]["losses"][1]
    np.testing.assert_allclose(runs["restored"], want, rtol=RESTORE_TOL,
                               atol=RESTORE_TOL)




@pytest.mark.parametrize("axis", ["fsdp", "tp", "sp", "ep"])
def test_another_axis_of_size_two_replicates_the_pipeline(runs, axis):
    """pp2 x {axis}2: the two ranks of each stage along the other axis (a
    replica pipeline each) hold the same rows after 3 steps, bit for bit,
    and report the same losses (JAX's shard_map replicates the work)."""
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER

    name = f"pp2{axis}2_m2"
    shape = [CASES[name][1].get(a, 1) for a in AXIS_ORDER]
    after = runs["after"][name]
    for stage in range(2):
        pair = [r for r in range(4)
                if np.unravel_index(r, shape)[0] == stage]
        a, b = (after[r] for r in pair)
        assert sorted(a) == sorted(b) and a
        for k in a:
            assert np.array_equal(a[k], b[k]), (stage, k)
    losses = {json.dumps(r["cases"][name]) for r in runs["got"][4]}
    assert len(losses) == 1


def test_a_mesh_with_no_process_groups_is_refused():
    from ray_tpu_torch.parallel.mesh import single_device_mesh
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step

    with pytest.raises(ValueError, match="no process groups"):
        make_pp_train_step(_cfg("tied"), single_device_mesh(), 2,
                           device="cpu")


def test_pp_param_shardings_split_only_the_layer_leaves():
    from ray_tpu_torch.parallel.pipeline import pp_param_shardings

    specs = pp_param_shardings(_cfg("untied4"), _layout_mesh(pp=4))
    assert specs["embed_tokens"] == specs["final_norm"] == \
        specs["lm_head"] == ()
    assert set(specs["layers"].values()) == {("pp",)}
    assert "lm_head" not in pp_param_shardings(_cfg("tied"),
                                               _layout_mesh(pp=2))
    with pytest.raises(ValueError, match="do not split"):
        pp_param_shardings(_cfg("tied"), _layout_mesh(pp=4))


def test_sgd_matches_optax_sgd():
    import jax.numpy as jnp
    import optax

    from ray_tpu_torch.train.optim import apply_updates, sgd

    rng = np.random.default_rng(3)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    g = rng.normal(size=(5, 3)).astype(np.float32)
    opt = optax.sgd(0.1)
    upd, _ = opt.update({"w": jnp.asarray(g)}, opt.init({"w": p}))
    want = optax.apply_updates({"w": jnp.asarray(p)}, upd)["w"]
    tx = sgd(0.1)
    params = {"w": torch.from_numpy(p.copy())}
    upd, _ = tx.update({"w": torch.from_numpy(g)}, tx.init(params), params)
    apply_updates(params, upd)
    assert np.array_equal(params["w"].numpy(), np.asarray(want))
