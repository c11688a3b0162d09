"""ray_tpu_torch's training step where tp does not divide the head count,
against the JAX package's step on the same 4-device mesh.

The model's rules split the heads over tp (the default table), tp = 4,
and ``num_heads`` or ``num_kv_heads`` is not a multiple of 4 while the
column dim is: the port then gathers the attention weights over tp (the
heads are not tp-local), as it gathers any unit the rules split another
way; JAX computes the case through GSPMD. Cases: Llama with 6 heads
(q and kv) and with tiny's 2 kv heads under 4 q heads; Mixtral tiny (2
kv heads); ViT tiny (2 heads).

The port's ranks are 4 gloo processes (``ray_tpu_torch._spawn.run_ranks``)
running every case once for the module, in a thread while JAX computes
its references on 4 virtual CPU devices in this process; both start from
JAX's ``init_params`` tree of each case, written to a file. f32,
``adamw(1e-2, eps=1e-3)``, 3 steps: losses, grad norms and the params
gathered after step 3 within 1e-5 (rtol and atol) of JAX's, every rank
reporting the same numbers.
"""

import json
import os
import sys
import tempfile
import threading
from dataclasses import replace
from functools import partial

import numpy as np
import pytest
import torch

from ray_tpu_torch._spawn import run_ranks
from test_torch_moe import _batch as _moe_batch
from test_torch_param_shard import (
    _flat,
    _inputs,
    _jax_init,
    _load_tree,
    _run,
    _save_tree,
)

RANK_TIMEOUT_S = 300
F32_TOL = 1e-5
ADAM_EPS = 1e-3
LR = 1e-2
STEPS = 3
MESH = dict(tp=4)

# name -> (model, config overrides)
CASES = {
    "llama_heads6": ("llama", dict(hidden_size=96, num_heads=6,
                                   num_kv_heads=6)),
    "llama_kv2": ("llama", {}),
    "mixtral_kv2": ("mixtral", {}),
    "vit_heads2": ("vit", {}),
}


def _cfg(model, over, jax_side=False):
    if jax_side:
        from ray_tpu.models import llama, mixtral, vit
    else:
        from ray_tpu_torch.models import llama, mixtral, vit
    base = {"llama": llama.LlamaConfig.tiny, "vit": vit.ViTConfig.tiny,
            "mixtral": mixtral.MixtralConfig.tiny}[model]()
    return replace(base, **over)


def _model_batch(model):
    if model == "mixtral":
        return _moe_batch()
    tokens, images, labels = _inputs()
    if model == "vit":
        return images, labels
    return tokens, np.roll(tokens, -1, axis=1)


def _logical(model, cfg):
    from ray_tpu_torch.models import llama, mixtral, vit

    return {"llama": llama, "vit": vit, "mixtral": mixtral}[
        model].param_logical_axes(cfg)


def _port_step(model, cfg, mesh):
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.spmd import (
        make_llama_train_step,
        make_mixtral_train_step,
        make_vit_train_step,
    )

    opt = optim.adamw(LR, eps=ADAM_EPS)
    if model == "llama":
        return make_llama_train_step(cfg, mesh, optimizer=opt,
                                     attn_impl="blockwise", remat=False,
                                     device="cpu")
    if model == "vit":
        return make_vit_train_step(cfg, mesh, optimizer=opt,
                                   attn_impl="xla", device="cpu")
    return make_mixtral_train_step(cfg, mesh, optimizer=opt,
                                   attn_impl="blockwise", remat=False,
                                   device="cpu")


def _rank_main(rank, world, store, tmp, port):
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules, gather_params
    from ray_tpu_torch.train.backend import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = build_mesh(MeshSpec(**MESH))
    res = {"rank": rank, "cases": {}}
    for name, (model, over) in CASES.items():
        cfg = _cfg(model, over)
        step, init_state, shard = _port_step(model, cfg, mesh)
        state = init_state(params_from_jax(
            _load_tree(os.path.join(tmp, f"{name}.npz")), "cpu"))
        state, losses, norms = _run(step, state, shard,
                                    *_model_batch(model), STEPS)
        full = gather_params(state.params, mesh, _logical(model, cfg),
                             ShardingRules())
        if rank == 0:
            _save_tree(os.path.join(tmp, f"params_{name}.npz"), full)
        res["cases"][name] = {"losses": losses, "norms": norms}
    res["jax_loaded"] = [m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")]
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(os.path.join(tmp, "four.json"), "w") as f:
            json.dump(gathered, f)
    dist.destroy_process_group()


def _jax_step(model, cfg, mesh):
    import optax

    from ray_tpu.train.spmd import (
        make_llama_train_step,
        make_mixtral_train_step,
        make_vit_train_step,
    )

    opt = optax.adamw(LR, eps=ADAM_EPS)
    if model == "llama":
        return make_llama_train_step(cfg, mesh, optimizer=opt,
                                     attn_impl="blockwise", remat=False)
    if model == "vit":
        return make_vit_train_step(cfg, mesh, optimizer=opt,
                                   attn_impl="xla")
    return make_mixtral_train_step(cfg, mesh, optimizer=opt,
                                   attn_impl="blockwise", remat=False)


def _write_inits(tmp) -> None:
    import jax

    from ray_tpu.models import llama, mixtral, vit

    mods = {"llama": llama, "vit": vit, "mixtral": mixtral}
    for name, (model, over) in CASES.items():
        cfg = _cfg(model, over, jax_side=True)
        _save_tree(os.path.join(tmp, f"{name}.npz"), jax.jit(
            partial(mods[model].init_params, cfg))(jax.random.PRNGKey(0)))


def _jax_references() -> dict:
    import jax

    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(**MESH), jax.devices("cpu")[:4])
    out = {}
    for name, (model, over) in CASES.items():
        step, init, shard = _jax_step(model, _cfg(model, over, True), mesh)
        state = _jax_init(init, mesh)
        x, y = _model_batch(model)
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, shard(x), shard(y))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms,
                     "params": {k: np.asarray(v) for k, v in
                                _flat(state.params).items()}}
    return out


def _port_ranks(tmp, errors: list) -> None:
    from ray_tpu_torch.train.backend import free_port

    try:
        os.makedirs(os.path.join(tmp, "four"))
        run_ranks(_rank_main, 4, os.path.join(tmp, "four"),
                  (tmp, free_port()), RANK_TIMEOUT_S)
    except BaseException as e:  # noqa: BLE001 - re-raised by the fixture
        errors.append(e)


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        _write_inits(tmp)
        errors: list = []
        ranks = threading.Thread(target=_port_ranks, args=(tmp, errors))
        ranks.start()
        try:
            want = _jax_references()
        finally:
            ranks.join()
        if errors:
            raise errors[0]
        with open(os.path.join(tmp, "four.json")) as f:
            got = json.load(f)
        params = {n: _flat(_load_tree(os.path.join(tmp, f"params_{n}.npz")))
                  for n in CASES}
    return {"want": want, "got": got, "params": params}


def test_ranks_import_no_jax(runs):
    assert all(r["jax_loaded"] == [] for r in runs["got"])


@pytest.mark.parametrize("name", list(CASES))
def test_losses_and_norms_match_jax_on_tp4(runs, name):
    got, want = runs["got"][0]["cases"][name], runs["want"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=F32_TOL,
                               atol=F32_TOL)
    for r in runs["got"][1:]:
        assert r["cases"][name] == got


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_params_after_three_steps_match_jax(runs, name):
    got, want = runs["params"][name], runs["want"][name]["params"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_the_heads_are_gathered_not_tp_local(name):
    """The decision: tp = 4 does not divide the head counts, so the
    attention unit is not tp-local (the MLP and vocabulary stay so)."""
    from test_torch_param_shard import _layout_mesh

    from ray_tpu_torch.parallel.param_shard import (
        check_layout,
        local_units,
        tp_indivisible,
    )
    from ray_tpu_torch.parallel.sharding import ShardingRules, axis_sizes

    model, over = CASES[name]
    cfg = _cfg(model, over)
    counts = {"attn": (cfg.num_heads, getattr(cfg, "num_kv_heads",
                                              cfg.num_heads))}
    mesh = _layout_mesh(**MESH)
    logical = _logical(model, cfg)
    layout = check_layout(axis_sizes(mesh), logical, ShardingRules())
    tp, _ = local_units(layout, logical, ("dp", "fsdp"),
                        tp_indivisible(counts, 4))
    assert tp["attn"] is False
    assert local_units(layout, logical, ("dp", "fsdp"))[0]["attn"] is True
