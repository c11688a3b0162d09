"""TorchTrainer over process workers against ray_tpu's trainer, on the CPU.

- ``TorchTrainer(TorchBackendConfig(distributed=True, device="cpu"),
  ScalingConfig(num_workers=2))`` on ``init(address="local-cluster")``:
  each rank is a worker process, the two meet in a gloo group at the
  controller's coordinator address, and train tiny Llama (f32, DDP
  rules, ``adamw(1e-2, eps=1e-3)``, blockwise attention, 3 steps) from
  one JAX ``init_params`` tree. Held against JAX's
  ``make_llama_train_step`` on a 2-device mesh: losses within
  tests/test_torch_spmd_ranks.py's ``F32_TOL`` (1e-5, rtol and atol), the
  final params within tests/test_torch_param_shard.py's ``PARAM_TOL``
  (1e-5) under its ``ADAM_EPS`` (a larger epsilon keeps Adam from
  amplifying the last bits of a near-zero gradient into a visible step),
  and both ranks' params equal bit for bit.
- The counterpart of tests/test_train.py::
  test_elastic_restart_at_smaller_world_size: two nodes with one
  ``trainslot`` each, an elastic group of 2, the second node removed once
  step 2 is reached. JAX's run and the port's give the same
  ``(restart, world, step)`` shape: started at world 2, resumed at world 1
  from a checkpoint at step 2 or later, finished at step 5.

The train functions are made inside factories, so they travel to the
workers by value and the workers import neither this module nor JAX.
"""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

F32_TOL = 1e-5  # tests/test_torch_spmd_ranks.py's, on the same step
PARAM_TOL = 1e-5  # tests/test_torch_param_shard.py's, under its ADAM_EPS
ADAM_EPS = 1e-3
STEPS = 3
FIT_DEADLINE_S = 120


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (16, 16), dtype=np.int32)


def _save_tree(path, tree):
    import torch

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


def _jax_llama(tmp) -> dict:
    import jax
    import optax

    from ray_tpu.models.llama import LlamaConfig
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.parallel.sharding import ShardingRules
    from ray_tpu.train.spmd import make_llama_train_step
    from test_torch_param_shard import _jax_init

    mesh = build_mesh(MeshSpec(dp=2), jax.devices("cpu")[:2])
    rules = ShardingRules().override(vocab=None, embed=None, mlp=None,
                                     heads=None, kv_heads=None)
    step, init, shard = make_llama_train_step(
        LlamaConfig.tiny(), mesh, rules=rules, optimizer=optax.adamw(1e-2, eps=ADAM_EPS),
        attn_impl="blockwise", remat=False)
    state = _jax_init(init, mesh)
    _save_tree(os.path.join(tmp, "init.npz"), state.params)
    tokens = _tokens()
    losses = []
    for _ in range(STEPS):
        state, m = step(state, shard(tokens), shard(np.roll(tokens, -1, 1)))
        losses.append(float(m["loss"]))
    _save_tree(os.path.join(tmp, "jax_final.npz"), state.params)
    return {"losses": losses}


def _make_llama_fn():
    def train_fn(config):
        import os

        import numpy as np
        import torch
        import torch.distributed as dist

        from ray_tpu_torch._device import tree_leaves
        from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax
        from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
        from ray_tpu_torch.parallel.sharding import ShardingRules
        from ray_tpu_torch.train import get_context, optim, report
        from ray_tpu_torch.train.spmd import make_llama_train_step

        torch.set_num_threads(1)
        ctx = get_context()
        z = np.load(config["init"])
        tree: dict = {}
        for k in z.files:
            node = tree
            *head, last = k.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = z[k]
        rules = ShardingRules().override(vocab=None, embed=None, mlp=None,
                                         heads=None, kv_heads=None)
        step, init_state, shard = make_llama_train_step(
            LlamaConfig.tiny(), build_mesh(MeshSpec(dp=2)), rules=rules,
            optimizer=optim.adamw(1e-2, eps=config["eps"]),
            attn_impl="blockwise", remat=False, device="cpu")
        state = init_state(params_from_jax(tree, "cpu"))
        tokens = config["tokens"]
        for i in range(config["steps"]):
            state, m = step(state, shard(tokens),
                            shard(np.roll(tokens, -1, 1)))
            report({"step": i, "loss": float(m["loss"]),
                    "rank": ctx.get_world_rank(), "pid": os.getpid(),
                    "world": dist.get_world_size()})
        flat = torch.cat([p.detach().reshape(-1)
                          for p in tree_leaves(state.params)])
        every = [torch.empty_like(flat) for _ in range(2)]
        dist.all_gather(every, flat)
        if ctx.get_world_rank() == 0:
            np.save(config["out"], flat.numpy())
            np.save(config["out"] + ".same.npy",
                    np.array(torch.equal(every[0], every[1])))

    return train_fn


def _fit(trainer):
    out = {}

    def run():
        try:
            out["result"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(FIT_DEADLINE_S)
    assert not t.is_alive(), f"fit() did not return in {FIT_DEADLINE_S} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def test_distributed_trainer_over_two_process_workers_matches_jax(tmp_path):
    from ray_tpu_torch import train as ttrain

    want = _jax_llama(str(tmp_path))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address="local-cluster", num_cpus=4)
    try:
        res = _fit(ttrain.TorchTrainer(
            _make_llama_fn(),
            train_loop_config={"init": str(tmp_path / "init.npz"),
                               "out": str(tmp_path / "port_final.npy"),
                               "tokens": _tokens(), "steps": STEPS,
                               "eps": ADAM_EPS},
            scaling_config=ttrain.ScalingConfig(
                num_workers=2, resources_per_worker={"CPU": 1}),
            run_config=ttrain.RunConfig(name="llama",
                                        storage_path=str(tmp_path)),
            backend_config=ttrain.TorchBackendConfig(distributed=True,
                                                     device="cpu")))
    finally:
        ray_tpu_torch.shutdown()
    assert res.ok, res.error
    by_rank = {r: [m for m in res.metrics_history if m["rank"] == r]
               for r in (0, 1)}
    pids = {m["pid"] for m in res.metrics_history}
    assert len(pids) == 2 and os.getpid() not in pids
    assert {m["world"] for m in res.metrics_history} == {2}
    for r in (0, 1):
        np.testing.assert_allclose([m["loss"] for m in by_rank[r]],
                                   want["losses"], rtol=F32_TOL,
                                   atol=F32_TOL)
    z = np.load(tmp_path / "jax_final.npz")
    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch._device import tree_leaves

    tree: dict = {}
    for k in z.files:
        node = tree
        *head, last = k.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = z[k]
    jax_flat = np.concatenate([p.detach().reshape(-1).numpy() for p in
                               tree_leaves(params_from_jax(tree, "cpu"))])
    np.testing.assert_allclose(np.load(tmp_path / "port_final.npy"),
                               jax_flat, rtol=PARAM_TOL, atol=PARAM_TOL)
    assert bool(np.load(str(tmp_path / "port_final.npy") + ".same.npy"))


def _make_elastic_fn(train_module: str):
    def train_fn(config):
        import importlib
        import os
        import time

        import numpy as np

        train = importlib.import_module(train_module)
        ctx = train.get_context()
        start = 0
        if ctx.get_checkpoint():
            start = int(np.load(os.path.join(ctx.get_checkpoint(),
                                             "step.npy"))) + 1
        for step in range(start, 6):
            time.sleep(0.4)
            ck = None
            if ctx.get_world_rank() == 0:
                d = os.path.join(ctx.storage_path,
                                 f"ck_{step}_{ctx.restart_count}")
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, "step.npy"), np.array(step))
                ck = d
                open(os.path.join(config["progress"], f"step_{step}"),
                     "w").close()
            train.report({"step": step, "world": ctx.get_world_size(),
                          "restart": ctx.restart_count}, checkpoint=ck)

    return train_fn


def _elastic_shape(side: str, tmp) -> dict:
    if side == "jax":
        from ray_tpu.cluster_utils import Cluster
        from ray_tpu.core.worker import global_worker
        from ray_tpu.train import FailureConfig, RunConfig, ScalingConfig
        from ray_tpu.train.backend import JaxBackendConfig as Backend
        from ray_tpu.train.controller import TrainController
        from ray_tpu.utils import config as config_mod
        from ray_tpu.utils.ids import JobID
        api, backend = ray_tpu, Backend(distributed=False)
    else:
        from ray_tpu_torch.cluster_utils import Cluster
        from ray_tpu_torch.core.worker import global_worker
        from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig
        from ray_tpu_torch.train.backend import TorchBackendConfig as Backend
        from ray_tpu_torch.train.controller import TrainController
        from ray_tpu_torch.utils import config as config_mod
        from ray_tpu_torch.utils.ids import JobID
        api, backend = ray_tpu_torch, Backend(distributed=False,
                                              device="cpu")
    old_period = os.environ.get("RTPU_HEALTH_CHECK_PERIOD_S")
    os.environ["RTPU_HEALTH_CHECK_PERIOD_S"] = "0.2"
    config_mod.set_config(config_mod.Config.load())
    api.shutdown()
    c = Cluster()
    c.add_node(num_cpus=8, resources={"trainslot": 1.0})
    doomed = c.add_node(num_cpus=2, resources={"trainslot": 1.0})
    rt = c.connect()
    saved = (global_worker.runtime, global_worker.mode)
    global_worker.runtime = rt
    global_worker.worker_id = rt.worker_id
    global_worker.job_id = JobID.from_random()
    global_worker.mode = "cluster"
    progress = os.path.join(tmp, side, "progress")
    os.makedirs(progress)
    try:
        controller = TrainController(
            _make_elastic_fn(f"{api.__name__}.train"),
            {"progress": progress},
            ScalingConfig(num_workers=2, min_workers=1, max_workers=2,
                          resources_per_worker={"trainslot": 1.0,
                                                "CPU": 1.0}),
            RunConfig(name="elastic", storage_path=os.path.join(tmp, side),
                      failure_config=FailureConfig(max_failures=3)),
            backend)

        def chaos():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if os.path.exists(os.path.join(progress, "step_2")):
                    break
                time.sleep(0.1)
            c.remove_node(doomed)

        killer = threading.Thread(target=chaos)
        killer.start()
        result = controller.run()
        killer.join()
    finally:
        rt.shutdown()
        c.shutdown()
        global_worker.runtime, global_worker.mode = saved
        if old_period is None:
            os.environ.pop("RTPU_HEALTH_CHECK_PERIOD_S", None)
        else:
            os.environ["RTPU_HEALTH_CHECK_PERIOD_S"] = old_period
        config_mod.set_config(config_mod.Config.load())
    assert result.ok, result.error
    worlds = [(m["restart"], m["world"], m["step"])
              for m in result.metrics_history]
    down = [(r, w, s) for r, w, s in worlds if w == 1]
    return {"started_at_2": any(w == 2 for _, w, _ in worlds),
            "downsized": bool(down),
            "resumed_at_or_after_2": bool(down)
            and min(s for _, _, s in down) >= 2,
            "downsized_after_a_restart": all(r >= 1 for r, _, _ in down),
            "last_step": max(s for _, _, s in worlds),
            "tiers": [r["tier"] for r in result.restarts]}


def test_elastic_restart_at_smaller_world_size_matches_jax(tmp_path):
    jax_shape = _elastic_shape("jax", str(tmp_path))
    port_shape = _elastic_shape("torch", str(tmp_path))
    assert port_shape == jax_shape
    assert port_shape["started_at_2"] and port_shape["downsized"]
    assert port_shape["resumed_at_or_after_2"]
    assert port_shape["last_step"] == 5
