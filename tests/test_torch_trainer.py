"""ray_tpu_torch's TorchTrainer against ray_tpu's JaxTrainer, on the CPU.

tests/test_train.py's trainer cases run with one train-function body
under each trainer: JaxTrainer under ``ray_tpu.init`` first, then
TorchTrainer (``TorchBackendConfig(device="cpu")``) under
``ray_tpu_torch.init``, never nested. Metrics histories, checkpoint files,
restart records (tier, trigger) and errors must agree. A tiny Llama trains
4 steps under each trainer with an injected failure and a checkpoint
restore in between; the losses agree within test_torch_train.py's
trajectory tolerance (1e-4), and the port's run with the restart equals
its run without one bit for bit. ``datasets=``: tests/test_train.py's
ingest and tests/test_data.py's multimodal ingest run under both
trainers (each worker's rows, in order, must agree), and a tiny Llama
trains 3 steps on the rows of ``get_dataset_shard`` under each trainer
(the port's worker reads them through ``iter_torch_batches(prefetch=2)``;
losses within 1e-4). Every ``fit`` runs in a thread joined
with a 60 s deadline, so a deadlock fails the test instead of hanging the
run.
"""

import os
import threading
import weakref

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.collective as jax_col
import ray_tpu.data as jdata
import ray_tpu.train as jtrain
import ray_tpu_torch
import ray_tpu_torch.collective as torch_col
import ray_tpu_torch.data as tdata
import ray_tpu_torch.train as ttrain
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.train.session import TrainContext

FIT_DEADLINE_S = 60
LOSS_TOL = 1e-4  # test_torch_train.py's 5-step trajectory tolerance

_DATA = {"jax": jdata, "torch": tdata}
SIDES = (("jax", ray_tpu, jtrain, jax_col), ("torch", ray_tpu_torch, ttrain,
                                             torch_col))


def fit_in_time(trainer):
    """trainer.fit() joined with FIT_DEADLINE_S."""
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


def _init(side, rt):
    rt.shutdown()
    if side == "jax":
        rt.init(num_cpus=8, resources={"TPU": 4.0})  # conftest's rt_start
    else:
        rt.init(num_cpus=8)


def fit_both(make_fn, tmp_path, name, *, num_workers=1, max_failures=0,
             config=None, datasets=None):
    """make_fn(train_module, collective_module) -> train_fn, fitted under
    each trainer; config(side_dir) -> train_loop_config;
    datasets(data_module) -> the trainer's datasets=."""
    out = {}
    for side, rt, train, col in SIDES:
        side_dir = tmp_path / side
        side_dir.mkdir()
        _init(side, rt)
        try:
            extra = {} if side == "jax" else {
                "backend_config": ttrain.TorchBackendConfig(device="cpu")}
            trainer_cls = jtrain.JaxTrainer if side == "jax" \
                else ttrain.TorchTrainer
            trainer = trainer_cls(
                make_fn(train, col),
                train_loop_config=config(side_dir) if config else {},
                scaling_config=train.ScalingConfig(num_workers=num_workers),
                run_config=train.RunConfig(
                    name=name, storage_path=str(side_dir),
                    failure_config=train.FailureConfig(
                        max_failures=max_failures)),
                datasets=datasets(_DATA[side]) if datasets else None,
                **extra)
            out[side] = fit_in_time(trainer)
        finally:
            rt.shutdown()
    return out["jax"], out["torch"]


def _restarts(result):
    return [(r["tier"], r["trigger"]) for r in result.restarts]


def test_single_worker_report_flow(tmp_path):
    def make(train, col):
        def train_fn(config):
            ctx = train.get_context()
            for step in range(3):
                train.report({"step": step, "loss": 1.0 / (step + 1),
                              "rank": ctx.get_world_rank()})
            return "done"
        return train_fn

    want, got = fit_both(make, tmp_path, "t1")
    assert got.ok and want.ok, (got.error, want.error)
    assert got.metrics == want.metrics and got.metrics["step"] == 2
    assert got.metrics_history == want.metrics_history
    assert len(got.metrics_history) == 3


def test_multi_worker_ddp_with_host_collective(tmp_path):
    def make(train, col):
        def train_fn(config):
            ctx = train.get_context()
            rank, world = ctx.get_world_rank(), ctx.get_world_size()
            g = col.init_collective_group(world_size=world, rank=rank,
                                          backend="host", group_name="ddp")
            w = np.zeros(4, np.float32)
            for step in range(5):
                target = np.full(4, 3.0 + 0.1 * rank, np.float32)
                grad = 2 * (w - target)
                grad = g.allreduce(grad) / world  # DDP gradient average
                w -= 0.3 * grad
                train.report({"step": step, "rank": rank,
                              "loss": float(((w - 3.05) ** 2).sum())})
            return w.tolist()
        return train_fn

    want, got = fit_both(make, tmp_path, "ddp", num_workers=2)
    assert got.ok and want.ok, (got.error, want.error)

    def by_rank(result):
        return {r: [m for m in result.metrics_history if m["rank"] == r]
                for r in (0, 1)}

    assert by_rank(got) == by_rank(want)
    losses = [m["loss"] for m in got.metrics_history if m["step"] == 4]
    assert len(losses) == 2 and all(x < 1.0 for x in losses)


def test_checkpoint_reported_and_retained(tmp_path):
    def make(train, col):
        def train_fn(config):
            ctx = train.get_context()
            for step in range(4):
                ck = None
                if ctx.get_world_rank() == 0:
                    ck = os.path.join(ctx.storage_path,
                                      f"checkpoint_{step:08d}")
                    os.makedirs(ck, exist_ok=True)
                    np.save(os.path.join(ck, "w.npy"), np.full(2, step))
                train.report({"step": step}, checkpoint=ck)
        return train_fn

    want, got = fit_both(make, tmp_path, "ckpt")
    assert got.ok and want.ok, (got.error, want.error)
    assert got.metrics_history == want.metrics_history
    paths = [r.checkpoint.path for r in (want, got)]
    assert [os.path.basename(p) for p in paths] == ["checkpoint_00000003"] * 2
    assert sorted(os.listdir(paths[0])) == sorted(os.listdir(paths[1]))
    np.testing.assert_array_equal(np.load(os.path.join(paths[1], "w.npy")),
                                  np.load(os.path.join(paths[0], "w.npy")))
    np.testing.assert_allclose(np.load(os.path.join(paths[1], "w.npy")), 3.0)


def test_failure_restart_from_checkpoint(tmp_path):
    def make(train, col):
        def train_fn(config):
            ctx = train.get_context()
            start = 0
            if ctx.get_checkpoint():
                start = int(np.load(os.path.join(ctx.get_checkpoint(),
                                                 "step.npy"))) + 1
            for step in range(start, 4):
                if step == 2 and not os.path.exists(config["marker"]):
                    open(config["marker"], "w").close()
                    raise RuntimeError("transient failure at step 2")
                ck = None
                if ctx.get_world_rank() == 0:
                    ck = os.path.join(ctx.storage_path,
                                      f"ck_{step}_{ctx.restart_count}")
                    os.makedirs(ck, exist_ok=True)
                    np.save(os.path.join(ck, "step.npy"), np.array(step))
                train.report({"step": step, "restart": ctx.restart_count},
                             checkpoint=ck)
        return train_fn

    want, got = fit_both(make, tmp_path, "recover", max_failures=2,
                         config=lambda d: {"marker": str(d / "crashed")})
    assert got.ok and want.ok, (got.error, want.error)
    assert got.metrics_history == want.metrics_history
    assert [(m["step"], m["restart"]) for m in got.metrics_history] == [
        (0, 0), (1, 0), (2, 1), (3, 1)]
    assert _restarts(got) == _restarts(want) == [("checkpoint",
                                                  "worker_error")]
    assert os.path.basename(got.checkpoint.path) == "ck_3_1"


def test_failure_budget_unified(tmp_path):
    def make(train, col):
        def train_fn(config):
            ctx = train.get_context()
            open(os.path.join(config["attempts"], f"a{ctx.restart_count}"),
                 "w").close()
            raise RuntimeError(f"always fails (restart {ctx.restart_count})")
        return train_fn

    def config(d):
        (d / "attempts").mkdir()
        return {"attempts": str(d / "attempts")}

    want, got = fit_both(make, tmp_path, "budget", max_failures=1,
                         config=config)
    assert not got.ok and not want.ok
    for side in ("jax", "torch"):
        assert sorted(os.listdir(tmp_path / side / "attempts")) == ["a0",
                                                                    "a1"]
    for r in (want, got):
        assert "rank 0" in r.error and "always fails (restart 1)" in r.error
    assert _restarts(got) == _restarts(want) == [("checkpoint",
                                                  "worker_error")]


# -- the tiny Llama under each trainer -------------------------------------

def _batch(i, vocab, b=2, s=32):
    rng = np.random.default_rng(i)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)



@pytest.fixture(autouse=True)
def _own_jax_train_stats(monkeypatch):
    """JAX's fits here leave each rank's final step row in ray_tpu's
    session for a minute; later tests of the process (the straggler
    verbs) read that table, so each test here gets its own."""
    import ray_tpu.train.session as jax_session

    monkeypatch.setattr(jax_session, "_stats_registry", {})
    monkeypatch.setattr(jax_session, "_stats_final", {})

_JAX_LLAMA_STEP = {}


def _jax_llama_step():
    """JAX's tiny Llama step, built and compiled once a process, before
    any fit's deadline starts. Each attempt of a fit used to build its own,
    and each build compiled the step twice (its first call, then again for
    the layout of the state that call returns) with the flash kernel traced
    in Pallas interpret mode: four compiles of ~2.5 s a fit, the bulk of
    its time, which the suite's load stretched past the deadline. Two
    warm-up steps on a throwaway state compile both layouts here, and
    orbax (~4 s to import, which the fit's first save_pytree paid) is
    imported here too."""
    if not _JAX_LLAMA_STEP:
        import orbax.checkpoint  # noqa: F401

        from ray_tpu.models.llama import LlamaConfig
        from ray_tpu.parallel.mesh import MeshSpec, build_mesh
        from ray_tpu.train import optim
        from ray_tpu.train.spmd import make_llama_train_step

        cfg = LlamaConfig.tiny()
        mesh = build_mesh(MeshSpec(dp=1), jax.devices("cpu")[:1])
        step, init, shard = make_llama_train_step(
            cfg, mesh, optimizer=optim.adamw_lowmem(1e-3, weight_decay=0.1),
            attn_impl="flash", remat="attn+")
        state = init()
        for i in range(2):
            tok, tgt = _batch(i, cfg.vocab_size)
            state, m = step(state, shard(tok), shard(tgt))
        jax.block_until_ready(m["loss"])
        _JAX_LLAMA_STEP["fns"] = cfg, (step, init, shard)
    return _JAX_LLAMA_STEP["fns"]


def _jax_llama_fn(config):
    from ray_tpu.train import restore_pytree, save_pytree

    ctx = jtrain.get_context()
    cfg, (step, init, shard) = _jax_llama_step()
    state, start = init(), 0
    if ctx.get_checkpoint():
        state, start = restore_pytree(ctx.get_checkpoint(), state), 2
    for i in range(start, 4):
        if i == 2 and ctx.restart_count == 0:
            raise RuntimeError("injected failure before step 2")
        tok, tgt = _batch(i, cfg.vocab_size)
        state, m = step(state, shard(tok), shard(tgt))
        ck = None
        if i == 1:
            ck = save_pytree(state, os.path.join(ctx.storage_path, "ck1"),
                             step=1)
        jtrain.report({"step": i, "loss": float(m["loss"])}, checkpoint=ck)


def _torch_llama_fn(config):
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import optim, restore_pytree, save_pytree, spmd

    ctx = ttrain.get_context()
    cfg = LlamaConfig.tiny()
    step, init, shard = spmd.make_llama_train_step(
        cfg, optimizer=optim.adamw_lowmem(1e-3, weight_decay=0.1),
        attn_impl="flash", remat="attn+", device=ctx.get_device())
    state, start = init(config["params"]), 0
    if ctx.get_checkpoint():
        restore_pytree(ctx.get_checkpoint(), state.checkpoint_tree())
        start = 2
    for i in range(start, 4):
        if i == 2 and ctx.restart_count == 0 and config["fail"]:
            raise RuntimeError("injected failure before step 2")
        tok, tgt = _batch(i, cfg.vocab_size)
        state, m = step(state, shard(tok), shard(tgt))
        ck = None
        if i == 1:
            ck = save_pytree(state.checkpoint_tree(),
                             os.path.join(ctx.storage_path, "ck1"), step=1)
        ttrain.report({"step": i, "loss": m["loss"].item()}, checkpoint=ck)


def test_tiny_llama_restart_matches_jax_and_its_own_straight_run(tmp_path):
    from ray_tpu.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.models import llama

    jparams = init_params(LlamaConfig.tiny(), jax.random.PRNGKey(0))
    tparams = llama.params_from_jax(jparams, "cpu")
    _jax_llama_step()  # compiled outside the fit's deadline
    runs = {}
    for label, side, fail in (("jax", "jax", True), ("torch", "torch", True),
                              ("torch_straight", "torch", False)):
        rt, train = (ray_tpu, jtrain) if side == "jax" \
            else (ray_tpu_torch, ttrain)
        _init(side, rt)
        try:
            if side == "jax":
                trainer = jtrain.JaxTrainer(
                    _jax_llama_fn, scaling_config=jtrain.ScalingConfig(),
                    run_config=jtrain.RunConfig(
                        name=label, storage_path=str(tmp_path),
                        failure_config=jtrain.FailureConfig(max_failures=1)))
            else:
                trainer = ttrain.TorchTrainer(
                    _torch_llama_fn,
                    train_loop_config={"params": tparams, "fail": fail},
                    scaling_config=ttrain.ScalingConfig(),
                    run_config=ttrain.RunConfig(
                        name=label, storage_path=str(tmp_path),
                        failure_config=ttrain.FailureConfig(max_failures=1)),
                    backend_config=ttrain.TorchBackendConfig(device="cpu"))
            runs[label] = fit_in_time(trainer)
        finally:
            rt.shutdown()
    for label, r in runs.items():
        assert r.ok, (label, r.error)
        # with a failure: steps 0-1, then the resumed attempt's 2-3
        assert [m["step"] for m in r.metrics_history] == [0, 1, 2, 3], label
    losses = {k: [m["loss"] for m in r.metrics_history]
              for k, r in runs.items()}
    assert len(losses["jax"]) == len(losses["torch"]) == 4
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert losses["torch"] == losses["torch_straight"]  # bit for bit
    assert _restarts(runs["torch"]) == _restarts(runs["jax"]) == [
        ("checkpoint", "worker_error")]
    assert _restarts(runs["torch_straight"]) == []


# -- datasets= ------------------------------------------------------------------

def test_dataset_ingest_matches_jax(tmp_path):
    """tests/test_train.py's ingest: range(64) in 8 blocks, split over 2
    workers; each worker's rows (in order) agree, and together they are
    every row once, 32 each."""
    def make(train, col):
        def loop(config):
            it = train.get_dataset_shard("train")
            seen = [int(v) for b in it.iter_batches(batch_size=8)
                    for v in b["id"]]
            train.report({"rank": train.get_context().get_world_rank(),
                          "seen": seen})
        return loop

    want, got = fit_both(make, tmp_path, "ingest", num_workers=2,
                         datasets=lambda rd: {
                             "train": rd.range(64, parallelism=8)})
    assert got.ok and want.ok, (got.error, want.error)
    by_rank = lambda r: {m["rank"]: m["seen"] for m in r.metrics_history}  # noqa: E731
    assert by_rank(got) == by_rank(want)
    assert sorted(sum(by_rank(got).values(), [])) == list(range(64))
    assert {len(v) for v in by_rank(got).values()} == {32}


def test_multimodal_ingest_matches_jax(tmp_path):
    """tests/test_data.py's multimodal ingest: read_images, then a split
    over 2 workers; counts and pixel sums agree per worker."""
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(8):
        Image.fromarray(np.full((6, 6, 3), i, dtype=np.uint8)).save(
            img_dir / f"class{i % 2}_{i}.png")

    def make(train, col):
        def loop(config):
            n, px = 0, 0.0
            for b in train.get_dataset_shard("train").iter_batches(
                    batch_size=4):
                n += len(b["image"])
                px += float(np.sum(b["image"][..., 0], dtype=np.float64))
            train.report({"rank": train.get_context().get_world_rank(),
                          "n": n, "px": px})
        return loop

    want, got = fit_both(make, tmp_path, "mm", num_workers=2,
                         datasets=lambda rd: {"train": rd.read_images(
                             str(img_dir), size=(6, 6))})
    assert got.ok and want.ok, (got.error, want.error)
    rows = lambda r: sorted((m["rank"], m["n"], m["px"])  # noqa: E731
                            for m in r.metrics_history)
    assert rows(got) == rows(want)
    assert sum(m["px"] for m in got.metrics_history) == sum(
        i * 36 for i in range(8))


def _llama_rows(vocab):
    tokens = np.concatenate([np.concatenate(
        [_batch(i, vocab)[0], _batch(i, vocab)[0][:, :1]], axis=1)
        for i in range(3)])
    return tokens.astype(np.int32)  # [6, 33]: tokens + one more


def _split_row(b):
    return {"tokens": b["row"][:, :-1], "targets": b["row"][:, 1:]}


def test_tiny_llama_on_its_dataset_shard_matches_jax(tmp_path):
    """A tiny Llama trains 3 steps on rows read through get_dataset_shard
    under each trainer; the port's worker reads them through the
    device-prefetching iterator. Losses agree within 1e-4."""
    from ray_tpu.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.models import llama

    jparams = init_params(LlamaConfig.tiny(), jax.random.PRNGKey(0))
    tparams = llama.params_from_jax(jparams, "cpu")
    rows = _llama_rows(LlamaConfig.tiny().vocab_size)

    def make(train, col):
        if train is jtrain:
            def loop(config):
                from ray_tpu.parallel.mesh import MeshSpec, build_mesh
                from ray_tpu.train import optim
                from ray_tpu.train.spmd import make_llama_train_step

                cfg = LlamaConfig.tiny()
                mesh = build_mesh(MeshSpec(dp=1), jax.devices("cpu")[:1])
                step, init, shard = make_llama_train_step(
                    cfg, mesh, optimizer=optim.adamw_lowmem(
                        1e-3, weight_decay=0.1),
                    attn_impl="flash", remat="attn+")
                state = init()
                for b in train.get_dataset_shard("train").iter_batches(
                        batch_size=2):
                    state, m = step(state, shard(b["tokens"]),
                                    shard(b["targets"]))
                    train.report({"loss": float(m["loss"])})
            return loop

        def loop(config):
            from ray_tpu_torch.train import optim, spmd

            dev = train.get_context().get_device()
            step, init, shard = spmd.make_llama_train_step(
                llama.LlamaConfig.tiny(), optimizer=optim.adamw_lowmem(
                    1e-3, weight_decay=0.1),
                attn_impl="flash", remat="attn+", device=dev)
            state = init(config["params"])
            for b in train.get_dataset_shard("train").iter_torch_batches(
                    batch_size=2, device=dev, prefetch=2):
                state, m = step(state, b["tokens"], b["targets"])
                train.report({"loss": m["loss"].item()})
        return loop

    def datasets(rd):
        return {"train": rd.from_numpy({"row": rows}).map_batches(
            _split_row)}

    out = {}
    for side, rt, train, col in SIDES:
        _init(side, rt)
        try:
            kw = {} if side == "jax" else {
                "backend_config": ttrain.TorchBackendConfig(device="cpu"),
                "train_loop_config": {"params": tparams}}
            cls = jtrain.JaxTrainer if side == "jax" else ttrain.TorchTrainer
            out[side] = fit_in_time(cls(
                make(train, col), datasets=datasets(_DATA[side]),
                run_config=train.RunConfig(name="llama_ds",
                                           storage_path=str(tmp_path / side)),
                **kw))
        finally:
            rt.shutdown()
    losses = {k: [m["loss"] for m in r.metrics_history]
              for k, r in out.items()}
    assert out["torch"].ok and out["jax"].ok, (out["torch"].error,
                                               out["jax"].error)
    assert len(losses["torch"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)


# -- the port's own ------------------------------------------------------------

@pytest.fixture
def port_rt():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _noop(config):
    ttrain.report({"step": 0})


def test_refusals_raise_before_any_worker_starts(port_rt, tmp_path,
                                                 monkeypatch):
    run = ttrain.RunConfig(storage_path=str(tmp_path))
    cpu = ttrain.TorchBackendConfig(device="cpu")
    with pytest.raises(NotImplementedError, match="7\\(b\\)"):
        ttrain.TorchTrainer(_noop, scaling_config=ttrain.ScalingConfig(
            num_workers=2), run_config=run, backend_config=ttrain.
            TorchBackendConfig(distributed=True, device="cpu")).fit()
    ds = tdata.range(4)
    assert ttrain.TorchTrainer(_noop, datasets={"train": ds}).datasets == {
        "train": ds}
    with pytest.raises(NotImplementedError, match="replica"):
        ttrain.CheckpointConfig(replicate_every=2)
    with pytest.raises(ValueError, match="infeasible resource demand GPU"):
        ttrain.TorchTrainer(_noop, scaling_config=ttrain.ScalingConfig(
            use_gpu=True), run_config=run, backend_config=cpu).fit()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in (None, ttrain.TorchBackendConfig(device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.TorchTrainer(_noop, run_config=run,
                                backend_config=backend).fit()
    ctx = TrainContext(dataset_shards={"train": "its split"})
    assert ctx.get_dataset_shard("train") == "its split"
    with pytest.raises(KeyError, match="no dataset 'eval'"):
        ctx.get_dataset_shard("eval")
    assert global_worker.runtime._actors == {}  # no worker, no controller


def test_failed_attempt_state_is_freed_before_the_restart(port_rt, tmp_path):
    seen = []

    def train_fn(config):
        ctx = ttrain.get_context()
        if ctx.restart_count == 0:
            state = torch.zeros(1 << 16)
            seen.append(weakref.ref(state))
            raise RuntimeError("fail with the state alive in this frame")
        seen.append(seen[0]() is None)
        ttrain.report({"device": str(ctx.get_device())})

    r = fit_in_time(ttrain.TorchTrainer(
        train_fn, run_config=ttrain.RunConfig(
            storage_path=str(tmp_path),
            failure_config=ttrain.FailureConfig(max_failures=1)),
        backend_config=ttrain.TorchBackendConfig(device="cpu")))
    assert r.ok, r.error
    assert seen[1] is True
    assert r.metrics_history == [{"device": "cpu"}]
    assert "fail with the state alive" not in str(r.restarts)


_CALLS: dict = {}  # side -> the calls its controller's copy received


class _Recorder:
    """A callback; the controller holds a copy, so calls land in _CALLS."""

    def __init__(self, side):
        self.side = side
        _CALLS[side] = []

    def on_run_start(self, name, config):
        _CALLS[self.side].append(("start", name))

    def on_result(self, metrics, iteration):
        _CALLS[self.side].append(("result", metrics["step"], iteration))

    def on_checkpoint(self, path, metrics):
        _CALLS[self.side].append(("checkpoint", os.path.basename(path)))

    def on_run_end(self, result):
        _CALLS[self.side].append(("end", result.ok))


def test_callbacks_and_hot_spares_match_jax(tmp_path):
    """RunConfig callbacks see rank 0's results and checkpoints; a hot
    spare is promoted into the group after a failure."""
    def make(train, col):
        def train_fn(config):
            ctx = train.get_context()
            for step in range(2):
                ck = os.path.join(ctx.storage_path, f"c{step}")
                os.makedirs(ck, exist_ok=True)
                train.report({"step": step}, checkpoint=ck)
            if ctx.restart_count == 0:
                raise RuntimeError("fail once")
        return train_fn

    results = {}
    for side, rt, train, col in SIDES:
        side_dir = tmp_path / side
        side_dir.mkdir()
        _init(side, rt)
        try:
            extra = {} if side == "jax" else {
                "backend_config": ttrain.TorchBackendConfig(device="cpu")}
            trainer_cls = jtrain.JaxTrainer if side == "jax" \
                else ttrain.TorchTrainer
            results[side] = fit_in_time(trainer_cls(
                make(train, col),
                scaling_config=train.ScalingConfig(num_workers=1,
                                                   hot_spares=1),
                run_config=train.RunConfig(
                    name="cb", storage_path=str(side_dir),
                    callbacks=[_Recorder(side)],
                    failure_config=train.FailureConfig(max_failures=1)),
                **extra))
        finally:
            rt.shutdown()
    assert _CALLS["torch"] == _CALLS["jax"]
    assert _CALLS["torch"][0] == ("start", "cb")
    assert _CALLS["torch"][-1] == ("end", True)
    assert ("checkpoint", "c1") in _CALLS["torch"]
    got, want = results["torch"], results["jax"]
    assert [r["spares_promoted"] for r in got.restarts] == \
        [r["spares_promoted"] for r in want.restarts] == [1]


@pytest.mark.parametrize("avail", [{"CPU": 8.0}, {"CPU": 2.5},
                                   {"CPU": 0.0}, {"GPU": 1.0}])
def test_elastic_world_size_matches_jax(avail):
    from ray_tpu.train.scaling_policy import make_scaling_policy as jax_make
    from ray_tpu_torch.train.scaling_policy import make_scaling_policy

    want = jax_make(jtrain.ScalingConfig(num_workers=4, min_workers=1,
                                         max_workers=4),
                    resources_fn=lambda: avail).decide_world_size(1)
    got = make_scaling_policy(ttrain.ScalingConfig(
        num_workers=4, min_workers=1, max_workers=4),
        resources_fn=lambda: avail).decide_world_size(1)
    assert got == want


def test_distributed_one_worker_joins_a_gloo_group(port_rt, tmp_path):
    import torch.distributed as dist

    def train_fn(config):
        dist.all_reduce(t := torch.ones(2))
        ttrain.report({"world": dist.get_world_size(),
                       "rank": dist.get_rank(), "sum": t.tolist()})

    assert not dist.is_initialized()
    try:
        r = fit_in_time(ttrain.TorchTrainer(
            train_fn, run_config=ttrain.RunConfig(storage_path=str(tmp_path)),
            backend_config=ttrain.TorchBackendConfig(distributed=True,
                                                     device="cpu")))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert r.ok, r.error
    assert r.metrics_history == [{"world": 1, "rank": 0, "sum": [1.0, 1.0]}]
