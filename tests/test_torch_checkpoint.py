"""ray_tpu_torch.train.checkpoint in one process, mirroring the JAX
package's checkpoint tests (tests/test_train.py): a tree round-trips with
and without a template, the manager keeps the last K, and the
write-behind writer holds its snapshot, orders its writes and surfaces
errors, and under a process group it runs no collective. The multi-rank
save, the writer's refusal of it, and restores at other world sizes are
in tests/test_torch_spmd_ranks.py.
"""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.train import optim, spmd
from ray_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    Checkpoint,
    CheckpointManager,
    FlatShard,
    restore_pytree,
    save_pytree,
)


def test_checkpoint_save_restore_roundtrip(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4),
            "opt": {"mu": torch.ones(3)}}
    d = save_pytree(tree, str(tmp_path / "ck1"), step=7)
    out = restore_pytree(d)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"].numpy())
    np.testing.assert_array_equal(out["opt"]["mu"].numpy(), 1.0)
    assert Checkpoint(d).metadata()["step"] == 7


def test_restore_into_a_template_fills_it_in_place(tmp_path):
    src = {"w": torch.arange(6.0), "piece": FlatShard(
        torch.arange(10.0), 10, 0, 10), "state": (torch.tensor(3),)}
    d = save_pytree(src, str(tmp_path / "ck"), step=1)
    w, local, n = torch.zeros(6), torch.zeros(12), torch.tensor(0)
    out = restore_pytree(d, {"w": w, "piece": FlatShard(local, 10, 0, 10),
                             "state": (n,)})
    assert out["w"] is w and out["piece"] is local and out["state"][0] is n
    np.testing.assert_array_equal(w.numpy(), np.arange(6.0))
    np.testing.assert_array_equal(local[:10].numpy(), np.arange(10.0))
    assert int(n) == 3 and float(local[10:].abs().sum()) == 0.0


def test_train_state_round_trips_through_a_checkpoint(tmp_path):
    """A one-device state saved after two steps and restored into a fresh
    state steps on as the original does."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, generator=1, device="cpu")
    tokens = np.random.default_rng(2).integers(0, 256, (2, 16))
    targets = np.roll(tokens, -1, axis=1)
    step, init, shard = spmd.make_llama_train_step(
        cfg, optimizer=optim.adamw_lowmem(1e-2), attn_impl="blockwise",
        remat=False, device="cpu", grad_norm_every=2)
    state = init(params)
    for _ in range(2):
        state, _ = step(state, shard(tokens), shard(targets))
    save_pytree(state.checkpoint_tree(), str(tmp_path / "ck"), step=2)
    _, want = step(state, shard(tokens), shard(targets))
    fresh = init(params)
    restore_pytree(str(tmp_path / "ck"), fresh.checkpoint_tree())
    assert int(fresh.step) == 2
    _, got = step(fresh, shard(tokens), shard(targets))
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"]) > 0


def test_checkpoint_manager_keeps_the_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), num_to_keep=2)
    dirs = []
    for step in range(4):
        d = mgr.next_checkpoint_dir(step)
        save_pytree({"w": torch.full((2,), float(step))}, d, step=step)
        mgr.register(d, {"loss": 4.0 - step if step != 2 else 0.5})
        dirs.append(d)
    assert [os.path.isdir(d) for d in dirs] == [False, False, True, True]
    assert mgr.latest().path == dirs[3]
    assert mgr.best("loss").path == dirs[2]
    assert mgr.best("loss", mode="max").path == dirs[3]
    assert mgr.best("missing").path == dirs[3]
    np.testing.assert_array_equal(
        restore_pytree(mgr.latest().path)["w"].numpy(), 3.0)


def test_async_checkpoint_writer(tmp_path):
    """save() returns before the write lands, the next save() barriers on
    the previous one, completed() releases directories only after their
    writes finished, and restore sees the snapshot taken at save() even
    though the tree changed right after."""
    writer = AsyncCheckpointWriter()
    w = torch.zeros(4)
    tree = {"w": w, "step": torch.tensor(0)}
    d1 = writer.save(tree, str(tmp_path / "ck1"), step=1)
    w.fill_(9.0)  # in place, right after save() returned
    d2 = writer.save({"w": w, "step": torch.tensor(2)},
                     str(tmp_path / "ck2"), step=2)  # barriers on d1
    assert d1 in writer.completed()
    writer.wait()
    assert writer.completed() == [d2]
    np.testing.assert_array_equal(restore_pytree(d1)["w"].numpy(), 0.0)
    np.testing.assert_array_equal(restore_pytree(d2)["w"].numpy(), 9.0)
    assert Checkpoint(d2).metadata()["step"] == 2


def test_async_checkpoint_writer_surfaces_errors(tmp_path):
    writer = AsyncCheckpointWriter()
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where the checkpoint dir should go")
    writer.save({"w": torch.ones(2)}, str(blocked / "ck"), step=0)
    with pytest.raises(Exception):
        writer.wait()
    assert writer.completed() == []


def test_async_checkpoint_writer_runs_no_collective_under_a_group(
        tmp_path, monkeypatch):
    """Under a one-rank process group the write-behind thread writes the
    tree alone: no barrier or object collective of DCP's on the group the
    training thread uses."""
    import torch.distributed as dist

    calls = []
    for op in ("barrier", "all_gather_object", "gather_object",
               "scatter_object_list", "broadcast_object_list",
               "all_reduce"):
        fn = getattr(dist, op)
        monkeypatch.setattr(dist, op, lambda *a, _op=op, _fn=fn, **k: (
            calls.append(_op), _fn(*a, **k))[1])
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        writer = AsyncCheckpointWriter()
        d = writer.save({"w": torch.arange(4.0), "piece": FlatShard(
            torch.arange(6.0), 6, 0, 6)}, str(tmp_path / "ck"), step=3)
        writer.wait()
        assert writer.completed() == [d] and calls == []
    finally:
        dist.destroy_process_group()
    out = restore_pytree(d)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4.0))
    np.testing.assert_array_equal(out["piece"].numpy(), np.arange(6.0))
