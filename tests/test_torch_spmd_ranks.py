"""ray_tpu_torch's training step over several ranks against the JAX
package's step over a mesh of devices, on the CPU.

The port's ranks are processes (``ray_tpu_torch._spawn.run_ranks``, spawn
start method) that meet in a gloo group through
``train.backend.init_distributed`` on a ``free_port()``; they import torch
and the port alone (each checks that no JAX module was loaded). JAX runs
the references in the test process on its 8 virtual CPU devices. One JAX
``init_params`` tree, written to a file, starts both sides; tokens come
from numpy.

Two groups of ranks run once for the module (a fixture), every mode in
one group, each within ``RANK_TIMEOUT_S``:

- 4 ranks on ``hybrid_mesh(MeshSpec(dp=2, fsdp=2, dcn_axes=("dp",)))``,
  Llama tiny f32, DDP rules, ``adamw(1e-2)``, 3 steps of each mode: flat,
  hier, zero1, zero1 + int8, zero1 + bf16, zero1 + grad_accum 2 +
  grad_norm_every 2; against JAX's ``make_llama_train_step`` on the same
  4-device hybrid mesh. The zero1 run saves a checkpoint after its first
  step;
- 2 ranks: Llama tiny at ``sp=2`` (the ring over the sp group) against
  JAX's one-device step on the whole sequence; ViT tiny at ``dp=2``
  against JAX's on a 2-device mesh; the 4-rank checkpoint restored under
  zero1 at ``dp=2`` and stepped once; the write-behind writer on a flat
  data-parallel state (rank 0 writes it, both ranks restore it) and on
  the zero1 state (refused).

The test process restores the same checkpoint at one rank (``mesh=None``)
and steps once.

Tolerances (f32): losses and grad norms 1e-5 (assert_allclose rtol and
atol) against JAX in every f32 mode, the hierarchy and ZeRO-1 being
reorderings of the same sums; int8 and bf16 within 1e-4 of JAX's own
int8/bf16 step (a rounding step can flip one quantized value where the
two sides' per-slice sums differ in their last bit) and within 2e-2 of
flat (JAX's documented tolerance); a restored step within 1e-6 (rtol and
atol) of the uninterrupted 4-rank step, loss and every param.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from ray_tpu_torch._spawn import run_ranks
from test_torch_param_shard import _jax_init

RANK_TIMEOUT_S = 90
F32_TOL = 1e-5
QUANT_JAX_TOL = 1e-4
QUANT_FLAT_TOL = 2e-2
RESTORE_TOL = 1e-6
STEPS = 3

HYBRID_MODES = {
    "flat": {},
    "hier": {"dcn_axes": ("dp",)},
    "zero1": {"zero1": True, "dcn_axes": ("dp",)},
    "zero1_q8": {"zero1": True, "dcn_axes": ("dp",), "dcn_quant": "int8"},
    "zero1_bf16": {"zero1": True, "dcn_axes": ("dp",), "dcn_quant": "bf16"},
    "accum": {"zero1": True, "dcn_axes": ("dp",), "grad_accum": 2,
              "grad_norm_every": 2},
}
DDP = dict(vocab=None, embed=None, mlp=None, heads=None, kv_heads=None)


def _inputs():
    rng = np.random.default_rng(0)
    llama = rng.integers(0, 256, (16, 16), dtype=np.int32)
    seq = rng.integers(0, 256, (2, 32), dtype=np.int32)
    images = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    return llama, seq, images, labels


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


def _flat_params(params) -> np.ndarray:
    from ray_tpu_torch._device import tree_leaves

    return np.concatenate([p.detach().float().reshape(-1).numpy()
                           for p in tree_leaves(params)])


def _run(step, state, shard, x, y, steps=STEPS):
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, shard(x), shard(y))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _same_on_every_rank(t: torch.Tensor) -> bool:
    import torch.distributed as dist

    got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t)
    return all(torch.equal(g, got[0]) for g in got)


class _Spy:
    """Records the dtype and size of every tensor a collective moves over
    one group (by its ranks)."""

    OPS = ("all_to_all_single", "all_gather_into_tensor", "all_reduce",
           "reduce_scatter_tensor")

    def __init__(self, dist, ranks):
        self.dist, self.ranks, self.calls = dist, sorted(ranks), []
        self.saved = {op: getattr(dist, op) for op in self.OPS}
        for op, fn in self.saved.items():
            setattr(dist, op, self._wrap(op, fn))

    def _wrap(self, op, fn):
        def spy(*args, group=None, **kw):
            if group is not None and sorted(
                    self.dist.get_process_group_ranks(group)) == self.ranks:
                t = args[1] if op != "all_reduce" else args[0]
                self.calls.append((op, str(t.dtype), t.numel()))
            return fn(*args, group=group, **kw)
        return spy

    def restore(self):
        for op, fn in self.saved.items():
            setattr(self.dist, op, fn)


def _rank_four(rank, world, store, tmp, port):
    """The 4-rank group: every hybrid-mesh mode, the step-time batch
    checks, and the checkpoint saved by zero1 after its first step."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.backend import init_distributed
    from ray_tpu_torch.train.checkpoint import restore_pytree, save_pytree
    from ray_tpu_torch.train.spmd import make_llama_train_step

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    assert init_distributed(f"127.0.0.1:{port}", world, rank,
                            device="cpu") == torch.device("cpu")
    mesh = hybrid_mesh(MeshSpec(dp=2, fsdp=2, dcn_axes=("dp",)), 2, 2)
    rules = ShardingRules().override(**DDP)
    cfg = LlamaConfig.tiny()
    init = _load_tree(os.path.join(tmp, "llama.npz"))
    tokens = _inputs()[0]
    targets = np.roll(tokens, -1, axis=1)
    dcn_ranks = dist.get_process_group_ranks(mesh.get_group("dp"))
    opt = optim.adamw(1e-2)
    res = {"modes": {}, "mesh": mesh.mesh.tolist()}
    for name, kw in HYBRID_MODES.items():
        step, init_state, shard = make_llama_train_step(
            cfg, mesh, rules=rules, optimizer=opt, attn_impl="blockwise",
            remat=False, device="cpu", **kw)
        state = init_state(params_from_jax(init, "cpu"))
        spy = _Spy(dist, dcn_ranks)
        try:
            if name == "zero1":
                state, l1, n1 = _run(step, state, shard, tokens, targets, 1)
                save_pytree(state.checkpoint_tree(),
                            os.path.join(tmp, "ckpt"), step=1)
                state, l2, n2 = _run(step, state, shard, tokens, targets, 1)
                if rank == 0:
                    _save_tree(os.path.join(tmp, "after2.npz"), state.params)
                state, l3, n3 = _run(step, state, shard, tokens, targets, 1)
                losses, norms = l1 + l2 + l3, n1 + n2 + n3
            else:
                state, losses, norms = _run(step, state, shard, tokens,
                                            targets)
        finally:
            spy.restore()
        if name == "hier":
            # The hierarchy without zero1 holds each piece on both slices:
            # slice 0 writes it, and a restore broadcasts it to slice 1.
            save_pytree(state.checkpoint_tree(),
                        os.path.join(tmp, "ckpt_hier"), step=STEPS)
            fresh = init_state(params_from_jax(init, "cpu"))
            restore_pytree(os.path.join(tmp, "ckpt_hier"),
                           fresh.checkpoint_tree())
            res["hier_restored"] = all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(fresh.opt_state), _leaves(state.opt_state))) \
                and int(fresh.step) == STEPS and all(
                    torch.equal(a, b) for a, b in zip(
                        _leaves(fresh.params), _leaves(state.params)))
        res["modes"][name] = {
            "losses": losses, "norms": norms,
            "params_equal": _same_on_every_rank(
                torch.from_numpy(_flat_params(state.params))),
            "opt_bytes": sum(t.numel() * t.element_size()
                             for t in _leaves(state.opt_state)),
            "dcn_calls": spy.calls}
    res["opt_bytes_flat_est"] = optim.optimizer_state_bytes(
        opt, state.params)
    res["opt_bytes_zero1_est"] = optim.optimizer_state_bytes(
        opt, state.params, shardings=world)
    # The JAX factory's step-time ValueErrors, on the same inputs.
    errors = {}
    for name, m, kw in (
            ("hier", mesh, {"dcn_axes": ("dp",), "grad_accum": 3}),
            ("flat", build_mesh(MeshSpec(dp=4)), {"grad_accum": 3})):
        step, init_state, shard = make_llama_train_step(
            cfg, m, rules=rules, optimizer=opt, attn_impl="blockwise",
            remat=False, device="cpu", **kw)
        try:
            step(init_state(params_from_jax(init, "cpu")),
                 shard(tokens[:8]), shard(targets[:8]))
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    res["errors"] = errors
    res["jax_loaded"] = [m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")]
    if rank == 0:
        with open(os.path.join(tmp, "four.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _leaves(tree):
    from ray_tpu_torch._device import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _rank_two(rank, world, store, tmp, port):
    """The 2-rank group: sp = 2, ViT at dp = 2, and the restore at 2."""
    import torch.distributed as dist

    from ray_tpu_torch.models import vit
    from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.backend import init_distributed
    from ray_tpu_torch.train.checkpoint import (
        AsyncCheckpointWriter,
        restore_pytree,
    )
    from ray_tpu_torch.train.spmd import (
        make_llama_train_step,
        make_vit_train_step,
    )

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    tokens, seq, images, labels = _inputs()
    cfg = LlamaConfig.tiny()
    init = _load_tree(os.path.join(tmp, "llama.npz"))
    res = {}

    from ray_tpu_torch.models import llama

    step, init_state, shard = make_llama_train_step(
        cfg, build_mesh(MeshSpec(sp=2)), optimizer=optim.adamw(1e-2),
        attn_impl="blockwise", remat=False, device="cpu")
    ring, rings = llama.ring_attention_local, []
    llama.ring_attention_local = lambda *a, **kw: rings.append(1) or ring(
        *a, **kw)
    try:
        _, res["sp_losses"], res["sp_norms"] = _run(
            step, init_state(params_from_jax(init, "cpu")), shard, seq,
            np.roll(seq, -1, axis=1), 2)
    finally:
        llama.ring_attention_local = ring
    res["sp_ring_calls"] = len(rings)

    vcfg = vit.ViTConfig.tiny()
    step, init_state, shard = make_vit_train_step(
        vcfg, build_mesh(MeshSpec(dp=2)), optimizer=optim.adamw(1e-2),
        attn_impl="xla", device="cpu")
    vstate = init_state(params_from_jax(
        _load_tree(os.path.join(tmp, "vit.npz")), "cpu"))
    _, res["vit_losses"], res["vit_norms"] = _run(
        step, vstate, shard, images, labels)

    step, init_state, shard = make_llama_train_step(
        cfg, build_mesh(MeshSpec(dp=2)),
        rules=ShardingRules().override(**DDP), optimizer=optim.adamw(1e-2),
        attn_impl="blockwise", remat=False, device="cpu", zero1=True)
    state = init_state(params_from_jax(init, "cpu"))
    restore_pytree(os.path.join(tmp, "ckpt"), state.checkpoint_tree())
    state, res["restored_losses"], _ = _run(
        step, state, shard, tokens, np.roll(tokens, -1, axis=1), 1)
    res["restored_step"] = int(state.step)
    if rank == 0:
        _save_tree(os.path.join(tmp, "restored2.npz"), state.params)
    # The write-behind writer refuses a state that holds pieces (zero1's
    # moments) ...
    try:
        AsyncCheckpointWriter().save(state.checkpoint_tree(),
                                     os.path.join(tmp, f"async{rank}"))
        res["async_refused"] = None
    except RuntimeError as e:
        res["async_refused"] = str(e)
    res["async_wrote"] = os.path.exists(os.path.join(tmp, f"async{rank}"))
    # ... and writes a replicated one (flat data parallel) from rank 0.
    step, init_state, shard = make_llama_train_step(
        cfg, build_mesh(MeshSpec(dp=2)),
        rules=ShardingRules().override(**DDP), optimizer=optim.adamw(1e-2),
        attn_impl="blockwise", remat=False, device="cpu")
    flat, _, _ = _run(step, init_state(params_from_jax(init, "cpu")), shard,
                      tokens, np.roll(tokens, -1, axis=1), 1)
    writer = AsyncCheckpointWriter()
    where = os.path.join(tmp, "async_flat")
    res["async_flat_returned"] = writer.save(flat.checkpoint_tree(), where,
                                             step=1) == where
    writer.wait()
    res["async_flat_completed"] = writer.completed()
    dist.barrier()
    fresh = init_state(params_from_jax(init, "cpu"))
    restore_pytree(where, fresh.checkpoint_tree())
    res["async_flat_restored"] = int(fresh.step) == 1 and all(
        torch.equal(a, b) for a, b in zip(
            _leaves(fresh.params) + _leaves(fresh.opt_state),
            _leaves(flat.params) + _leaves(flat.opt_state)))
    gathered = [None] * world
    dist.all_gather_object(gathered, [res["async_flat_restored"],
                                      res["async_flat_completed"]])
    res["async_flat_by_rank"] = gathered
    res["jax_loaded"] = [m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")]
    if rank == 0:
        with open(os.path.join(tmp, "two.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _jax_references(tmp) -> dict:
    """JAX's steps on the same inputs; writes the init trees for the
    ranks."""
    import jax
    import optax

    from ray_tpu.models import vit as jax_vit
    from ray_tpu.models.llama import LlamaConfig
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh
    from ray_tpu.parallel.sharding import ShardingRules
    from ray_tpu.train.spmd import make_llama_train_step, make_vit_train_step

    devs = jax.devices("cpu")
    tokens, seq, images, labels = _inputs()
    cfg = LlamaConfig.tiny()
    mesh = hybrid_mesh(MeshSpec(dp=2, fsdp=2, dcn_axes=("dp",)), 2, 2,
                       devices=devs[:4])
    out = {"modes": {}, "mesh": np.vectorize(lambda d: d.id)(
        mesh.devices).tolist()}
    rules = ShardingRules().override(**DDP)
    for name, kw in HYBRID_MODES.items():
        step, init, shard = make_llama_train_step(
            cfg, mesh, rules=rules, optimizer=optax.adamw(1e-2),
            attn_impl="blockwise", remat=False, **kw)
        state = _jax_init(init, mesh)
        if name == "flat":
            _save_tree(os.path.join(tmp, "llama.npz"), state.params)
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, shard(tokens),
                            shard(np.roll(tokens, -1, axis=1)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["modes"][name] = {"losses": losses, "norms": norms}
    one = build_mesh(MeshSpec(), devs[:1])
    step, init, shard = make_llama_train_step(
        cfg, one, optimizer=optax.adamw(1e-2), attn_impl="blockwise",
        remat=False)
    state = _jax_init(init, one)
    out["sp_losses"], out["sp_norms"] = [], []
    for _ in range(2):
        state, m = step(state, shard(seq), shard(np.roll(seq, -1, axis=1)))
        out["sp_losses"].append(float(m["loss"]))
        out["sp_norms"].append(float(m["grad_norm"]))
    vcfg = jax_vit.ViTConfig.tiny()
    vmesh = build_mesh(MeshSpec(dp=2), devs[:2])
    step, init, shard = make_vit_train_step(
        vcfg, vmesh, optimizer=optax.adamw(1e-2), attn_impl="xla")
    state = _jax_init(init, vmesh)
    _save_tree(os.path.join(tmp, "vit.npz"), state.params)
    out["vit_losses"], out["vit_norms"] = [], []
    for _ in range(STEPS):
        state, m = step(state, shard(images), shard(labels))
        out["vit_losses"].append(float(m["loss"]))
        out["vit_norms"].append(float(m["grad_norm"]))
    return out


def _restore_at_one(tmp) -> dict:
    """The 4-rank zero1 checkpoint restored with mesh=None, one step."""
    from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.checkpoint import restore_pytree
    from ray_tpu_torch.train.spmd import make_llama_train_step

    tokens = _inputs()[0]
    step, init_state, shard = make_llama_train_step(
        LlamaConfig.tiny(), optimizer=optim.adamw(1e-2),
        attn_impl="blockwise", remat=False, device="cpu")
    state = init_state(params_from_jax(
        _load_tree(os.path.join(tmp, "llama.npz")), "cpu"))
    restore_pytree(os.path.join(tmp, "ckpt"), state.checkpoint_tree())
    state, losses, _ = _run(step, state, shard, tokens,
                            np.roll(tokens, -1, axis=1), 1)
    return {"losses": losses, "step": int(state.step),
            "params": _flat_params(state.params)}


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
        one = _restore_at_one(tmp)
        after2 = _flat_params(_as_tensors(_load_tree(
            os.path.join(tmp, "after2.npz"))))
        restored2 = _flat_params(_as_tensors(_load_tree(
            os.path.join(tmp, "restored2.npz"))))
    return {"want": want, "four": four, "two": two, "one": one,
            "after2": after2, "restored2": restored2}


def _as_tensors(tree):
    from ray_tpu_torch._device import tree_map

    return tree_map(torch.from_numpy, tree)


def test_ranks_import_no_jax(runs):
    assert runs["four"]["jax_loaded"] == []
    assert runs["two"]["jax_loaded"] == []


def test_rank_layout_is_jaxs_device_layout(runs):
    """The hybrid DeviceMesh the ranks built stands where JAX's hybrid
    mesh puts its devices (checked before any numbers are compared)."""
    assert runs["four"]["mesh"] == runs["want"]["mesh"]


@pytest.mark.parametrize("mode", ["flat", "hier", "zero1", "accum"])
def test_f32_modes_match_jax_on_the_hybrid_mesh(runs, mode):
    got, want = runs["four"]["modes"][mode], runs["want"]["modes"][mode]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=F32_TOL,
                               atol=F32_TOL)
    assert got["params_equal"]
    if mode == "accum":  # grad_norm_every=2: step 1 of 0, 1, 2 skips
        assert got["norms"][1] == -1.0 and min(
            got["norms"][0], got["norms"][2]) > 0
    else:
        assert min(got["norms"]) > 0


@pytest.mark.parametrize("mode,wire", [("zero1_q8", "torch.int8"),
                                       ("zero1_bf16", "torch.bfloat16")])
def test_quantized_dcn_stage_matches_jax_and_moves_its_wire_format(
        runs, mode, wire):
    got, want = runs["four"]["modes"][mode], runs["want"]["modes"][mode]
    flat = runs["four"]["modes"]["flat"]["losses"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=QUANT_JAX_TOL, atol=QUANT_JAX_TOL)
    np.testing.assert_allclose(got["norms"], want["norms"],
                               rtol=QUANT_JAX_TOL, atol=QUANT_JAX_TOL)
    np.testing.assert_allclose(got["losses"], flat, rtol=0,
                               atol=QUANT_FLAT_TOL)
    if mode == "zero1_q8":
        assert got["losses"][1] != flat[1]  # visibly quantized
    assert got["params_equal"]
    # Over the dcn group the gradients move only as the wire format (int8
    # values plus one f32 scale per 256 of them); params gather in f32.
    moved = [c for c in got["dcn_calls"] if c[0] == "all_to_all_single"]
    assert moved and {c[1] for c in moved} <= {wire, "torch.float32"}
    payload = sum(n for _, dt, n in moved if dt == wire)
    scales = sum(n for _, dt, n in moved if dt == "torch.float32")
    assert scales * 256 == (payload if wire == "torch.int8" else 0)


def test_zero1_holds_under_a_third_of_the_flat_optimizer_bytes(runs):
    modes = runs["four"]["modes"]
    flat = modes["flat"]["opt_bytes"]
    assert flat == runs["four"]["opt_bytes_flat_est"]
    for mode in ("zero1", "zero1_q8", "accum"):
        assert modes[mode]["opt_bytes"] < flat / 3, mode
    assert runs["four"]["opt_bytes_zero1_est"] < flat / 3
    # Without zero1 the hierarchy shards the update over the slice (ici).
    assert modes["hier"]["opt_bytes"] < flat / 1.5


def test_step_raises_the_jax_factorys_batch_errors(runs):
    errors = runs["four"]["errors"]
    assert errors["hier"] == ("batch 8 not divisible by 2 slices x "
                              "grad_accum=3")
    assert errors["flat"] == "batch 8 not divisible by grad_accum=3"


def test_sp_mesh_gives_the_whole_sequence_loss(runs):
    two, want = runs["two"], runs["want"]
    np.testing.assert_allclose(two["sp_losses"], want["sp_losses"],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(two["sp_norms"], want["sp_norms"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_sp_mesh_runs_the_ring_under_the_default_rules(runs):
    """The default rules take the param-shard path (size-1 fsdp and tp
    groups); the sp = 2 step must still give each rank its chunk and run
    the ring, once a layer a step (2 layers, 2 steps)."""
    assert runs["two"]["sp_ring_calls"] == 2 * 2


def test_vit_data_parallel_matches_jax(runs):
    two, want = runs["two"], runs["want"]
    np.testing.assert_allclose(two["vit_losses"], want["vit_losses"],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(two["vit_norms"], want["vit_norms"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_hier_checkpoint_restores_pieces_held_by_both_slices(runs):
    assert runs["four"]["hier_restored"]


def test_async_writer_refuses_a_multi_rank_save(runs):
    """A multi-rank state that holds pieces (zero1's moments) is refused:
    the writer runs no collective."""
    two = runs["two"]
    assert "pieces" in (two["async_refused"] or "")
    assert "group of 2 ranks" in two["async_refused"]
    assert not two["async_wrote"]


def test_async_writer_writes_a_replicated_multi_rank_state_from_rank_0(
        runs):
    """A flat data-parallel 2-rank state (every leaf whole on every rank)
    is written behind the step by rank 0 alone, and both ranks restore
    the same params, moments and step from it."""
    two = runs["two"]
    assert two["async_flat_returned"]
    (ok0, done0), (ok1, done1) = two["async_flat_by_rank"]
    assert ok0 and ok1
    assert len(done0) == 1 and done1 == []


@pytest.mark.parametrize("world", [2, 1])
def test_zero1_checkpoint_from_four_ranks_resumes(runs, world):
    want_loss = runs["four"]["modes"]["zero1"]["losses"][1]
    if world == 2:
        loss, params, step = (runs["two"]["restored_losses"][0],
                              runs["restored2"], runs["two"]["restored_step"])
    else:
        loss, params, step = (runs["one"]["losses"][0],
                              runs["one"]["params"], runs["one"]["step"])
    assert step == 2
    np.testing.assert_allclose(loss, want_loss, rtol=RESTORE_TOL,
                               atol=RESTORE_TOL)
    np.testing.assert_allclose(params, runs["after2"], rtol=RESTORE_TOL,
                               atol=RESTORE_TOL)


def _rank_nccl_zero1(rank, world, store, out_path, port):
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.backend import init_distributed
    from ray_tpu_torch.train.spmd import make_llama_train_step

    import torch.distributed as dist

    dev = init_distributed(f"127.0.0.1:{port}", world, rank)
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, generator=0, device=dev)
    tokens = np.random.default_rng(0).integers(0, 256, (4, 64),
                                               dtype=np.int32)
    losses = {}
    for name, mesh, kw in (("none", None, {}),
                           ("zero1", build_mesh(MeshSpec()),
                            {"zero1": True})):
        step, init_state, shard = make_llama_train_step(
            cfg, mesh, optimizer=optim.adamw(1e-2), attn_impl="blockwise",
            remat=False, device=dev, **kw)
        _, losses[name], _ = _run(step, init_state(params), shard, tokens,
                                  np.roll(tokens, -1, axis=1))
    with open(out_path, "w") as f:
        json.dump(losses, f)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_nccl_zero1_step_matches_mesh_none_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card only")
    from ray_tpu_torch.train.backend import free_port

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        run_ranks(_rank_nccl_zero1, 1, tmp, (out, free_port()),
                  RANK_TIMEOUT_S)
        with open(out) as f:
            losses = json.load(f)
    np.testing.assert_allclose(losses["zero1"], losses["none"], rtol=1e-6,
                               atol=1e-6)
