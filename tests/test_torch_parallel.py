"""ray_tpu_torch.parallel (mesh layouts, sharding rules, ZeRO-1 dim choice)
and collective.quant against the JAX package's, on the CPU.

Specs compare as tuples after ``normalize_spec`` on both sides (JAX's
``PartitionSpec`` is a tuple of the same entries). Rank layouts compare
against ``np.vectorize(lambda d: d.id)(mesh.devices)`` of JAX meshes over
the 8 virtual CPU devices (ids 0..7): rank r stands where device r
stands. The int8 wire format must be bit-equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu.collective import xla_backend as jax_quant
from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu_torch.collective import quant
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import mesh, sharding
from ray_tpu_torch.train import spmd


def _jspec(p) -> tuple:
    return tuple(jax_sharding.normalize_spec(p))


def _ids(m) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(m.devices)


def _layout_mesh(sizes: dict) -> DeviceMesh:
    """A DeviceMesh of these axis sizes over ranks 0..n-1 that needs no
    process group (names and sizes only)."""
    shape = [sizes.get(a, 1) for a in mesh.AXIS_ORDER]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
        shape), mesh_dim_names=mesh.AXIS_ORDER, _init_backend=False,
        _rank=0)


RULE_CASES = [
    ("default", {}, ("batch", "seq", "act_embed")),
    ("default", {}, ("embed", "mlp")),
    ("default", {}, (None, "heads")),
    ("default", {}, ("mlp", "heads")),  # tp twice: the second replicates
    ("override", {"embed": "tp"}, ("embed",)),
    ("override", {"batch": "dp"}, ("batch", "seq")),
    ("override", {"vocab": None, "embed": None}, ("vocab", "embed")),
    ("default", {}, ("layers", "embed", "kv_heads")),
]


@pytest.mark.parametrize("kind,over,axes", RULE_CASES)
def test_sharding_rules_spec_matches_jax(kind, over, axes):
    got = sharding.ShardingRules().override(**over).spec(*axes)
    want = jax_sharding.ShardingRules().override(**over).spec(*axes)
    assert sharding.normalize_spec(got) == _jspec(want)
    assert isinstance(got, tuple) and len(got) == len(axes)


@pytest.mark.parametrize("over", [{}, {"batch": "dp"}, {"batch": None},
                                  {"batch": ("fsdp", "dp")}])
def test_batch_axes_match_jax(over):
    assert sharding.batch_axes(sharding.ShardingRules().override(**over)) \
        == jax_sharding.batch_axes(
            jax_sharding.ShardingRules().override(**over))


ZERO1_CASES = [  # tests/test_parallel.py's cases, then more
    ((), (2, 128, 8, 16), ("layers", "embed", "heads", "head_dim")),
    ((), (512, 64), ("vocab", "embed")),
    (("tp",), (64, 16), None),
    ((), (3, 5), None),
    ((), (16, 64), None),
    ((None, "fsdp"), (64, 32), None),
    ((), (8,), ("embed",)),
]


@pytest.mark.parametrize("spec,shape,logical", ZERO1_CASES)
def test_zero1_spec_matches_jax(cpu_mesh_devices, spec, shape, logical):
    jm = jax_mesh.build_mesh(jax_mesh.MeshSpec(dp=2, fsdp=4),
                             cpu_mesh_devices)
    axes = ("dp", "fsdp")
    want = jax_sharding.zero1_spec(P(*spec), shape, jm, axes,
                                   logical=logical)
    for m in (_layout_mesh({"dp": 2, "fsdp": 4}), dict(jm.shape)):
        got = sharding.zero1_spec(spec, shape, m, axes, logical=logical)
        assert sharding.normalize_spec(got) == _jspec(want)


@pytest.mark.parametrize("preset", ["tiny", "llama3_8b"])
@pytest.mark.parametrize("sizes", [{"dp": 2, "fsdp": 4}, {"dp": 2, "fsdp": 2},
                                   {"dp": 8}])
def test_zero1_dims_on_llama_leaves_match_jax(cpu_mesh_devices, preset,
                                              sizes):
    """Per Llama leaf (tiny and 8B shapes, DDP rules), the dim the ZeRO-1
    update shards over is the dim JAX's zero1_shardings extends."""
    jcfg = getattr(jax_llama.LlamaConfig, preset)()
    cfg = getattr(llama.LlamaConfig, preset)()
    shapes = jax.eval_shape(lambda k: jax_llama.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    n = int(np.prod(list(sizes.values())))
    jm = jax_mesh.build_mesh(jax_mesh.MeshSpec(**sizes),
                             cpu_mesh_devices[:n])
    ddp = dict(vocab=None, embed=None, mlp=None, heads=None, kv_heads=None)
    jrules = jax_sharding.ShardingRules().override(**ddp)
    logical = jax_llama.param_logical_axes(jcfg)
    assert llama.param_logical_axes(cfg) == logical
    axes = ("dp", "fsdp")
    want = jax_sharding.zero1_shardings(
        jm, shapes, jax_sharding.tree_shardings(jm, logical, jrules), axes,
        logical_axes=logical)
    rules = sharding.ShardingRules().override(**ddp)
    got = sharding.zero1_dims(_layout_mesh(sizes), shapes,
                              sharding.tree_specs(logical, rules), axes,
                              logical_axes=logical)

    def want_dim(sh, leaf):
        spec = list(sh.spec) + [None] * (len(leaf.shape) - len(sh.spec))
        hit = [d for d, e in enumerate(spec) if e is not None]
        return hit[0] if hit else None

    flat_want = jax.tree.map(want_dim, want, shapes)
    assert got == flat_want


def test_param_logical_axes_match_jax():
    from ray_tpu.models import vit as jax_vit
    from ray_tpu_torch.models import vit

    assert vit.param_logical_axes(vit.ViTConfig.tiny()) == \
        jax_vit.param_logical_axes(jax_vit.ViTConfig.tiny())
    cfg = llama.LlamaConfig.llama3_1b()  # tied: no lm_head
    assert llama.param_logical_axes(cfg) == jax_llama.param_logical_axes(
        jax_llama.LlamaConfig.llama3_1b())


LAYOUT_SPECS = [
    dict(dp=8), dict(dp=2, fsdp=2, tp=2), dict(pp=2, dp=2, sp=2),
    dict(fsdp=4, tp=2), dict(dp=2, fsdp=2), dict(sp=2),
]


@pytest.mark.parametrize("sizes", LAYOUT_SPECS)
def test_build_mesh_layout_is_jaxs_device_order(cpu_mesh_devices, sizes):
    spec = mesh.MeshSpec(**sizes)
    want = _ids(jax_mesh.build_mesh(jax_mesh.MeshSpec(**sizes),
                                    cpu_mesh_devices))
    np.testing.assert_array_equal(mesh.mesh_layout(spec, 8), want)


HYBRID_SPECS = [
    (dict(dp=2, fsdp=4, dcn_axes=("dp",)), 2, 4),
    (dict(dp=2, fsdp=2, dcn_axes=("dp",)), 2, 2),
    (dict(dp=2, fsdp=2, tp=2, dcn_axes=("dp",)), 2, 4),
    (dict(pp=2, dp=2, fsdp=2, dcn_axes=("dp",)), 2, 4),
    (dict(dp=4, sp=2, dcn_axes=("dp",)), 4, 2),
    (dict(pp=2, dp=2, tp=2, dcn_axes=("pp", "dp")), 4, 2),
]


@pytest.mark.parametrize("sizes,slices,per_slice", HYBRID_SPECS)
def test_hybrid_mesh_layout_is_jaxs_device_order(cpu_mesh_devices, sizes,
                                                 slices, per_slice):
    want = _ids(jax_mesh.hybrid_mesh(jax_mesh.MeshSpec(**sizes), slices,
                                     per_slice, devices=cpu_mesh_devices))
    got = mesh.hybrid_layout(mesh.MeshSpec(**sizes), slices, per_slice)
    np.testing.assert_array_equal(got, want)


def test_mesh_errors_and_spec_helpers_match_jax(cpu_mesh_devices):
    with pytest.raises(ValueError, match="only 8 available"):
        mesh.mesh_layout(mesh.MeshSpec(dp=100), 8)
    with pytest.raises(ValueError):
        jax_mesh.build_mesh(jax_mesh.MeshSpec(dp=100), cpu_mesh_devices)
    for args in ((mesh.MeshSpec(dp=2, fsdp=4, dcn_axes=("dp",)), 4, 2),
                 (mesh.MeshSpec(dp=2, fsdp=4, dcn_axes=("dp",)), 2, 8)):
        with pytest.raises(ValueError, match="must equal"):
            mesh.hybrid_layout(*args)
    spec = mesh.MeshSpec(dp=2, tp=4)
    assert spec.num_devices == 8 and spec.axis_sizes()["dp"] == 2
    assert spec.with_total(16, grow="dp").dp == 4
    with pytest.raises(ValueError):
        spec.with_total(9, grow="tp")
    for chips in (1, 4, 8, 16):
        assert mesh.mesh_shape_for_slice("h100", chips) == \
            jax_mesh.mesh_shape_for_slice("v5e", chips)
    assert mesh.AXIS_ORDER == jax_mesh.AXIS_ORDER


def test_single_device_mesh_needs_no_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    m = mesh.single_device_mesh()
    assert m.mesh_dim_names == mesh.AXIS_ORDER
    assert sharding.axis_sizes(m) == {a: 1 for a in mesh.AXIS_ORDER}
    assert mesh.mesh_coords(m) == {a: 0 for a in mesh.AXIS_ORDER}
    # The step needs the groups such a mesh does not carry.
    with pytest.raises(ValueError, match="no process groups"):
        spmd.make_llama_train_step(llama.LlamaConfig.tiny(), m,
                                   device="cpu")


def _quant_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    x[0, :256] = 0.0  # a bucket of zeros (scale 1)
    x[1, 300:310] = 127.5 / 127.0  # values at a rounding tie
    return x


@pytest.mark.parametrize("bucket", [256, 64])
def test_int8_buckets_bit_equal_to_jax(bucket):
    x = _quant_inputs()
    jq, js = jax_quant.quantize_int8_buckets(jnp.asarray(x), bucket)
    q, s = quant.quantize_int8_buckets(torch.from_numpy(x), bucket)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize_int8_buckets(q, s).numpy(),
        np.asarray(jax_quant.dequantize_int8_buckets(jq, js)))
    grouped = x[:, :bucket * (1000 // bucket)].reshape(3, -1, bucket)
    jq, js = jax_quant.quantize_int8_bucketed(jnp.asarray(grouped))
    q, s = quant.quantize_int8_bucketed(torch.from_numpy(grouped))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_parallel_and_collective_import_no_jax():
    import subprocess
    import sys

    code = ("import sys; import ray_tpu_torch.parallel.mesh, "
            "ray_tpu_torch.parallel.sharding, "
            "ray_tpu_torch.collective.quant; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ray_tpu.')) or m == 'ray_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_free_port_is_bindable_and_below_the_ephemeral_range():
    """free_port draws from below the range the kernel hands ports out
    of (to connections and port-0 listeners, gloo's too), so no other
    socket is given the port before the caller binds it."""
    import socket

    from ray_tpu_torch.train import backend

    floor = backend._ephemeral_floor()
    for _ in range(20):
        port = backend.free_port()
        assert 1024 <= port < floor
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))
