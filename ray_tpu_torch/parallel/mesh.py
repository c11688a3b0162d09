"""Device meshes over ``torch.distributed`` ranks.

Port of ray_tpu/parallel/mesh.py. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the six named axes of
:data:`AXIS_ORDER` (size-1 axes included), whose rank tensor stands where
JAX's ``mesh.devices`` stands: rank r is device r.

- ``build_mesh``: ranks laid out row-major in ``AXIS_ORDER``;
- ``hybrid_mesh``: the dcn axes outermost (slice-major), then transposed
  back to ``AXIS_ORDER``, so each slice's ranks stay contiguous;
- ``mesh_layout``/``hybrid_layout``: those rank layouts as numpy arrays,
  pure functions that need no process group; ``tp_mesh``: one rank's
  place on a tp-only mesh without one (tensor-parallel serving).

Building a ``DeviceMesh`` creates one process group per axis, once (with
NCCL a communicator comes up at a group's first collective, so a size-1
axis the step never reduces over costs none). ``single_device_mesh()``
builds a one-rank mesh with no process group at all.

Axis names: dp (data parallel), fsdp (fully-sharded data parallel), tp
(tensor parallel), sp (sequence/context parallel), ep (expert parallel),
pp (pipeline parallel).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")  # outermost first


@dataclass(frozen=True)
class MeshSpec:
    """Named parallelism degrees; unspecified axes are 1. ``dcn_axes``
    names the axes that cross slice boundaries, laid out outermost."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    dcn_axes: tuple[str, ...] = ()

    def axis_sizes(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes().values())

    def with_total(self, n_devices: int, grow: str = "dp") -> "MeshSpec":
        """Scale the ``grow`` axis so the mesh covers ``n_devices``."""
        fixed = self.num_devices // getattr(self, grow)
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed degree {fixed}")
        return MeshSpec(**{**self._asdict(), grow: n_devices // fixed})

    def _asdict(self) -> dict:
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                "sp": self.sp, "ep": self.ep, "pp": self.pp,
                "dcn_axes": self.dcn_axes}


def mesh_layout(spec: MeshSpec, n_ranks: int | None = None) -> np.ndarray:
    """``build_mesh``'s rank layout: ranks 0..n-1 row-major over
    ``AXIS_ORDER``. ``n_ranks`` (the ranks available) must cover it."""
    sizes = spec.axis_sizes()
    n = math.prod(sizes.values())
    if n_ranks is not None and n > n_ranks:
        raise ValueError(
            f"mesh needs {n} devices, only {n_ranks} available")
    return np.arange(n).reshape(*sizes.values())


def hybrid_layout(spec: MeshSpec, num_slices: int,
                  devices_per_slice: int) -> np.ndarray:
    """``hybrid_mesh``'s rank layout: slice-major (the dcn axes outermost,
    then the ici axes, each in ``AXIS_ORDER``), transposed back to
    ``AXIS_ORDER``."""
    sizes = spec.axis_sizes()
    dcn_degree = math.prod(sizes[a] for a in spec.dcn_axes) \
        if spec.dcn_axes else 1
    if dcn_degree != num_slices:
        raise ValueError(
            f"product of dcn_axes degrees ({dcn_degree}) must equal "
            f"num_slices ({num_slices})")
    ici_degree = math.prod(v for a, v in sizes.items()
                           if a not in spec.dcn_axes)
    if ici_degree != devices_per_slice:
        raise ValueError(
            f"ICI axes product ({ici_degree}) must equal devices_per_slice "
            f"({devices_per_slice})")
    dcn = [a for a in AXIS_ORDER if a in spec.dcn_axes]
    ici = [a for a in AXIS_ORDER if a not in spec.dcn_axes]
    arr = np.arange(num_slices * devices_per_slice).reshape(
        *[sizes[a] for a in dcn], *[sizes[a] for a in ici])
    perm = [(dcn + ici).index(a) for a in AXIS_ORDER]
    return arr.transpose(perm).reshape(*[sizes[a] for a in AXIS_ORDER])


def _device_mesh(layout: np.ndarray):
    """A DeviceMesh of ``layout``'s ranks on the default group's device
    type: "cuda" under NCCL, "cpu" under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call "
            "ray_tpu_torch.train.backend.init_distributed first")
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      torch.as_tensor(layout, dtype=torch.int),
                      mesh_dim_names=AXIS_ORDER)


def build_mesh(spec: MeshSpec):
    """The named mesh over the default process group's ranks, row-major
    in ``AXIS_ORDER`` (JAX's ``build_mesh`` over devices 0..n-1).
    Collective over the world: every rank calls it, in the same order."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return _device_mesh(mesh_layout(spec, world))


def single_device_mesh():
    """A one-rank mesh (every axis 1) that needs no process group; it
    names the axes and their sizes (``zero1_spec``, the rule table) but
    carries no group for a collective."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.zeros((1,) * len(AXIS_ORDER),
                                         dtype=torch.int),
                      mesh_dim_names=AXIS_ORDER, _init_backend=False,
                      _rank=0)


def mesh_shape_for_slice(accelerator_type: str,
                         num_chips: int) -> dict[str, int]:
    """A default (dp x fsdp) split for a slice: fsdp within a host's four
    chips, dp across."""
    if num_chips <= 4:
        return {"fsdp": num_chips}
    return {"dp": num_chips // 4, "fsdp": 4}


def hybrid_mesh(spec: MeshSpec, num_slices: int, devices_per_slice: int):
    """Multi-slice mesh: the dcn axes span slices, the ici axes stay inside
    a slice (JAX's ``hybrid_mesh``'s device order, see
    :func:`hybrid_layout`)."""
    return _device_mesh(hybrid_layout(spec, num_slices, devices_per_slice))


def tp_mesh(tp: int, rank: int) -> tuple[dict[str, int], dict[str, int]]:
    """(axis sizes, ``rank``'s coordinates) of ``build_mesh(MeshSpec(dp=1,
    fsdp=1, tp=tp))``, the pair ``shard_params`` takes in place of a
    ``DeviceMesh``: a tensor-parallel serving engine's ranks form no mesh
    of the default group."""
    spec = MeshSpec(tp=tp)
    hit = np.argwhere(mesh_layout(spec) == rank)
    if not len(hit):
        raise ValueError(f"rank {rank} is not in a tp={tp} mesh")
    return spec.axis_sizes(), dict(zip(AXIS_ORDER, (int(i) for i in hit[0])))


def mesh_coords(mesh, rank: int | None = None) -> dict[str, int] | None:
    """``rank``'s coordinate on each named axis (default: this process's
    rank), or None when the rank is not in the mesh."""
    if rank is None:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
    hit = np.argwhere(mesh.mesh.cpu().numpy() == rank)
    if not len(hit):
        return None
    return dict(zip(mesh.mesh_dim_names, (int(i) for i in hit[0])))
