"""GPU resource model: card counting, visibility and assignment.

The counterpart of ray_tpu/accelerators/tpu.py's ``TpuAcceleratorManager``
for CUDA cards. A node's ``"GPU"`` resource is the number of cards it
sees: ``CUDA_VISIBLE_DEVICES`` where it is set (an empty value is none),
else the cards ``nvidia-smi --list-gpus`` lists, else none. Nothing here
imports torch or touches CUDA: a node daemon counts cards without making
a CUDA context.

A worker leased ``n`` cards is started with ``CUDA_VISIBLE_DEVICES``
naming those first and the node's other cards after them, and with
``RTPU_LEASED_GPUS`` naming its own (``set_visible_accelerator_ids``):
``cuda:0`` .. ``cuda:n-1`` are its cards, so a task that asks for
``"cuda"`` lands on its own card, while NCCL still sees the others and
reaches them directly (as Ray Train shares a node's cards among its
ranks). A worker leased none sees none (an empty
``CUDA_VISIBLE_DEVICES``), so it never makes a CUDA context at all.
``leased_cards()`` is what a rank's device choice reads.
"""

from __future__ import annotations

import os
import shutil
import subprocess

GPU_RESOURCE = "GPU"
VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
LEASED_ENV = "RTPU_LEASED_GPUS"


def leased_cards() -> int | None:
    """How many cards this process's lease holds (the first it sees), or
    None outside a cluster worker that holds cards."""
    ids = os.environ.get(LEASED_ENV)
    if not ids:
        return None
    return len([c for c in ids.split(",") if c])


class GpuAcceleratorManager:
    def __init__(self, env: dict | None = None):
        self._env = env if env is not None else os.environ

    def visible_ids(self) -> list[str]:
        """The card ids this process may hand out, in order."""
        visible = self._env.get(VISIBLE_DEVICES_ENV)
        if visible is not None:
            return [c.strip() for c in visible.split(",") if c.strip()]
        smi = shutil.which("nvidia-smi")
        if smi is None:
            return []
        try:
            out = subprocess.run([smi, "--list-gpus"], capture_output=True,
                                 text=True, timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            return []
        return [str(i) for i, line in enumerate(out.splitlines())
                if line.startswith("GPU ")]

    def get_current_node_num_accelerators(self) -> int:
        return len(self.visible_ids())

    def get_current_node_resources(self) -> dict[str, float]:
        n = self.get_current_node_num_accelerators()
        return {GPU_RESOURCE: float(n)} if n else {}

    def get_current_node_labels(self) -> dict[str, str]:
        n = self.get_current_node_num_accelerators()
        return {"rtpu.io/gpu-count": str(n)} if n else {}

    @staticmethod
    def set_visible_accelerator_ids(ids: list[str], node_ids: list[str] = ()
                                    ) -> dict[str, str]:
        """Env of a worker that holds the cards ``ids`` of a node with
        the cards ``node_ids`` (holding none, it sees none)."""
        if not ids:
            return {VISIBLE_DEVICES_ENV: "", LEASED_ENV: ""}
        order = list(ids) + [g for g in node_ids if g not in ids]
        return {VISIBLE_DEVICES_ENV: ",".join(order),
                LEASED_ENV: ",".join(ids)}
