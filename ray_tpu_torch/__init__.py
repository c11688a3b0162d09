"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` that imports ``torch`` and nothing of JAX or
of ``ray_tpu``. Ported so far: the LLM serving engine (``ray_tpu_torch.llm``)
and prefix hashing (``serve.prefix``); the training steps (``train``:
``make_train_step`` and its Llama, ViT and Mixtral factories on one card
or over a mesh of ranks with data parallelism, ZeRO-1, FSDP/TP and
expert parallelism; the optimizers ``adamw``, ``adamw_lowmem``, ``sgd``,
``adam``; process-group bring-up; checkpoints); the GPipe pipeline and
the mesh and sharding rules (``parallel``); the Llama, ViT and Mixtral
models with remat and context parallelism (``models``); ops (``ops``: the
CUDA RMSNorm, flash-attention forward/backward and ring-step chunk
kernels, ring attention over a ``torch.distributed`` group, RoPE, the
fused cross-entropy); the int8 gradient format (``collective``); the RL
library (``rl``: batched torch envs, PPO with the fused Anakin loop, DQN,
SAC, IMPALA, APPO, the offline BC, MARWIL and CQL, multi-agent PPO,
Dreamer) on the ``Trainable`` of ``tune``; Ray Data on the runtime
(``data``: the lazy plan, the streaming executor and its actor pools,
shuffles, datasources, ``streaming_split`` and batch LLM inference;
``TorchTrainer(datasets=)`` reads through it); peak rates for MFU
(``accelerators``); the head-packing profiler and paired timings
(``devbench``); the in-process runtime (``init``, ``remote``, ``get``,
``put``, ``wait``, actors: ``core``), the host collective (``collective``),
the trainer on it (``train.TorchTrainer``) and the metrics API
(``util.metrics``).
Importing the package is cheap: it starts no thread (``init`` starts the
runtime's), and CUDA kernels are built from ``csrc/`` at their first
launch.
"""

from ray_tpu_torch.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.core.events import timeline
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import remote
from ray_tpu_torch.core.worker import get_runtime_context

__version__ = "0.1.0"

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "timeline",
    "ObjectRef",
    "RayTpuError",
    "TaskError",
    "TaskCancelledError",
    "ActorDiedError",
    "ActorUnavailableError",
    "ObjectLostError",
    "OutOfMemoryError",
    "GetTimeoutError",
    "__version__",
]
