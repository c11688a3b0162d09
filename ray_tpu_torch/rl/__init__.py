"""ray_tpu_torch.rl: the RL library on PyTorch (port of ray_tpu.rl).

Numpy envs, connectors and replay buffers on the host (copies of the JAX
package's), an inline EnvRunner feeding learners on a card, batched torch
envs (``vec_env``) and the fused Anakin loop for ``PPOConfig(
vectorized=True)``, over ranks of a process group too; PPO, DQN, SAC,
IMPALA and APPO; the offline BC, MARWIL and CQL over any dataset with
``iter_batches`` (``ray_tpu_torch.data``); multi-agent PPO with shared or
independent policies; the Dreamer world model; all as Trainables
(``ray_tpu_torch.tune``). Every config takes ``device="cuda"`` by
default and raises without a card. What needs the actor runtime, which
the port does not have yet, raises ``NotImplementedError``: Sebulba,
runner actors (``num_env_runners > 0``, multi-agent PPO's too) and
IMPALA's asynchronous runners.
"""

from ray_tpu_torch.rl.anakin import AnakinPPO
from ray_tpu_torch.rl.appo import APPO, APPOConfig
from ray_tpu_torch.rl.bc import BC, BCConfig
from ray_tpu_torch.rl.connectors import (
    ClipActions,
    ClipObservations,
    Connector,
    ConnectorPipeline,
    FrameStack,
    NormalizeObservations,
    UnsquashActions,
)
from ray_tpu_torch.rl.cql import CQL, CQLConfig
from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.dreamer import Dreamer, DreamerConfig
from ray_tpu_torch.rl.env import (
    CartPoleEnv,
    PendulumEnv,
    VectorEnv,
    make_env,
    register_env,
)
from ray_tpu_torch.rl.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rl.impala import IMPALA, ImpalaConfig
from ray_tpu_torch.rl.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rl.multi_agent import (
    ChaseGame,
    CoordinationGame,
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rl.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.replay import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rl.sac import SAC, SACConfig
from ray_tpu_torch.rl.vec_env import (
    AutoResetWrapper,
    VecCartPole,
    VecCatch,
    VecGridWorld,
    is_vec_env,
    make_vec_env,
    register_vec_env,
)

__all__ = [
    "CartPoleEnv", "PendulumEnv", "VectorEnv", "make_env", "register_env",
    "EnvRunner", "EnvRunnerGroup",
    "AutoResetWrapper", "VecCartPole", "VecCatch", "VecGridWorld",
    "is_vec_env", "make_vec_env", "register_vec_env",
    "AnakinPPO", "PPO", "PPOConfig",
    "DQN", "DQNConfig", "SAC", "SACConfig",
    "IMPALA", "ImpalaConfig", "APPO", "APPOConfig",
    "Connector", "ConnectorPipeline", "NormalizeObservations",
    "FrameStack", "ClipObservations", "ClipActions", "UnsquashActions",
    "ReplayBuffer", "PrioritizedReplayBuffer",
    "BC", "BCConfig", "MARWIL", "MARWILConfig", "CQL", "CQLConfig",
    "MultiAgentEnv", "MultiAgentEnvRunner", "CoordinationGame", "ChaseGame",
    "MultiAgentPPO", "MultiAgentPPOConfig",
    "Dreamer", "DreamerConfig",
]
