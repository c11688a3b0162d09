"""CQL: conservative Q-learning, offline RL over logged transitions.

Port of ray_tpu/rl/cql.py (reference: rllib/algorithms/cql/cql.py: a
conservative regularizer on the TD loss pushes down the Q-values of
actions absent from the dataset). Discrete CQL(H):

    loss = TD_huber + alpha * mean( logsumexp_a Q(s, a) - Q(s, a_data) )

The dataset holds obs/actions/rewards/next_obs/dones columns, read as BC
reads its; a target network tracks the online net as DQN's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.bc import device_batch, greedy_return
from ray_tpu_torch.rl.dqn import _take
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.ppo import (
    clone_params,
    init_mlp,
    mlp_apply,
    params_from_jax,
    params_to_numpy,
    sgd_step,
)
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.tune.trainable import Trainable

_COLUMNS = ("obs", "actions", "rewards", "next_obs", "dones")


def cql_loss(params, target_params, batch: dict, gamma: float,
             alpha: float):
    """Huber TD (delta 1) against the target net's max, plus alpha x the
    conservative gap; returns (loss, td, gap)."""
    q = mlp_apply(params, batch["obs"])                       # [B, A]
    q_sa = _take(q, batch["actions"])
    with torch.no_grad():
        q_next = mlp_apply(target_params, batch["next_obs"]).max(-1).values
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    td = F.huber_loss(q_sa, target, delta=1.0)
    # Conservative gap: how far OOD actions sit above the data action.
    gap = (torch.logsumexp(q, -1) - q_sa).mean()
    return td + alpha * gap, td, gap


def cql_update(optimizer, params, target_params, opt_state, batch: dict,
               gamma: float, alpha: float):
    """One optimizer step; params and opt_state in place."""
    loss, td, gap = cql_loss(params, target_params, batch, gamma, alpha)
    params, opt_state = sgd_step(optimizer, params, opt_state, loss)
    return params, opt_state, td.detach(), gap.detach()


@dataclass
class CQLConfig:
    env: str = "CartPole-v1"           # spaces + optional evaluation
    dataset: Any = None                # obs/actions/rewards/next_obs/dones
    lr: float = 1e-3
    gamma: float = 0.99
    alpha: float = 1.0                 # conservative-regularizer weight
    batch_size: int = 256
    epochs_per_step: int = 1
    target_update_every: int = 32      # updates between target-net syncs
    hidden: int = 64
    evaluation_episodes: int = 0
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "CQL":
        return CQL({"cql_config": self})


class CQL(Trainable):
    """Offline conservative Q-learning (reference: cql.py)."""

    def setup(self, config: dict) -> None:
        cfg = config.get("cql_config") or CQLConfig(
            **{k: v for k, v in config.items()
               if k in CQLConfig.__dataclass_fields__})
        if cfg.dataset is None:
            raise ValueError("CQLConfig.dataset is required (offline data)")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        probe = make_env(cfg.env, seed=cfg.seed)
        self.params = init_mlp(
            torch.Generator().manual_seed(cfg.seed),
            [probe.observation_size, cfg.hidden, cfg.hidden,
             probe.num_actions], device=self.device)
        self.target_params = clone_params(self.params)
        self.optimizer = adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._updates = 0

    def step(self) -> dict:
        cfg = self.cfg
        td_sum = gap_sum = torch.zeros((), device=self.device)
        seen = 0
        for _ in range(cfg.epochs_per_step):
            for batch in cfg.dataset.iter_batches(
                    batch_size=cfg.batch_size,
                    local_shuffle_buffer_size=4 * cfg.batch_size,
                    local_shuffle_seed=cfg.seed + self.iteration):
                b = device_batch({k: batch[k] for k in _COLUMNS},
                                 self.device)
                self.params, self.opt_state, td, gap = cql_update(
                    self.optimizer, self.params, self.target_params,
                    self.opt_state, b, cfg.gamma, cfg.alpha)
                n = len(b["actions"])
                td_sum = td_sum + td * n
                gap_sum = gap_sum + gap * n
                seen += n
                self._updates += 1
                if self._updates % cfg.target_update_every == 0:
                    self.target_params = clone_params(self.params)
        td_sum, gap_sum = torch.stack([td_sum, gap_sum]).tolist()
        denom = max(seen, 1)
        out = {"td_loss": td_sum / denom,
               "conservative_gap": gap_sum / denom,
               "num_samples_trained": seen}
        if cfg.evaluation_episodes > 0:
            out["episode_return_mean"] = greedy_return(
                self.params, make_env(cfg.env, seed=cfg.seed + 10_000),
                cfg.evaluation_episodes, self.device, max_steps=1000)
        return out

    def save_checkpoint(self) -> Any:
        return {"params": params_to_numpy(self.params),
                "target_params": params_to_numpy(self.target_params),
                "updates": self._updates, "iteration": self.iteration}

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.params = params_from_jax(checkpoint["params"], self.device)
        self.target_params = clone_params(
            params_from_jax(checkpoint["target_params"], self.device))
        self._updates = checkpoint["updates"]
        self.iteration = checkpoint["iteration"]
